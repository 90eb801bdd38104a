"""Exhaustive audit of the analytic exact engine's fit structure.

The port's twin of the JAX package's tools/verify_analytic.py. The
analytic engine (sampler/analytic.py) rests on one residual
assumption: per-period histograms are piecewise affine with deviation
locations that are either enumerated or caught by a probe. This tool
removes the assumption for a concrete (program, machine): it classifies
every point of every period of every ref and compares against the
engine's fitted per-period evaluation. Both classify through the
engine's own `_RawClassify`: kernel B1's raw form on the card, its
plain version with `--device cpu`.

    python -m pluss_sampler_optimization_torch.tools.verify_analytic \\
        --model syrk --n 256
    python -m pluss_sampler_optimization_torch.tools.verify_analytic \\
        --model syrk-tri --n 200 --machine 3,5 --device cpu

Exits 0 and prints PASS when every period matches exactly; prints the
first mismatching (nest, ref, period) and exits 1 otherwise. Cost is
O(trace) classify — use sizes where that is affordable (N <= ~512).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="syrk")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--machine", default="4,4",
                    help="thread_num,chunk_size")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: kernel B1's raw form) or cpu "
                    "(its plain version)")
    args = ap.parse_args(argv)

    import numpy as np

    import pluss_sampler_optimization_torch.sampler.analytic as A
    from pluss_sampler_optimization_torch import MachineConfig
    from pluss_sampler_optimization_torch.models import REGISTRY
    from pluss_sampler_optimization_torch.runtime.hist import PRIState
    from pluss_sampler_optimization_torch.sampler.sampled import (
        _program_rows,
        resolve_device,
    )

    dev = resolve_device(args.device)
    tn, cs = (int(x) for x in args.machine.split(","))
    machine = MachineConfig(thread_num=tn, chunk_size=cs)
    prog = REGISTRY[args.model](args.n)
    trace, _ = _program_rows(prog, machine)
    batch = 1 << 16
    G = 16  # periods per dispatch block, like the engine's swept path
    bad = 0
    checked = 0
    brute_state = PRIState(machine.thread_num)
    for k, nt in enumerate(trace.nests):
        sched = nt.schedule
        tid_of = np.asarray(
            sched.owner_tid(np.arange(sched.trip, dtype=np.int64))
        )
        for ri in range(nt.tables.n_refs):
            kern = A._RawClassify(nt, ri, "auto", [dev])
            for b0 in range(0, sched.trip, G):
                blk = list(range(b0, min(b0 + G, sched.trip)))
                fitted = A._eval_periods_block(nt, kern, ri, blk, batch)
                # brute grids for the whole block in one classify
                grids, spans = [], []
                for n0 in blk:
                    t1, t2, box, highs = A._box_geometry(nt, ri, n0)
                    if box == 0:
                        spans.append((n0, 0, None))
                        continue
                    stride = highs[2]
                    grids.append((
                        n0 * highs[1] * highs[2]
                        + np.arange(t1, dtype=np.int64)[:, None] * stride
                        + np.arange(t2, dtype=np.int64)[None, :]
                    ).ravel())
                    spans.append((n0, box, highs))
                if grids:
                    # the radix is canonical (n0-invariant) per ref
                    canon = A._box_geometry(nt, ri, blk[0])[3]
                    packed, found = A._classify_keys(
                        nt, kern, ri, np.concatenate(grids), canon, batch
                    )
                off = 0
                for n0, box, _h in spans:
                    if box == 0:
                        continue
                    brute = A._slots_of(
                        packed[off : off + box], found[off : off + box]
                    )
                    off += box
                    checked += 1
                    # fold the brute result into an all-direct PRIState:
                    # comparing run_analytic's final state against this
                    # audits the v0-level class fits too, not just the
                    # per-period row fits
                    tid = int(tid_of[n0])
                    for kk, cc in brute[0].items():
                        A._fold(brute_state, tid, kk, float(cc))
                    if brute[1]:
                        A._fold(brute_state, tid, A._COLD_KEY,
                                float(brute[1]))
                    if fitted[n0] != brute:
                        bad += 1
                        print(
                            f"MISMATCH {args.model} nest {k} ref {ri} "
                            f"period n0={n0}"
                        )
                        fs, fc = fitted[n0]
                        bs, bc = brute
                        for kk in sorted(set(fs) | set(bs)):
                            if fs.get(kk) != bs.get(kk):
                                print(
                                    f"  slot {kk}: fitted {fs.get(kk)} "
                                    f"brute {bs.get(kk)}"
                                )
                        if fc != bc:
                            print(f"  cold: fitted {fc} brute {bc}")
                        if bad >= 3:
                            print("... stopping after 3 mismatches")
                            return 1
    if bad:
        return 1
    # end-to-end: the production entry point (v0-level class fits
    # included) must equal the all-periods-direct fold above.
    # host_cutoff=0 forces the fit machinery — the audit exists to
    # exercise it; the default host-lexsort shortcut for small nests
    # is the oracle's own code and needs no audit
    eng = A.run_analytic(prog, machine, batch=batch, host_cutoff=0,
                         device=dev)

    def dump(s):
        return (
            [sorted(h.items()) for h in s.noshare],
            [sorted((kk, sorted(v.items())) for kk, v in h.items())
             for h in s.share],
        )

    if dump(eng.state) != dump(brute_state):
        print(
            "MISMATCH: run_analytic's final state != all-periods-direct "
            "fold (a v0-level class fit emitted a wrong model)"
        )
        return 1
    print(
        f"PASS: {args.model} N={args.n} machine {tn}x{cs} — "
        f"{checked} (ref, period) evaluations match brute force, and "
        "run_analytic's final state (class fits included) equals the "
        "all-periods-direct fold"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
