"""Progressive-precision gate: the four properties of the adaptive

The port's twin of the JAX package's tools/check_precision.py: the same
command line and output, on the port's modules.
Every run takes --device (default cuda);
the one-shot run of gate 1 takes the host draw, the progressive
engine's stream.
sampled engine (sampler/sampled.py::run_sampled_progressive +
sampler/confidence.py), pinned per seed with an exit code.

For each seed in --seeds, against a small model matrix:

1. PREFIX BIT-IDENTITY — a full-schedule progressive run's final MRC
   (and its per-ref sample counts and histograms) is bit-identical to
   the one-shot sampled engine at the same ratio: the rounds are
   prefix-extensions of one threefry stream whose union IS the
   one-shot draw.
2. MONOTONE BANDS — the streamed confidence-band widths never widen
   round over round.
3. DEADLINE MID-ROUND — with a seeded hang fault on round 1 and a
   deadline that expires during it, the service returns exactly ONE
   partial_final whose band equals the last streamed partial's band,
   carrying a `precision:band=<w>@round=<r>` degrade hop (and the
   result is never cached).
4. EXACT REPLAY — a second identical run (same seed, same fault spec)
   reproduces the same (outcome, round count, band, mrc_digest)
   tuple.

Exercised from tier-1 via tests/test_torch_service.py, the
check_chaos twin's pattern.

    python -m pluss_sampler_optimization_torch.tools.check_precision [--seeds 0,1] [--models gemm,mvt]
        [--n 32] [--ratio 0.3]
"""

from __future__ import annotations

import argparse
import io
import json
import sys

# the hang must dwarf the deadline, and the deadline must comfortably
# cover round 0 on a loaded CI box — the round count is then a pure
# function of (fault spec, deadline), never of machine speed
DEADLINE_S = 1.0
HANG_S = 3.0


def _fault_config(seed: int):
    from pluss_sampler_optimization_torch.config import FaultConfig

    return FaultConfig(seed=seed, rules=(
        {"site": "round_exec", "kind": "hang", "hang_s": HANG_S,
         "match": {"round": 1}, "p": 1.0, "max_fires": 1},
    ))


def check_prefix_identity(model: str, n: int, ratio: float,
                          seed: int, problems: list,
                          device="cuda") -> None:
    """Gate 1 + 2: full-schedule progressive == one-shot, bit for
    bit, with monotone non-widening streamed bands."""
    import numpy as np

    from pluss_sampler_optimization_torch.config import (
        MachineConfig, SamplerConfig,
    )
    from pluss_sampler_optimization_torch.models import build
    from pluss_sampler_optimization_torch.runtime.aet import aet_mrc
    from pluss_sampler_optimization_torch.runtime.cri import (
        cri_distribute,
    )
    from pluss_sampler_optimization_torch.sampler.sampled import (
        run_sampled, run_sampled_progressive,
    )

    program = build(model, n)
    machine = MachineConfig()
    T = machine.thread_num
    # the host draw: the progressive engine's stream on every device
    cfg = SamplerConfig(ratio=ratio, seed=seed, device_draw=False)
    bands: list = []

    def on_round(info):
        bands.append(info["band_width"])

    state_p, results_p, info = run_sampled_progressive(
        program, machine, cfg, on_round=on_round, device=device
    )
    # the raw route: the progressive rounds keep raw noshare keys, as
    # the JAX package's xla results do
    state_o, results_o = run_sampled(program, machine, cfg, device=device,
                                     raw_noshare=True)
    mrc_p = aet_mrc(cri_distribute(state_p, T, T), machine)
    mrc_o = aet_mrc(cri_distribute(state_o, T, T), machine)
    tag = f"seed={seed} {model} n={n}"
    if not (len(mrc_p) == len(mrc_o)
            and np.array_equal(mrc_p, mrc_o)):
        problems.append(f"{tag}: progressive MRC != one-shot MRC")
    for rp, ro in zip(results_p, results_o):
        if rp.n_samples != ro.n_samples:
            problems.append(
                f"{tag}: ref {rp.name} samples "
                f"{rp.n_samples} != {ro.n_samples}"
            )
        if rp.noshare != ro.noshare or rp.share != ro.share:
            problems.append(
                f"{tag}: ref {rp.name} histograms differ"
            )
    if not info["converged"]:
        problems.append(f"{tag}: full schedule not marked converged")
    for a, b in zip(bands, bands[1:]):
        if b > a:
            problems.append(
                f"{tag}: band widened {a:.6f} -> {b:.6f}"
            )


def _run_deadline(model: str, n: int, ratio: float, seed: int,
                  device="cuda"):
    """One serve_jsonl run under the seeded round-1 hang: returns
    (partials, final, cache_stats)."""
    from pluss_sampler_optimization_torch.runtime import faults
    from pluss_sampler_optimization_torch.service.api import (
        AnalysisService, serve_jsonl,
    )

    faults.install(_fault_config(seed))
    try:
        svc = AnalysisService(cache_dir=None, device=device)
        line = json.dumps({
            "id": "dl", "model": model, "n": n, "engine": "sampled",
            "ratio": ratio, "seed": seed, "tolerance": 0.0,
            "max_rounds": 3, "deadline_s": DEADLINE_S,
        })
        fout = io.StringIO()
        serve_jsonl(svc, io.StringIO(line + "\n"), fout)
        stats = svc.stats()
        svc.close()
    finally:
        faults.uninstall()
    docs = [json.loads(ln) for ln in fout.getvalue().splitlines()]
    partials = [d for d in docs if d.get("partial")]
    finals = [d for d in docs if not d.get("partial")]
    return partials, finals, stats


def check_deadline(model: str, n: int, ratio: float, seed: int,
                   problems: list, device="cuda") -> None:
    """Gate 3 + 4: deadline mid-round -> exactly one partial_final
    with the last streamed band, replayable exactly."""
    tag = f"seed={seed} {model} n={n} deadline"
    partials, finals, stats = _run_deadline(model, n, ratio, seed, device)
    if len(finals) != 1:
        problems.append(f"{tag}: {len(finals)} final responses")
        return
    final = finals[0]
    pfs = [d for d in ([final] if final.get("partial_final") else [])]
    if len(pfs) != 1:
        problems.append(f"{tag}: expected exactly one partial_final, "
                        f"got ok={final.get('ok')} "
                        f"rounds={final.get('rounds')} "
                        f"error={final.get('error')}")
        return
    if final.get("converged"):
        problems.append(f"{tag}: partial_final marked converged")
    if not partials:
        problems.append(f"{tag}: no partial frames streamed")
    elif final.get("band_width") > partials[-1]["band_width"]:
        problems.append(
            f"{tag}: final band {final['band_width']:.6f} wider than "
            f"last streamed {partials[-1]['band_width']:.6f}"
        )
    hops = final.get("degraded") or []
    if not any(str(h.get("reason", "")).startswith("precision:")
               for h in hops):
        problems.append(f"{tag}: no precision:* degrade hop ({hops})")
    cache = (stats.get("cache") or {})
    stored = (cache.get("mem_entries") or 0) + (
        cache.get("disk_entries") or 0
    )
    if stored:
        problems.append(
            f"{tag}: partial_final was cached ({stored} entries)"
        )
    # gate 4: exact replay of (outcome, rounds, band, digest)
    partials2, finals2, _stats2 = _run_deadline(model, n, ratio, seed,
                                                device)
    key = ("partial_final", final.get("rounds"),
           final.get("band_width"), final.get("mrc_digest"),
           len(partials))
    final2 = finals2[0] if finals2 else {}
    key2 = ("partial_final" if final2.get("partial_final")
            else "other", final2.get("rounds"),
            final2.get("band_width"), final2.get("mrc_digest"),
            len(partials2))
    if key != key2:
        problems.append(f"{tag}: replay diverged {key} != {key2}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="progressive-precision determinism gate"
    )
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--models", default="gemm,mvt")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--ratio", type=float, default=0.3)
    ap.add_argument("--skip-deadline", action="store_true",
                    help="engine-level gates only (no service spin-up)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    problems: list = []
    seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    models = [m.strip() for m in args.models.split(",") if m.strip()]
    for seed in seeds:
        for model in models:
            check_prefix_identity(model, args.n, args.ratio, seed,
                                  problems, args.device)
        # the deadline/replay gates exercise the full service path;
        # one model per seed keeps the gate under a minute on CPU
        if not args.skip_deadline:
            check_deadline(models[0], args.n, args.ratio, seed,
                           problems, args.device)
    if problems:
        for p in problems:
            print(f"FAIL: {p}", file=sys.stderr)
        print(f"check_precision: {len(problems)} problem(s)",
              file=sys.stderr)
        return 1
    print(
        f"check_precision: ok ({len(seeds)} seed(s) x "
        f"{len(models)} model(s), deadline gate "
        f"{'skipped' if args.skip_deadline else 'on'})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
