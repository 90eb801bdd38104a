"""Per-stage device micro-profile of the sampled engine (library form).

The port's counterpart of the JAX package's runtime/obs/stage_profile.py.
Where the sampling wall-clock profiler (runtime/obs/profiler.py) answers
"where does wall time go across a whole run", this module answers "how
long does each engine stage of one ref take on the device": key decode,
geometry, next-use solve (best_sink), classify, the pair reduction
(ops/histogram.py::sorted_k_unique, the port's counterpart of the JAX
fixed_k_unique), the device draw (sampler/draw.py on kernel B3 and its
sorts) and the whole ref's dispatch through kernel B1 (in the place of
the JAX scan kernel). Each stage is timed as a device-synced telemetry
span (`Span.block` under `enable(device_sync=True)`, which waits for the
card; wall alone would time only the launches). On the CPU the draw and
B1 stages run their plain versions.

`tools/profile_stages.py` is the CLI wrapper around `profile_stages()`.
Pass `profile_hz` to run the sampling profiler over the same stage reps
and get its snapshot alongside the stage medians.
"""

from __future__ import annotations

import time


def profile_stages(n: int = 512, model: str = "gemm", ref: int = 0,
                   reps: int = 5, telemetry_out: str | None = None,
                   profile_hz: float | None = None,
                   out=print, device=None) -> dict:
    """Time each sampled-engine stage on `device` (CUDA unless the CPU is
    asked for); returns `{"device": ..., "batch": ..., "stage_ms":
    {stage: median_ms}, "profile": snapshot-or-None}` (plus model, n,
    ref), the JAX result's keys and stage names, and prints a human
    summary via `out` (pass `out=lambda *a: None` to silence)."""
    import numpy as np
    import torch

    from ...config import MachineConfig, SamplerConfig
    from ...core.trace import ProgramTrace
    from ...models import REGISTRY
    from ...ops.histogram import sorted_k_unique
    from ...ops.sampled_hist import torch_vals
    from ...sampler.sampled import (
        _best_sink,
        _sample_geometry,
        _sample_highs,
        classify_samples,
        decode_sample_keys,
        default_batch,
        resolve_device,
    )
    from .. import telemetry
    from . import profiler as obs_profiler

    dev = resolve_device(device)
    out(f"device: {dev}"
        + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
           else ""))
    # device_sync=True: each stage span's .block() records the
    # span-start -> device-complete latency as sync_s, which is what a
    # stage profile must report
    tele = telemetry.enable(device_sync=True)
    prof = (obs_profiler.enable(hz=profile_hz)
            if profile_hz else None)
    stage_ms: dict = {}

    def sync(value):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return value

    def med_time(name, fn, *fn_args, n_reps=reps):
        """Median device-synced seconds of `n_reps` span-wrapped calls
        (one warm call first so the kernels' builds and first launches
        stay out of the reps; the builds still land in the telemetry
        run's build counters)."""
        sync(fn(*fn_args))
        for _ in range(n_reps):
            with telemetry.span(name, stage=True) as sp:
                sp.block(fn(*fn_args))
        ts = sorted(
            s.sync_s for s in tele.find_spans(name)
            if s.sync_s is not None
        )[-n_reps:]
        med = ts[len(ts) // 2]
        stage_ms[name] = round(med * 1e3, 3)
        return med

    machine = MachineConfig()
    prog = REGISTRY[model](n)
    trace = ProgramTrace(prog, machine)
    nt = trace.nests[0]
    tnt = nt.with_vals(torch_vals(nt.vals, dev))
    cfg = SamplerConfig(ratio=0.1, seed=0)
    highs, _ = _sample_highs(nt, ref, cfg)
    batch = default_batch(dev)
    rng = np.random.default_rng(0)
    space = int(np.prod(highs))
    keys = torch.from_numpy(
        rng.integers(0, space, size=batch, dtype=np.int64)).to(dev)
    out(f"batch={batch} highs={highs}")

    result = {
        "device": "gpu" if dev.type == "cuda" else dev.type,
        "model": model,
        "n": n,
        "ref": ref,
        "batch": batch,
        "stage_ms": stage_ms,
        "profile": None,
    }

    def dec(k):
        return decode_sample_keys(k, tuple(highs))

    t = med_time("decode", dec, keys)
    out(f"decode:          {t * 1e3:9.2f} ms")

    samples = dec(keys)

    def geo(s):
        return _sample_geometry(tnt, ref, s)

    t = med_time("geometry", geo, samples)
    out(f"geometry:        {t * 1e3:9.2f} ms")

    tid, p0, line, m0 = geo(samples)

    def sink(a, b, c, d):
        return _best_sink(tnt, ref, a, b, c, d)

    t = med_time("best_sink", sink, tid, p0, line, m0)
    out(f"best_sink:       {t * 1e3:9.2f} ms")

    def cls(s):
        return classify_samples(tnt, ref, s)

    t = med_time("classify", cls, samples)
    out(f"classify (all):  {t * 1e3:9.2f} ms")

    packed, _, _, found = cls(samples)
    w = torch.arange(batch, device=dev) < (batch - 7)

    def uniq(v, m):
        return sorted_k_unique(v, m, 64)

    t = med_time("fixed_k_unique", uniq, packed, found & w)
    out(f"fixed_k_unique:  {t * 1e3:9.2f} ms  (sorted_k_unique)")

    # The engine's two dispatches per ref: the device draw (threefry on
    # kernel B3, the sorts and the thinning) and the whole buffer's
    # classify through kernel B1 (its plain versions on the CPU).
    from ...ops.sampled_hist import (
        build_descriptor,
        device_descriptor,
        tri_table,
    )
    from ...sampler.draw import draw_sample_keys_device
    from ...sampler.sampled import (
        _FUSED_HOST_CHUNKS,
        _pad_highs,
        bucket_dispatch,
    )

    cfg_draw = SamplerConfig(ratio=0.1, seed=0, device_draw=True)
    t0 = time.perf_counter()
    drawn = draw_sample_keys_device(nt, ref, cfg_draw, 0, batch, dev)
    t_cold = time.perf_counter() - t0
    if drawn is None:
        out("device draw:     declined (over budget / empty space)")
        _finish(result, tele, prof, telemetry_out, out)
        return result
    dk, dm, s, dhighs = drawn
    for r in range(1, reps + 1):
        with telemetry.span("device_draw", stage=True) as sp:
            sp.block(draw_sample_keys_device(
                nt, ref, cfg_draw, r, batch, dev
            )[0])
    ts = sorted(
        sp.sync_s for sp in tele.find_spans("device_draw")
        if sp.sync_s is not None
    )
    med = ts[len(ts) // 2]
    stage_ms["device_draw"] = round(med * 1e3, 3)
    out(f"device draw:     {med * 1e3:9.2f} ms  "
        f"(cold {t_cold:.1f} s; B={dk.shape[0]}, s={s})")

    kernel = dev.type == "cuda"
    desc = build_descriptor(nt, ref) if kernel else None
    tri = tri_table(nt, dev) if kernel else None
    desc_dev = device_descriptor(desc, dev)
    rx = torch.tensor([ref], dtype=torch.int64, device=dev)
    ph = _pad_highs(dhighs)

    B = dk.shape[0]
    span = min(B, _FUSED_HOST_CHUNKS * batch)

    def dispatch():
        # the engine's column spans of the drawn buffer (views)
        return [bucket_dispatch(nt, ref, dk[None, lo:lo + span],
                                dm[None, lo:lo + span], ph, rx, 64, "auto",
                                desc, tri, desc_dev=desc_dev)[0]
                for lo in range(0, B, span)]

    t = med_time("scan_kernel", dispatch, n_reps=min(3, reps))
    out(f"B1 dispatch:     {t * 1e3:9.2f} ms  (the ref's {B} lanes in "
        f"{-(-B // span)} dispatch(es), scan_kernel)")
    _finish(result, tele, prof, telemetry_out, out)
    return result


def _finish(result: dict, tele, prof, telemetry_out, out) -> None:
    from .. import telemetry
    from . import profiler as obs_profiler

    if prof is not None:
        obs_profiler.disable()
        result["profile"] = prof.snapshot()
    telemetry.disable()
    tele.print_summary()
    if telemetry_out:
        tele.write_json(telemetry_out)
        out(f"telemetry JSON -> {telemetry_out}")
