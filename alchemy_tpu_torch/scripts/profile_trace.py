"""Device time by kernel over a steady window — port of
`scripts/profile_trace.py` on `torch.profiler` (CUPTI).

Library use:

    from alchemy_tpu_torch.scripts.profile_trace import device_profile, profile_step
    events = profile_step(step, args, iters=20)
    # events: [(kernel name, total µs, count)] sorted by time, descending
    prof = device_profile(step, args, iters=20)
    # also the busy µs (the union of the kernels' intervals), the span µs
    # from the first kernel's start to the last one's end, the idle share
    # 1 − busy/span and the launch count, over the whole traced window

Divide by `iters` for a step's share. The step should be warmed (and its
graph captured) by the caller. With device="cpu" the same is taken over the
CPU's top-level ops (no card time). CLI: profiles the north-star op,
`fast.mul_relin` at PROF_LOG_N (15), PROF_NLIMB (8), PROF_BATCH (16) as one
CUDA graph, over PROF_ITERS (20) replays, in the "pallas" order, and prints
the table of the JAX script, then one JSON record with `backend` and
`card`:

    python -m alchemy_tpu_torch.scripts.profile_trace [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def busy_us(spans) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_profile(step, args=(), iters: int = 20, device: str = "cuda",
                   tdir: str | None = None) -> dict:
    """Run `step(*args)` iters times under torch.profiler and aggregate the
    card's kernels (device="cpu": the CPU's top-level ops):
    {"events": [(name, total_us, count)] by time descending, "busy_us",
    "span_us", "idle_share", "launches"} over the whole window, and
    "host_us", the host clock from the first call to the synchronize after
    the last. With `tdir` the chrome trace is written there too. Raises
    when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step(*args)
        if cuda:
            torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) * 1e6
    if tdir is not None:
        os.makedirs(tdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(tdir, "trace.json"))
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    evs = [e for e in prof.events()
           if e.device_type == kind and (cuda or e.cpu_parent is None)]
    if not evs:
        raise RuntimeError("the profiler saw no device time")
    spans = [(e.time_range.start, e.time_range.end) for e in evs]
    agg: dict[str, list] = {}
    for e in evs:
        rec = agg.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.end - e.time_range.start
        rec[1] += 1
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = busy_us(spans)
    return {"events": sorted(((k, t, c) for k, (t, c) in agg.items()), key=lambda e: -e[1]),
            "busy_us": busy, "span_us": span, "idle_share": 1 - busy / span if span else 0.0,
            "launches": len(evs), "host_us": host_us}


def profile_step(step, args=(), iters: int = 20, tdir: str | None = None,
                 device: str = "cuda"):
    """[(kernel name, total_us, count)] of `iters` calls of step(*args),
    sorted by time descending (the JAX script's `profile_step`)."""
    return device_profile(step, args, iters, device, tdir)["events"]


def print_events(events, iters: int, top: int = 25, file=None):
    total = sum(t for _, t, _ in events)
    print(f"{'per-step us':>12} {'count':>6} {'%':>6}  op", file=file)
    for name, tot, cnt in events[:top]:
        print(f"{tot/iters:12.1f} {cnt:6d} {100*tot/total:6.1f}  {name[:90]}", file=file)
    print(f"{total/iters:12.1f} {'':6} {'':6}  TOTAL device", file=file)


def main(device: str | None = None, argv=None) -> int:
    from alchemy_tpu_torch.bench import backend, bench_inputs, card, compiled_step, run_args
    from alchemy_tpu_torch.she.fast import FastParams

    device = run_args("alchemy_tpu_torch.scripts.profile_trace", device, argv).device
    log_n = int(os.environ.get("PROF_LOG_N", "15"))
    nlimb = int(os.environ.get("PROF_NLIMB", "8"))
    batch = int(os.environ.get("PROF_BATCH", "16"))
    iters = int(os.environ.get("PROF_ITERS", "20"))
    p = FastParams.make(log_n, nlimb, zp=2, impl="pallas" if device == "cuda" else "vpu")
    inp = bench_inputs(p, np.random.default_rng(0), "trivgad", device, batch)
    step, out = compiled_step(lambda o: inp["mul"](inp["ct1"], o), inp["ct2"])
    prof = device_profile(step, (out,), iters, device)
    print_events(prof["events"], iters)
    print(json.dumps({"log_n": log_n, "nlimb": nlimb, "batch": batch, "iters": iters,
                      "impl": p.impl, **prof, "backend": backend(device), "card": card(device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(argv=sys.argv[1:]))
