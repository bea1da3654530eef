"""The program's spans on the card, beyond what a traced run reads:

    python -m benchmark.span_profile --workload <cell> --seed <n> --seconds <s> [--calls <k>]

One cell in one process: set-up and warm-up as `benchmark.run`; then four
windows of --seconds with no profiler, spans off, on (`tracing()`), on, off,
each with the host's time a call (median, entry → return) and the call's
95th percentile where calls are synchronized; what one empty span costs off
and on; the split of the on windows' calls into root, glue, launches and the
entry's self time; then a slice of --calls calls under a profile of CUDA
activity alone, as the traced run takes it, with the spans on the same
clock: the device's idle time by the span the host was in, the same split,
and the smallest margin from a launch span's start to its kernel's start.
Prints one JSON line. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import spans, trace
from benchmark.run import load_cell, log, window


def _window(call, traffic, seconds: float, seed: int, sync) -> dict:
    win = window(call, traffic, seconds, seed, sync)
    out = {"calls": win["calls"], "host_ms_median": statistics.median(win["host_s"]) * 1e3}
    if win["latency_s"]:
        out["call_p95_ms"] = float(np.percentile(win["latency_s"], 95)) * 1e3
    return out


def _span_cost_ns(profiling, count: int = 200_000) -> dict:
    """ns a loop iteration takes around an empty launch-like span, off and
    under `tracing()`, and the empty loop's own."""
    def loop(body: bool) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(count):
            if body:
                with profiling.span("launch.x", entry="x"):
                    pass
        return (time.perf_counter_ns() - t0) / count

    empty, off = loop(False), loop(True)
    with profiling.tracing():
        on = loop(True)
    profiling.reset()
    return {"empty_loop": empty, "off": off, "on": on}


def _split(entry: str, recorded: list) -> dict:
    """Medians (ms) of root, glue, launches and self time over the finished
    calls of `entry` among the recorded spans, and launch spans a call."""
    calls: dict[int, list] = {}
    for s in recorded:
        if s.end_ns is not None and (s.parent is not None or s.name == entry):
            calls.setdefault(s.call, []).append(s)
    split = [spans.split(c) for c in calls.values() if c[0].parent is None]
    if not split:
        return {}
    med = {k: statistics.median(getattr(c, k) for c in split) / 1e6
           for k in ("root_ns", "glue_ns", "launch_ns", "self_ns")}
    return {"calls": len(split), **{k.replace("_ns", "_ms_median"): v for k, v in med.items()},
            "launch_spans_per_call": sum(c.launches for c in split) / len(split)}


def _launch_margins(ops: list, recorded: list) -> dict:
    """Launch spans and port kernels by C entry, and where their counts
    agree the least, median and largest start of the k-th device operation
    of a kernel less the start of the k-th launch span naming its entry
    (µs)."""
    by_entry: dict[str, list] = {}
    for s in recorded:
        if s.name.startswith("launch."):
            by_entry.setdefault(s.attrs["entry"], []).append(s.start_ns)
    kernels: dict[str, list] = {}
    for name, s0, _ in ops:
        cls, port = trace.label(name)
        if port:
            kernels.setdefault(cls, []).append(s0)
    out = {"spans": {k: len(v) for k, v in by_entry.items()},
           "kernels": {k: len(v) for k, v in kernels.items()}}
    if out["spans"] == out["kernels"] and kernels:
        margins = [k0 - s0 for e in kernels for s0, k0 in zip(by_entry[e], kernels[e])]
        out.update(min_us=min(margins) / 1e3, median_us=statistics.median(margins) / 1e3,
                   max_us=max(margins) / 1e3)
    return out


def profile(cell: str, seed: int, seconds: float, calls: int, device: str = "cuda") -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from alchemy_tpu_torch.utils import profiling

    _, cfg, traffic = load_cell(cell)
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    system_mod = importlib.import_module(f"benchmark.systems.{cfg['system']}")
    system = system_mod.System(cfg, traffic, seed, dev)
    for k in range(traffic["warmup_calls"]):
        system.call(k)
    sync()
    entry = spans.ENTRY[cfg["key_switching"]]
    card = trace.card_info() if dev.type == "cuda" else None
    out = {"workload": cell, "seed": seed, "card": card, "windows": [],
           "span_cost_ns": _span_cost_ns(profiling)}
    on_split = []
    for on in (False, True, True, False):
        profiling.reset()
        with profiling.tracing() if on else contextlib.nullcontext():
            out["windows"].append({"spans": on, **_window(system.call, traffic, seconds, seed,
                                                          sync)})
        if on:
            on_split.append(_split(entry, profiling.spans()))
    out["on_window_split"] = on_split
    activities = [ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU]
    with torch_profile(activities=activities):
        system.call(0)
        sync()
    profiling.reset()
    with torch_profile(activities=activities) as prof:
        sync()
        t0 = time.time_ns()
        for k in range(calls):
            system.call(k)
            if traffic["sync_each_call"]:
                sync()
        sync()
        t1 = time.time_ns()
    ops, recorded = trace._device_events(prof), profiling.spans()
    summary = trace.summarize(ops, (t1 - t0) * 1e-9, calls)
    idle = spans.idle_by_span(ops, recorded, t0, t1)
    out["slice"] = {"calls": calls, "window_s": summary["window_s"], "busy_s": summary["busy_s"],
                    "ops_per_call": summary["ops"] / calls, "split": _split(entry, recorded),
                    "idle_s_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
                    "launch_margins": _launch_margins(ops, recorded)}
    system.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    print(json.dumps(profile(args.workload, args.seed, args.seconds, args.calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
