"""Where a general-path call's time goes, by prim and by kernel class:

    python -m benchmark.jit_profile --seed <n> [--workload homomrlwr.call] [--calls 5]
        [--replays 50]

The cell's system built from the seed. Then `--calls` eager runs of its
prepared program (`JitCompiled.program` through `interp.eval.eval_ir`, on
the card, no graph) under `torch.profiler` with CUDA activity alone, with
the evaluator's `ir.<prim>` spans on the same clock: each device operation
is counted to the `ir.*` span that started last at or before it (the eager
host runs far behind the card, so that span launched it; `device_idle` says
how far behind), by prim kind (tunnel_, keySwitchQuad_, mul_, modSwitch_,
the rest) and kernel class (`jit_spans.kernel_class`); host time by prim
kind from the spans. Then `--replays` calls of the cell (one graph replay
each, a synchronize after each) under the same profiler: device time a call
by kernel class and the operations that took most. Prints one JSON line.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time

import torch

#: the prim kinds reported on their own; every other prim is "rest"
KINDS = ("tunnel_", "keySwitchQuad_", "mul_", "modSwitch_")


def by_prim(ops: list, prim_spans: list, calls: int) -> dict:
    """Device ms a call by prim kind and kernel class: each operation
    (name, start ns, end ns) to the prim span (name `ir.<prim>`, start_ns)
    that started last at or before it."""
    from benchmark import jit_spans, trace

    starts = [s.start_ns for s in prim_spans]
    out: dict[str, dict[str, float]] = {}
    for name, s, e in ops:
        i = bisect.bisect_right(starts, s) - 1
        prim = prim_spans[i].name[3:] if i >= 0 else "before"
        kind = prim if prim in KINDS or prim == "before" else "rest"
        cls = jit_spans.kernel_class(trace.label(name)[0])
        row = out.setdefault(kind, {})
        row[cls] = row.get(cls, 0.0) + (e - s) * 1e-6 / calls
    return out


def main(argv=None) -> int:
    from torch.profiler import ProfilerActivity, profile

    from alchemy_tpu_torch.interp.eval import eval_ir
    from alchemy_tpu_torch.utils import profiling
    from benchmark import jit_spans, trace
    from benchmark.run import load_cell
    from benchmark.systems.homomrlwr_jit import System

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="homomrlwr.call")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--replays", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _, cfg, traffic = load_cell(args.workload)
    dev = torch.device("cuda")
    system = System(cfg, traffic, args.seed, dev)
    program, arg = system.program.program, system.pool[0]
    for k in range(2):
        system.call(k)
        eval_ir(program, arg)
    torch.cuda.synchronize(dev)

    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        e0 = time.time_ns()
        for _ in range(args.calls):
            eval_ir(program, arg)
            torch.cuda.synchronize(dev)
        e1 = time.time_ns()
    ops = trace._device_events(prof)
    prim_spans = sorted((s for s in profiling.spans() if s.name.startswith("ir.")),
                        key=lambda s: s.start_ns)
    host: dict[str, float] = {}
    for s in prim_spans:
        kind = s.name[3:] if s.name[3:] in KINDS else "rest"
        host[kind] = host.get(kind, 0.0) + s.duration_ns * 1e-6 / args.calls
    eager = trace.summarize(ops, (e1 - e0) * 1e-9, args.calls)
    device = by_prim(ops, prim_spans, args.calls)

    with profile(activities=[ProfilerActivity.CUDA]):
        system.call(0)
        torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        r0 = time.perf_counter()
        for k in range(args.replays):
            system.call(k)
            torch.cuda.synchronize(dev)
        window = time.perf_counter() - r0
    replay = trace.summarize(trace._device_events(prof), window, args.replays)
    classes: dict[str, float] = {}
    for label, v in replay["by_label"].items():
        cls = jit_spans.kernel_class(label)
        classes[cls] = classes.get(cls, 0.0) + v["seconds"] * 1e3 / args.replays
    top = sorted(replay["by_label"].items(), key=lambda kv: -kv[1]["seconds"])[:12]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "card": trace.card_info(),
        "prims": dict(system.program.prims),
        "eager": {"calls": args.calls, "ms_per_call": (e1 - e0) * 1e-6 / args.calls,
                  "device_busy_ms": eager["busy_s"] * 1e3 / args.calls,
                  "device_idle": 1 - eager["busy_s"] / eager["window_s"],
                  "ops_per_call": eager["ops"] / args.calls,
                  "prim_spans_per_call": len(prim_spans) / args.calls,
                  "host_ms_by_prim": host, "device_ms_by_prim": device},
        "replay": {"calls": args.replays, "ms_per_call": window * 1e3 / args.replays,
                   "device_busy_ms": replay["busy_s"] * 1e3 / args.replays,
                   "ops_per_call": replay["ops"] / args.replays,
                   "device_ms_by_class": classes,
                   "top": [[k, v["seconds"] * 1e3 / args.replays, v["count"] / args.replays]
                           for k, v in top]}}), flush=True)
    system.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
