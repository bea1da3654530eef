"""The compiled program's own host time a call: the median over the traced
slice's calls of the `jit_call` span less its `jit.replay` child (the
argument checks, the copies into the graph's inputs, the output clones), in
configurations of the general path. Read from the program's spans
(`benchmark/jit_spans.py`); nothing where the program has none. Moves
call_p95_ms."""

import statistics

from benchmark import jit_spans

UNIT = "ms"


def read(ctx):
    calls = jit_spans.slice_calls(ctx)
    if calls is None:
        return None
    root = [c[0].duration_ns for c in calls]
    replay = [sum(s.duration_ns for s in c[1:] if s.name == "jit.replay") for c in calls]
    ctx["notes"]["jit_host_ms.rlwr"] = {
        "calls": len(calls), "root_ms_median": statistics.median(root) / 1e6,
        "replay_ms_median": statistics.median(replay) / 1e6,
        "graph": all(c[0].attrs.get("graph") for c in calls),
        "prims": calls[-1][0].attrs.get("prims")}
    return statistics.median(r - p for r, p in zip(root, replay)) / 1e6
