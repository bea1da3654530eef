"""The entry's own host time a call: the median over the traced slice's
calls of the root span's duration less the call's `glue.*` and `launch.*`
spans (the entry's Python, `kernel_hint`, reshapes, and `rescale_joint`'s
own work), in cells whose every call ends in a synchronize. Read from the
program's spans (`benchmark/spans.py`); nothing where the program has none.
Moves call_p95_ms."""

import statistics

from benchmark import spans

UNIT = "ms"


def read(ctx):
    if not ctx["traffic"]["sync_each_call"]:
        return None
    calls = spans.slice_calls(ctx)
    if calls is None:
        return None
    calls = [spans.split(c) for c in calls]
    spans.note(ctx, "entry_self_ms.single", calls)
    return statistics.median(c.self_ns for c in calls) / 1e6
