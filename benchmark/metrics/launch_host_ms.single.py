"""The host's time a kernel launch takes: the mean duration of the
`launch.*` spans (each kernel wrapper from entry to return) over the traced
slice, in cells whose every call ends in a synchronize. Read from the
program's spans (`benchmark/spans.py`); nothing where the program has none.
Moves call_p95_ms."""

from benchmark import spans

UNIT = "ms"


def read(ctx):
    if not ctx["traffic"]["sync_each_call"]:
        return None
    calls = spans.slice_calls(ctx)
    if calls is None:
        return None
    calls = [spans.split(c) for c in calls]
    launches = sum(c.launches for c in calls)
    if not launches:
        return None
    spans.note(ctx, "launch_host_ms.single", calls)
    return sum(c.launch_ns for c in calls) / launches / 1e6
