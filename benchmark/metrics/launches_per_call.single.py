"""Device operations (kernels, copies and sets) the profiler records per
call over the traced slice, in cells whose every call ends in a
synchronize: the port's kernels and its glue's torch ops. Moves
call_p95_ms."""

UNIT = "count"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["traffic"]["sync_each_call"] or not tr["ops"]:
        return None
    return tr["ops"] / tr["calls"]
