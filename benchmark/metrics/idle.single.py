"""Idle share of the device over the traced slice, in cells whose every call
ends in a synchronize: 1 - (union of the device operations' intervals) /
(the slice's wall time). Moves call_p95_ms."""

UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["traffic"]["sync_each_call"] or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
