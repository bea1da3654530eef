"""Idle share of the device over the traced slice, in cells whose calls are
not synchronized one by one: 1 - (union of the device operations'
intervals) / (the slice's wall time). Moves ct_mul_per_s."""

UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["traffic"]["sync_each_call"] or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
