"""Share of the device's busy time spent in operations that are not the
port's own kernels (the hybrid glue's torch ops: Garner digits, sign terms,
the final additions), in cells of hybrid key switching whose calls are not
synchronized one by one. Moves ct_mul_per_s."""

UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if (tr is None or ctx["cfg"].get("key_switching") != "hybrid"
            or ctx["traffic"]["sync_each_call"] or tr["busy_s"] <= 0):
        return None
    return 100.0 * tr["glue_s"] / tr["busy_s"]
