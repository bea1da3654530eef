"""Kernel B's share of its roofline, in cells of CRT-gadget key switching
whose calls are not synchronized one by one: the least time the card could
take for one launch at the cell's shape (`roofline.digit_relin_cost`, at the
card's maximum SM clock) over the mean device time of its launches in the
traced slice. Moves ct_mul_per_s."""

from benchmark import roofline

UNIT = "%"


def read(ctx):
    tr, cfg, traffic = ctx["trace"], ctx["cfg"], ctx["traffic"]
    if (tr is None or ctx["card"] is None or cfg.get("key_switching") != "trivgad"
            or traffic["sync_each_call"] or not tr["durations"].get("digit_relin")):
        return None
    d = tr["durations"]["digit_relin"]
    nbytes, muls = roofline.digit_relin_cost(traffic["batch"], len(cfg["qs"]), cfg["n"],
                                             cfg["shoup_hints"])
    bound_ms, by = roofline.bound(nbytes, muls, ctx["card"]["clock_max_mhz"] * 1e6)
    ms = sum(d) / len(d) * 1e3
    ctx["notes"]["digit_relin_roofline"] = {"bound_ms": bound_ms, "bound_by": by, "ms": ms,
                                            "launches": len(d), **ctx["card"]}
    return 100.0 * bound_ms / ms
