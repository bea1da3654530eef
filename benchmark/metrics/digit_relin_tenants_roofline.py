"""Kernel B's tenant-indexed form's share of its roofline, in multi-tenant
cells (configurations with `tenants`) whose calls are not synchronized one
by one: the least time the card could take for one launch at the cell's
shape and the traced calls' mean count of distinct tenants (the `tenants`
attribute of their `mul_relin` root spans; `roofline_tenants.py`, at the
card's maximum SM clock) over the mean device time of the
`digit_relin_tenants_kernel` launches in the traced slice. Nothing where the
program has no such kernel or span. Moves ct_mul_per_s."""

import re
import statistics

from benchmark import roofline, roofline_tenants, spans

UNIT = "%"
KERNEL = re.compile(r"\bdigit_relin_tenants_kernel\b")


def read(ctx):
    tr, cfg, traffic = ctx["trace"], ctx["cfg"], ctx["traffic"]
    if (tr is None or ctx["card"] is None or not cfg.get("tenants")
            or traffic["sync_each_call"]):
        return None
    ops = [v for label, v in tr["by_label"].items() if KERNEL.search(label)]
    launches = sum(v["count"] for v in ops)
    calls = spans.slice_calls(ctx)
    if not launches or calls is None or any("tenants" not in c[0].attrs for c in calls):
        return None
    tenants = statistics.mean(c[0].attrs["tenants"] for c in calls)
    nbytes, muls = roofline_tenants.digit_relin_tenants_cost(
        traffic["batch"], len(cfg["qs"]), cfg["n"], cfg["shoup_hints"], tenants)
    bound_ms, by = roofline.bound(nbytes, muls, ctx["card"]["clock_max_mhz"] * 1e6)
    ms = sum(v["seconds"] for v in ops) / launches * 1e3
    ctx["notes"]["digit_relin_tenants_roofline"] = {
        "bound_ms": bound_ms, "bound_by": by, "ms": ms, "launches": launches,
        "tenants_mean": tenants, "calls": len(calls), **ctx["card"]}
    return 100.0 * bound_ms / ms
