"""Share of the device's busy time spent in operations that are neither the
port's kernels nor `garner_pack_kernel`: the torch ops of the one-limb
rescales (`she.fast.rescale`) and whatever else the chain launches outside
the port's kernels, in chain cells. Read from the traced slice's device
operations by label. Moves call_p95_ms."""

from benchmark import trace

UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or "depth" not in ctx["cfg"] or tr["busy_s"] <= 0:
        return None
    other = sum(v["seconds"] for label, v in tr["by_label"].items()
                if label not in trace.PORT_KERNELS and label != "garner_pack_kernel")
    return 100.0 * other / tr["busy_s"]
