"""The host's time in the one-limb rescales' torch ops a chain: the median
over the traced slice's chains of the summed durations of a chain's
`glue.rescale` spans (`she.fast.rescale`'s division between its two
transforms, once a level), in chain cells. Read from the program's spans
(`benchmark/chain_spans.py`); nothing where the program has none. Moves
call_p95_ms."""

import statistics

from benchmark import chain_spans

UNIT = "ms"


def read(ctx):
    calls = chain_spans.slice_calls(ctx)
    if calls is None:
        return None
    glue = [chain_spans.summed_ns(c, "glue.rescale") for c in calls]
    root = [c[0].duration_ns for c in calls]
    ctx["notes"]["rescale_glue_ms.chain"] = {
        "calls": len(calls), "root_ms_median": statistics.median(root) / 1e6,
        "rescale_spans_per_call": sum(sum(s.name == "rescale" for s in c) for c in calls)
        / len(calls)}
    return statistics.median(glue) / 1e6
