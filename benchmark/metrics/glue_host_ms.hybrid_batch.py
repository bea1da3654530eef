"""`glue_host_ms.hybrid` in cells of hybrid key switching whose calls are
not synchronized one by one: the median over the traced slice's calls of
the summed durations of the call's `glue.*` spans, which there include the
host's waits on a full launch queue. Read from the program's spans
(`benchmark/spans.py`); nothing where the program has none. Moves
ct_mul_per_s."""

from benchmark import spans

UNIT = "ms"


def read(ctx):
    if ctx["traffic"]["sync_each_call"]:
        return None
    return spans.glue_ms(ctx, "glue_host_ms.hybrid_batch")
