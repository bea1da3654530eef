"""The host's time in the hybrid glue a call: the median over the traced
slice's calls of the summed durations of the call's `glue.*` spans
(`glue.garner_pack`, `glue.rescale_digits`, `glue.add_back`: the Garner
digits, sign terms and final additions in plain torch), in cells of hybrid
key switching whose every call ends in a synchronize. Read from the
program's spans (`benchmark/spans.py`); nothing where the program has none.
Moves call_p95_ms."""

from benchmark import spans

UNIT = "ms"


def read(ctx):
    if not ctx["traffic"]["sync_each_call"]:
        return None
    return spans.glue_ms(ctx, "glue_host_ms.hybrid")
