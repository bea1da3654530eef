"""The host's time in a call: the benchmark's own span from entering the
port's entry to its return, before the synchronize, as the median over the
window's calls, in cells whose every call ends in a synchronize. Moves
call_p95_ms."""

import statistics

UNIT = "ms"


def read(ctx):
    host = ctx["window"]["host_s"]
    if not ctx["traffic"]["sync_each_call"] or not host:
        return None
    return statistics.median(host) * 1e3
