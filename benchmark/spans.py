"""The program's spans in a `--trace 1` run: the calls of the cell's entry
in the traced slice, read from the port's span buffer
(`alchemy_tpu_torch.utils.profiling`), which records while the slice's
profiler is active. Each call is split into its root span's duration, the
summed durations of its `glue.*` spans and of its `launch.*` spans, and the
entry's self time, the rest. A program without spans gives nothing.

Also `idle_by_span`: a slice's device idle time split by the span the host
was in, from the spans and the device operations on one clock (Unix-epoch
ns)."""

from __future__ import annotations

import statistics
from typing import NamedTuple

#: the root span of each kind of key switching's entry
ENTRY = {"trivgad": "mul_relin", "hybrid": "mul_relin_hybrid"}


class Call(NamedTuple):
    """One entry call's durations (ns) and its number of launch spans."""

    root_ns: int
    glue_ns: int
    launch_ns: int
    launches: int

    @property
    def self_ns(self) -> int:
        """The entry's own time: root − glue − launches."""
        return self.root_ns - self.glue_ns - self.launch_ns


def split(call: list) -> Call:
    """A call's spans, root first → its `Call`."""
    glue = [s.duration_ns for s in call[1:] if s.name.startswith("glue.")]
    launch = [s.duration_ns for s in call[1:] if s.name.startswith("launch.")]
    return Call(call[0].duration_ns, sum(glue), sum(launch), len(launch))


def _buffer() -> list | None:
    """The program's recorded spans, or None where the program has none."""
    from alchemy_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def slice_calls(ctx: dict) -> list[list] | None:
    """The spans of each of the traced slice's calls, root first: the last
    ctx["trace"]["calls"] finished root spans of the cell's entry at the
    cell's batch, L and n, each with the spans of its call. None without a
    trace, for an unknown entry, or where the buffer holds fewer such roots."""
    tr, cfg, traffic = ctx["trace"], ctx["cfg"], ctx["traffic"]
    entry = ENTRY.get(cfg.get("key_switching"))
    if tr is None or entry is None or tr["calls"] <= 0:
        return None
    buf = _buffer()
    if buf is None:
        return None
    shape = {"batch": traffic["batch"], "L": len(cfg["qs"]), "n": cfg["n"]}
    roots = [s for s in buf if s.parent is None and s.name == entry and s.end_ns is not None
             and all(s.attrs.get(k) == v for k, v in shape.items())]
    if len(roots) < tr["calls"]:
        return None
    calls = {r.index: [r] for r in roots[-tr["calls"]:]}
    for s in buf:
        if s.parent is not None and s.call in calls:
            calls[s.call].append(s)
    return list(calls.values())


def note(ctx: dict, metric: str, calls: list[Call]) -> None:
    """The reader's note: the calls read, their root spans' median (ms) and
    launch spans a call."""
    ctx["notes"][metric] = {"calls": len(calls),
                            "root_ms_median": statistics.median(c.root_ns for c in calls) / 1e6,
                            "launch_spans_per_call": sum(c.launches for c in calls) / len(calls)}


def glue_ms(ctx: dict, metric: str) -> float | None:
    """The median over the slice's calls of the summed `glue.*` span
    durations of a call (ms), in cells of hybrid key switching; noted under
    `metric`."""
    if ctx["cfg"].get("key_switching") != "hybrid":
        return None
    calls = slice_calls(ctx)
    if calls is None:
        return None
    calls = [split(c) for c in calls]
    note(ctx, metric, calls)
    return statistics.median(c.glue_ns for c in calls) / 1e6


def idle_by_span(ops: list[tuple[str, int, int]], spans: list, t0: int, t1: int) -> dict:
    """Device idle time (s) in [t0, t1] (ns) split by the innermost span
    the host was in ("outside" where it was in none): `ops` the device
    operations (name, start, end), `spans` the recorded spans, which nest."""
    busy: list[list[int]] = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, t0), min(e, t1)
        if s >= e:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    idle, at = [], t0
    for s, e in busy:
        if s > at:
            idle.append((at, s))
        at = max(at, e)
    if at < t1:
        idle.append((at, t1))
    # the host's timeline: (from, to, innermost span's name)
    events = sorted([(s.start_ns, 1, s.index, s) for s in spans if s.end_ns is not None]
                    + [(s.end_ns, 0, -s.index, s) for s in spans if s.end_ns is not None],
                    key=lambda ev: ev[:3])
    host, stack, at = [], [], t0
    for t, starts, _, s in events:
        if t > at:
            host.append((at, t, stack[-1].name if stack else "outside"))
            at = t
        if starts:
            stack.append(s)
        else:
            stack.remove(s)
    host.append((at, max(at, t1), "outside"))
    out: dict[str, float] = {}
    i = 0
    for a, b in idle:
        while i < len(host) and host[i][1] <= a:
            i += 1
        j = i
        while j < len(host) and host[j][0] < b:
            lo, hi = max(a, host[j][0]), min(b, host[j][1])
            if hi > lo:
                out[host[j][2]] = out.get(host[j][2], 0.0) + (hi - lo) * 1e-9
            j += 1
    return out
