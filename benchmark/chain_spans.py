"""The program's spans of a chain cell's `--trace 1` run: the calls of the
chain entry (`examples.deep_circuit.square_chain`) in the traced slice, read
from the port's span buffer as `spans.py` reads the single-product entries.
A program without the chain's spans gives nothing."""

from __future__ import annotations

from benchmark import spans

#: the chain entry's root span
ROOT = "square_chain"


def slice_calls(ctx: dict) -> list[list] | None:
    """The spans of each of the traced slice's chains, root first: the last
    ctx["trace"]["calls"] finished `square_chain` roots at the cell's batch,
    top L, depth and n, each with the spans of its call. None without a
    trace, in a configuration with no depth, or where the buffer holds
    fewer such roots."""
    tr, cfg, traffic = ctx["trace"], ctx["cfg"], ctx["traffic"]
    if tr is None or "depth" not in cfg or tr["calls"] <= 0:
        return None
    buf = spans._buffer()
    if buf is None:
        return None
    shape = {"batch": traffic["batch"], "L": len(cfg["qs"]), "depth": cfg["depth"],
             "n": cfg["n"]}
    roots = [s for s in buf if s.parent is None and s.name == ROOT and s.end_ns is not None
             and all(s.attrs.get(k) == v for k, v in shape.items())]
    if len(roots) < tr["calls"]:
        return None
    calls = {r.index: [r] for r in roots[-tr["calls"]:]}
    for s in buf:
        if s.parent is not None and s.call in calls:
            calls[s.call].append(s)
    return list(calls.values())


def summed_ns(call: list, name: str) -> int:
    """The summed durations of a call's spans named `name`."""
    return sum(s.duration_ns for s in call[1:] if s.name == name)
