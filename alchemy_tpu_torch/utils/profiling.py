"""Tracing/profiling utilities — port of `alchemy_tpu/utils/profiling.py`,
and the program's spans.

- `phase`: the wall-clock harness (`timed`, which `examples/common.py`
  re-exports);
- `trace`: a `torch.profiler` context (CPU and, where there is a card,
  CUDA activities) writing a trace TensorBoard reads;
- `cost_table`: the per-op static cost table of a (compiled) expression,
  op counts keyed by (op, modulus-chain annotation), derived from the IR.
  Data volumes are not estimated here;
- `span`, `tracing`, `spans`, `reset`: spans at the layer boundaries of the
  entry ops (`she.fast.mul_relin`, `she.hybrid.mul_relin_hybrid`,
  `she.hybrid.rescale_joint`, `she.fast.rescale`), the squaring chain
  (`examples.deep_circuit.square_chain` and its levels) and the kernel
  wrappers (`launch.<kernel>`, which `backend/cuda/launch.py` opens and
  counts), kept in memory.

A span records its name, its start and end (`time.time_ns()`, Unix-epoch
ns: the clock in which `torch.profiler` reports host and device events, so
spans and a device trace share one timeline), the index of its parent span,
the index of its call's root span, whether its block raised, and attributes
its site gives. Spans are recorded inside `tracing()` and whenever a
`torch.profiler` session is active; otherwise `span` costs one flag check
and returns a shared no-op context. While a profiler is active each span
also opens a profiler range of its name, so that a trace that records CPU
activity (`trace`) shows the spans around the operations they launched.
The buffer keeps the newest `LIMIT` spans; nothing is written while a
call runs. Spans nest by the order in
which they open and close: record them from one thread.

Importing this module imports nothing of the port, so every module of it
may import this one.
"""

from __future__ import annotations

import itertools
import time
from collections import Counter, deque
from contextlib import contextmanager
from typing import TYPE_CHECKING

import torch
import torch.autograd.profiler as _autograd_profiler

if TYPE_CHECKING:
    from alchemy_tpu_torch.lang.ir import Node

#: spans the buffer keeps, the newest (read by `reset`)
LIMIT = 1 << 16

#: the profiler range each span opens while a profiler is active: a
#: `record_function` range at a fraction of its cost, recorded where the
#: profiler records CPU activity
_Range = torch._C._profiler._RecordFunctionFast


@contextmanager
def timed(label: str, verbose: bool = True):
    """Wall-clock phase timing (Common.hs:99-127 prints 'Wall time: %0.3fs')."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if verbose:
        print(f"{label}Wall time: {dt:0.3f}s\n")


phase = timed


@contextmanager
def trace(logdir: str):
    """torch.profiler over the block, its trace written under `logdir` by
    `tensorboard_trace_handler` (view with TensorBoard's profiler plugin);
    yields the profiler. The block's spans are in the trace as ranges."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def cost_table(expr: Node) -> list[tuple[str, int]]:
    """[(op-with-annotation, count)] over the expression, in descending
    count order. For compiled expressions the annotation carries the
    modulus chain each op runs at."""
    from alchemy_tpu_torch.lang.ir import App, Lam, Prim

    counts: Counter = Counter()

    def walk(node: Node):
        if isinstance(node, Lam):
            walk(node.body)
        elif isinstance(node, App):
            walk(node.f)
            walk(node.a)
        elif isinstance(node, Prim):
            key = node.name
            if node.ann and "zq" in node.ann:
                key = f"{node.name} @ {node.ann['zq']}"
            counts[key] += 1

    walk(expr)
    return counts.most_common()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

_buffer: deque = deque(maxlen=LIMIT)
_open: list = []                 # the spans open now, innermost last
_next_index = itertools.count().__next__
_forced = 0                      # depth of `tracing()` blocks


class Span:
    """One span: `index` (its place in the sequence of recorded spans),
    `name`, `start_ns`, `end_ns` (None while open), `parent` (the index of
    the span it opened in, None for a root), `call` (the index of its root:
    shared by every span of one entry call), `error` (its block raised) and
    `attrs`."""

    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "call", "error", "attrs",
                 "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.end_ns, self.error = None, False

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        self.start_ns = time.time_ns()
        parent = _open[-1] if _open else None
        self.index = _next_index()
        self.parent = None if parent is None else parent.index
        self.call = self.index if parent is None else parent.call
        _open.append(self)
        _buffer.append(self)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.error = exc_type is not None
        _open.pop()
        self.end_ns = time.time_ns()
        return False

    def __repr__(self) -> str:
        return (f"Span({self.index}, {self.name!r}, parent={self.parent}, call={self.call}, "
                f"start_ns={self.start_ns}, end_ns={self.end_ns}, error={self.error}, "
                f"attrs={self.attrs})")


class _Off:
    """The shared context of a span that is not recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A span over the `with` block it opens, as the block's target (None
    when spans are not being recorded)."""
    if _forced or _autograd_profiler._is_profiler_enabled:
        return Span(name, attrs)
    return _OFF


@contextmanager
def tracing():
    """Record spans inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def spans() -> list[Span]:
    """The recorded spans, oldest first (each in the order it opened)."""
    return list(_buffer)


def reset() -> None:
    """Drop every recorded span; the buffer keeps the newest `LIMIT` from
    now on."""
    global _buffer, _next_index
    _buffer = deque(maxlen=LIMIT)
    _next_index = itertools.count().__next__
