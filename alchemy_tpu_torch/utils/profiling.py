"""Tracing/profiling utilities — port of `alchemy_tpu/utils/profiling.py`.

- `phase`: the wall-clock harness (`examples/common.timed`);
- `trace`: a `torch.profiler` context (CPU and, where there is a card,
  CUDA activities) writing a trace TensorBoard reads;
- `cost_table`: the per-op static cost table of a (compiled) expression,
  op counts keyed by (op, modulus-chain annotation), derived from the IR.
  Data volumes are not estimated here.
"""

from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

from alchemy_tpu_torch.examples.common import timed as phase  # noqa: F401
from alchemy_tpu_torch.lang.ir import App, Lam, Node, Prim


@contextmanager
def trace(logdir: str):
    """torch.profiler over the block, its trace written under `logdir` by
    `tensorboard_trace_handler` (view with TensorBoard's profiler plugin);
    yields the profiler."""
    import torch
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
