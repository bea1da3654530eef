"""Share of the device's busy time in the float64 GEMM kernels that
`TorchBackend._matmul_mod` launches (the exact transforms, embeddings and
traces of the general path), in configurations of the general path. Read
from the traced slice's device operations by label
(`benchmark/jit_spans.py`). Moves call_p95_ms."""

from benchmark import jit_spans

UNIT = "%"


def read(ctx):
    return jit_spans.share(ctx, "gemm")
