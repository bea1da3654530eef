"""Share of the device's busy time in torch's elementwise, reduction, copy
and cat kernels (the general path's int64 mod-q chains: `TorchBackend`'s
add, sub, mul and remainders, the splits and recombinations around each
GEMM), in configurations of the general path. Read from the traced slice's
device operations by label (`benchmark/jit_spans.py`). Moves
call_p95_ms."""

from benchmark import jit_spans

UNIT = "%"


def read(ctx):
    return jit_spans.share(ctx, "modq")
