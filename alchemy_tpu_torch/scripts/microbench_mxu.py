"""Are int8 tensor-core matmuls fast on this card at the digit-NTT shapes? —
port of `scripts/microbench_mxu.py`.

The TPU question was whether s8 × s8 → s32 dots are fast on the MXU. On
Hopper it becomes int8 tensor cores (`torch._int_mm`, s8 × s8 → s32) against
bf16 `torch.matmul` (16 products accumulated in float32, the TPU's
digit-plane scheme), at the digit-NTT stage-1 shape: [R, 4K] @ [4K, M] in
int8 and 16 × [R, K] @ [K, M] in bf16 with R = 64·256, K = M = 128; each
timed with CUDA events over `ITERS` calls after one, and the int8 product
checked exact against int64. Library calls only: evidence for a later
kernel design, no port of a kernel.

    python -m alchemy_tpu_torch.scripts.microbench_mxu [--device cpu]

Prints the JAX script's lines on stderr and one JSON record (`s8_us`,
`s8_tops`, `bf16_us`, `bf16_tflops`, `s8_exact`, the shapes, `backend`,
`card`) on stdout. Writes no file.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

#: the digit-NTT stage-1 shape: 64 limb pairs × 256 rows, K = M = 128
SHAPE = (64 * 256, 128, 128)
ITERS = 256


def timed_us(fn, device: str, iters: int = ITERS) -> float:
    """µs a call of fn() over `iters` calls after one: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def run(device: str, shape=SHAPE, iters: int = ITERS) -> dict:
    from alchemy_tpu_torch.bench import backend, card, log

    R, K, M = shape
    rng = np.random.default_rng(0)
    a8 = torch.from_numpy(rng.integers(-128, 127, (R, 4 * K)).astype(np.int8)).to(device)
    w8 = torch.from_numpy(rng.integers(-128, 127, (4 * K, M)).astype(np.int8)).to(device)
    t8 = timed_us(lambda: torch._int_mm(a8, w8), device, iters)
    ops8 = 2 * R * 4 * K * M
    log(f"s8 [R,4K]@[4K,M]:  {t8:8.1f} us  {ops8 / t8 / 1e6:6.1f} Tops")

    ab = torch.from_numpy(rng.integers(0, 255, (R, K)).astype(np.float32)).to(device)
    wb = torch.from_numpy(rng.integers(0, 255, (K, M)).astype(np.float32)).to(device)
    ab, wb = ab.to(torch.bfloat16), wb.to(torch.bfloat16)

    def dotb():
        # 16 products like the digit-plane scheme, accumulated in float32
        out = None
        for _ in range(16):
            p = torch.matmul(ab, wb).float()
            out = p if out is None else out + p
        return out

    tb = timed_us(dotb, device, iters)
    flopsb = 2 * R * K * M * 16
    log(f"bf16 16x [R,K]@[K,M]: {tb:8.1f} us  {flopsb / tb / 1e6:6.1f} Tflops")

    # the int8 product's exactness on a few rows
    ref = a8[:4].cpu().long() @ w8.cpu().long()
    exact = bool(torch.equal(torch._int_mm(a8[:32], w8)[:4].cpu().long(), ref))
    log(f"s8 dot exact: {exact}")
    return {"shape_R_K_M": [R, K, M], "s8_us": t8, "s8_tops": ops8 / t8 / 1e6,
            "bf16_us": tb, "bf16_tflops": flopsb / tb / 1e6, "s8_exact": exact,
            "backend": backend(device), "card": card(device)}


def main(device: str | None = None, argv=None) -> int:
    from alchemy_tpu_torch.bench import run_args

    device = run_args("alchemy_tpu_torch.scripts.microbench_mxu", device, argv).device
    rec = run(device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["s8_exact"] else 1


if __name__ == "__main__":
    sys.exit(main(argv=sys.argv[1:]))
