"""Profile TrivGad multiply + relinearize on the card: over a steady window
of calls, the device's busy time and idle share and its time by kernel
(torch.profiler, CUPTI, through `scripts/profile_trace.py`), beside the
host clock: the counterpart of the JAX package's `scripts/profile_mul_relin.py`,
whose stage ablation answers the same question (where the time of one
call goes) by timing truncated variants.

    python -m alchemy_tpu_torch.examples.profile_mul_relin --log-n 16 15 --impl mxu

At L = 8 limbs, Bt = 16 ciphertexts per call and Shoup hints (the
headline and ring-sweep configurations), 20 profiled calls, in the NTT slot
order --impl ("mxu", the FastParams default, or "pallas"). Prints the
card's name and power limit, then one JSON object per ring size. Needs a
CUDA device: without one it fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from alchemy_tpu_torch.scripts.profile_trace import device_profile
from alchemy_tpu_torch.she import fast


def profile(log_n: int, L: int, Bt: int, calls: int, impl: str = fast.DEFAULT_NTT_IMPL,
            seed: int = 0) -> dict:
    """Keys, Shoup hints and 2·Bt fresh ciphertexts from `seed`, three
    warm-up calls, then `calls` calls of `fast.mul_relin` on Bt ciphertexts
    under the profiler (`scripts/profile_trace.device_profile`)."""
    p = fast.FastParams.make(log_n, L, zp=2, impl=impl)
    rng = np.random.default_rng(seed)
    s = fast.keygen(p, rng, device="cuda")
    hb, ha = fast.relin_hint(p, s, rng, shoup=True)
    cts = torch.stack([fast.encrypt(p, s, rng.integers(0, 2, p.n), rng) for _ in range(2 * Bt)])
    a, b = cts[:Bt], cts[Bt:]
    for _ in range(3):
        fast.mul_relin(p, a, b, hb, ha)
    torch.cuda.synchronize()
    prof = device_profile(fast.mul_relin, (p, a, b, hb, ha), calls)
    return {"log_n": log_n, "L": L, "Bt": Bt, "impl": impl, "calls": calls,
            "host_us": prof["host_us"], "device_span_us": prof["span_us"],
            "device_busy_us": prof["busy_us"], "idle_share": prof["idle_share"],
            "device_events": prof["launches"],
            "host_ops_per_s": Bt * calls / prof["host_us"] * 1e6,
            "by_kernel_us": {name: t for name, t, _ in prof["events"]}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, nargs="+", default=[16])
    ap.add_argument("--impl", default=fast.DEFAULT_NTT_IMPL, choices=("mxu", "pallas"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_mul_relin: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for log_n in args.log_n:
        print(json.dumps(profile(log_n, L=8, Bt=16, calls=20, impl=args.impl)), flush=True)


if __name__ == "__main__":
    main()
