"""Sustained multiply + relinearize throughput at thousands of ciphertexts a
call — port of `scripts/bench_batch.py`.

At each batch size B of BATCH_SIZES, `alchemy_tpu_torch.bench.bench_on`
times one CUDA graph of `fast.mul_relin` on B ciphertexts (kernels A and B
at Bt = B in one launch each, Shoup hint pairs; the JAX package's `lax.map`
chunking into Bt = 16 calls is not ported), best of 5 windows with median
and IQR, and checks that the output decrypts (every row equal on the
device, the first and last decrypted). Knobs as in the JAX script:
BATCH_SIZES ("256,1024"), BENCH_LOG_N (15), BENCH_NLIMB (8), BENCH_SECONDS
(3.0); impl "pallas" on the card, "vpu" on the CPU.

    python -m alchemy_tpu_torch.scripts.bench_batch [--device cpu] [--out PATH]

Prints the JAX script's record (each point with `decrypt_pass` added) plus
`backend` and `card` on stdout, writes it to build/bench/bench_batch.json
or --out, and exits 1 when a point does not decrypt.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch


def main(device: str | None = None, argv=None, out: str | None = None) -> int:
    from alchemy_tpu_torch.bench import backend, bench_on, card, log, run_args, write_record
    from alchemy_tpu_torch.she.fast import FastParams

    args = run_args("alchemy_tpu_torch.scripts.bench_batch", device, argv, out, writes=True)
    device, out = args.device, args.out
    log_n = int(os.environ.get("BENCH_LOG_N", "15"))
    nlimb = int(os.environ.get("BENCH_NLIMB", "8"))
    secs = float(os.environ.get("BENCH_SECONDS", "3.0"))
    sizes = [int(s) for s in os.environ.get("BATCH_SIZES", "256,1024").split(",")]
    impl = "pallas" if device == "cuda" else "vpu"
    p = FastParams.make(log_n, nlimb, zp=2, impl=impl)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    log(f"device: {name} | ring n=2^{log_n}, limbs={nlimb}, impl={impl}")

    points = {}
    for B in sizes:
        ops, per, stats = bench_on(device, p, np.random.default_rng(0), secs, batch=B,
                                   check=True)
        points[f"B{B}"] = {
            "ops_per_s": round(ops, 2),
            "ms_per_ct_best": round(per * 1e3, 4),
            "ms_per_ct_median": round(stats["median"] * 1e3, 4),
            "ms_per_ct_iqr": round(stats["iqr"] * 1e3, 4),
            "windows": stats["windows"],
            "decrypt_pass": stats["decrypt_pass"],
        }
        log(f"B={B}: {ops:.1f} ops/s ({per*1e3:.4f} ms/ct best, median "
            f"{stats['median']*1e3:.4f}, IQR {stats['iqr']*1e3:.4f}); decrypts: "
            f"{stats['decrypt_pass']}")

    rec = {
        "metric": f"bgv_mul_relin_batched_simd_n2e{log_n}_L{nlimb}",
        "unit": "ops/s",
        "config": "thousands of packed ciphertexts: one CUDA graph a call of kernels A and B "
                  "on the whole batch, Shoup hint pairs",
        "points": points,
        "device": name,
        "backend": backend(device),
        "card": card(device),
    }
    print(json.dumps(rec), flush=True)
    log(f"wrote {write_record(rec, 'bench_batch.json', out)}")
    return 0 if all(pt["decrypt_pass"] for pt in points.values()) else 1


if __name__ == "__main__":
    sys.exit(main(argv=sys.argv[1:]))
