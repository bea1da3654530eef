"""Deep-config comparison: TrivGad against hybrid key-switching — port of
`scripts/bench_hybrid.py`.

BGV ciphertext multiply + relinearize of one ciphertext at a deep chain
(default L = 16, n = 2^15), with both gadgets: `she/hybrid.py`'s
`mul_relin_hybrid` (raw hints; kernels A, 4, then 5 and 7) and
`fast.mul_relin` (Shoup hints; kernels A and B), each one CUDA graph
replayed by a doubling loop, and whether the two products decrypt alike.
Knobs as in the JAX script: HB_LOG_N (15), HB_NLIMB (16), HB_IMPL (mxu; also
pallas, mxu8, vpu), HB_SECONDS (2.0).

    python -m alchemy_tpu_torch.scripts.bench_hybrid [--device cpu]

Prints the JAX script's lines on stderr and one JSON record on stdout:
the quantities of those lines (`log_n`, `nlimb`, `groups`, `K`, `device`,
`hybrid_ms_per_op`, `hybrid_ops_per_s`, `trivgad_ms_per_op`,
`trivgad_ops_per_s`, `trivgad_over_hybrid`, `decrypt_parity`) plus
`backend` and `card`. Exits 1 when the decryptions differ. Writes no file.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch


def main(device: str | None = None, argv=None) -> int:
    from alchemy_tpu_torch.bench import (
        _timed_loop,
        backend,
        card,
        compiled_step,
        log,
        run_args,
    )
    from alchemy_tpu_torch.she import fast
    from alchemy_tpu_torch.she.fast import FastParams
    from alchemy_tpu_torch.she.hybrid import HybridKS, hybrid_keygen_hint, mul_relin_hybrid

    device = run_args("alchemy_tpu_torch.scripts.bench_hybrid", device, argv).device
    log_n = int(os.environ.get("HB_LOG_N", "15"))
    nlimb = int(os.environ.get("HB_NLIMB", "16"))
    secs = float(os.environ.get("HB_SECONDS", "2.0"))
    impl = os.environ.get("HB_IMPL", "mxu")
    p = FastParams.make(log_n, nlimb, zp=2, impl=impl)
    hk = HybridKS.make(p)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    groups = [len(g) for g in hk.groups]
    log(f"n=2^{log_n}, L={nlimb}, groups={groups}, K={len(hk.ps)} | {name}")
    rng = np.random.default_rng(1)
    s, (hb, ha) = hybrid_keygen_hint(hk, rng, device=device)
    tb, ta = fast.relin_hint(p, s, np.random.default_rng(2), shoup=True)
    c1 = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    c2 = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)

    step_h, o_h = compiled_step(lambda o: mul_relin_hybrid(hk, c1, o, hb, ha), c2)
    step_t, o_t = compiled_step(lambda o: fast.mul_relin(p, c1, o, tb, ta), c2)
    # one doubling window, as the JAX script's `timed`
    d_h = _timed_loop(step_h, o_h, secs, windows=1, device=device)[1]
    d_t = _timed_loop(step_t, o_t, secs, windows=1, device=device)[1]
    parity = bool(np.array_equal(fast.decrypt(p, s, step_h(c2)), fast.decrypt(p, s, step_t(c2))))
    log(f"hybrid  {d_h*1e3:8.2f} ms/op ({1/d_h:7.1f} ops/s)")
    log(f"trivgad {d_t*1e3:8.2f} ms/op ({1/d_t:7.1f} ops/s)  -> {d_t/d_h:.2f}x")
    log(f"decrypt parity: {parity}")
    rec = {"log_n": log_n, "nlimb": nlimb, "impl": impl, "groups": groups, "K": len(hk.ps),
           "device": name, "hybrid_ms_per_op": d_h * 1e3, "hybrid_ops_per_s": 1 / d_h,
           "trivgad_ms_per_op": d_t * 1e3, "trivgad_ops_per_s": 1 / d_t,
           "trivgad_over_hybrid": d_t / d_h, "decrypt_parity": parity,
           "backend": backend(device), "card": card(device)}
    print(json.dumps(rec), flush=True)
    return 0 if parity else 1


if __name__ == "__main__":
    sys.exit(main(argv=sys.argv[1:]))
