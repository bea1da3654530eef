"""Deep circuit: a depth-D squaring chain with full relinearization and one
rescale per level on a power-of-two ring — port of
`alchemy_tpu/examples/deep_circuit.py` (checkpoint/resume not carried over).

Over F_2, (Σ a_i x^i)² = Σ a_i x^{2i}, so the plaintext after D levels is a
coefficient permutation of the message: an O(n) exact check at any depth.
Each level multiplies the ciphertext with itself, relinearizes with a fresh
hint for the current chain (TrivGad or hybrid key-switching) and rescales
by one ~30-bit limb, so a depth-D chain starts with D + 2 limbs.

    python -m alchemy_tpu_torch.examples.deep_circuit --log-n 15 --depth 16 --ks hybrid --device cuda

--impl picks the NTT slot order ("mxu", the default, or "pallas").
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from alchemy_tpu_torch.she import fast
from alchemy_tpu_torch.she.fast import FastParams
from alchemy_tpu_torch.she.hybrid import HybridKS, hybrid_relin_hint, mul_relin_hybrid
from alchemy_tpu_torch.she.keys import gaussian_coeffs


def expected_square_chain_mod2(msg: np.ndarray, n: int, depth: int) -> np.ndarray:
    """Coefficients of msg^(2^depth) in Z_2[x]/(x^n+1) (deep_circuit.py:24)."""
    cur = np.asarray(msg, dtype=np.int64) % 2
    for _ in range(depth):
        # x^j ↦ x^{2j}, folded by x^n = −1 ≡ 1: j and j + n/2 both land on 2j
        nxt = np.zeros(n, dtype=np.int64)
        nxt[0::2] = cur[:n // 2] ^ cur[n // 2:]
        cur = nxt
    return cur


def run(log_n: int = 9, depth: int = 16, seed: int = 0, verbose: bool = True,
        impl: str | None = None, ks: str = "trivgad", device="cuda"):
    """Runs the chain (deep_circuit.py:52) and returns (ok, ct, level_ms): ok
    when the decryption equals the squaring chain, the final ciphertext, and
    the host-clock milliseconds of each level (hint, multiply, rescale).
    impl is the NTT slot order (None: the `FastParams` default); ks is
    "trivgad", "hybrid" or "auto" (hybrid from 12 limbs on)."""
    p = FastParams.make(log_n, depth + 2, zp=2, impl=impl or fast.DEFAULT_NTT_IMPL)
    if ks == "auto":
        ks = "hybrid" if len(p.qs) >= 12 else "trivgad"
    if ks not in ("trivgad", "hybrid"):
        raise ValueError(f"ks={ks!r}: want 'trivgad', 'hybrid' or 'auto'")
    rng = np.random.default_rng(seed)
    s_int = gaussian_coeffs(rng, 1.0, p.n)

    def key_at(pp):
        return fast._ntt_p(pp, fast._residues(s_int, pp.qs, device))

    s = key_at(p)
    msg = rng.integers(0, 2, p.n)
    ct = fast.encrypt(p, s, msg, rng)
    cur_p, level_ms = p, []
    for level in range(depth):
        t0 = time.perf_counter()
        if ks == "hybrid":
            hk = HybridKS.make(cur_p)
            hb, ha = hybrid_relin_hint(hk, s_int, rng, device=device)
            ct = mul_relin_hybrid(hk, ct, ct, hb, ha)
        else:
            hb, ha = fast.relin_hint(cur_p, key_at(cur_p), rng, shoup=True)
            ct = fast.mul_relin(cur_p, ct, ct, hb, ha)
        ct = fast.rescale(cur_p, ct, 1)
        cur_p = replace(cur_p, qs=cur_p.qs[:-1])
        if ct.is_cuda:
            torch.cuda.synchronize(ct.device)
        level_ms.append((time.perf_counter() - t0) * 1e3)
        if verbose:
            print(f"level {level + 1}: limbs={len(cur_p.qs)} {level_ms[-1]:.1f} ms")
    dec = fast.decrypt(cur_p, key_at(cur_p), ct)
    ok = bool(np.array_equal(dec, expected_square_chain_mod2(msg, p.n, depth)))
    if verbose:
        print("PASS" if ok else "FAIL")
    return ok, ct, level_ms


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=13)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--ks", default="trivgad", choices=("trivgad", "hybrid", "auto"))
    ap.add_argument("--impl", default=None, choices=("mxu", "pallas"),
                    help="NTT slot order (default: the FastParams default, mxu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels), or cpu for the plain versions")
    args = ap.parse_args()
    ok, _, _ = run(log_n=args.log_n, depth=args.depth, impl=args.impl, ks=args.ks,
                   device=args.device)
    sys.exit(0 if ok else 1)
