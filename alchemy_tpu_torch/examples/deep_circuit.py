"""Deep circuit: a depth-D squaring chain with full relinearization and one
rescale per level on a power-of-two ring — port of
`alchemy_tpu/examples/deep_circuit.py`, with its mid-chain checkpoint and
resume (`save_state`; the state file is the JAX package's, so a chain
stopped by either package resumes in the other).

Over F_2, (Σ a_i x^i)² = Σ a_i x^{2i}, so the plaintext after D levels is a
coefficient permutation of the message: an O(n) exact check at any depth.
Each level multiplies the ciphertext with itself, relinearizes with a fresh
hint for the current chain (TrivGad or hybrid key-switching) and rescales
by one ~30-bit limb, so a depth-D chain starts with D + 2 limbs.

    python -m alchemy_tpu_torch.examples.deep_circuit --log-n 15 --depth 16 --ks hybrid --device cuda

--impl picks the NTT slot order ("mxu", the default, "mxu8", "pallas" or
"vpu"). A recovery drill: `--stop-at-level 8 --state-path st.npz` saves the
chain before level 8 and exits; `--resume --state-path st.npz` finishes it
in a fresh process and checks the whole chain:

    python -m alchemy_tpu_torch.examples.deep_circuit --log-n 15 --depth 16 --ks hybrid --impl vpu --stop-at-level 8 --state-path st.npz
    python -m alchemy_tpu_torch.examples.deep_circuit --resume --state-path st.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.she import fast
from alchemy_tpu_torch.she.fast import FastParams
from alchemy_tpu_torch.she.hybrid import HybridKS, hybrid_relin_hint, mul_relin_hybrid
from alchemy_tpu_torch.she.keys import gaussian_coeffs
from alchemy_tpu_torch.she.serialize import npz_path


def expected_square_chain_mod2(msg: np.ndarray, n: int, depth: int) -> np.ndarray:
    """Coefficients of msg^(2^depth) in Z_2[x]/(x^n+1) (deep_circuit.py:24)."""
    cur = np.asarray(msg, dtype=np.int64) % 2
    for _ in range(depth):
        # x^j ↦ x^{2j}, folded by x^n = −1 ≡ 1: j and j + n/2 both land on 2j
        nxt = np.zeros(n, dtype=np.int64)
        nxt[0::2] = cur[:n // 2] ^ cur[n // 2:]
        cur = nxt
    return cur


def save_state(path: str, *, log_n: int, depth: int, level: int, ct: torch.Tensor,
               s_int, msg, impl: str, ks: str) -> None:
    """Mid-chain checkpoint (deep_circuit.py:40) with the JAX package's keys:
    the secret key's coefficients, the message (the oracle's input), the
    ciphertext before `level` as uint32 [2, L, n] in the slot order of
    `impl`, and the chain's position. No hint randomness is saved: a
    resumed run samples each level's hint anew from OS entropy. The file is
    `path` with the suffix ".npz" added if it lacks one (`npz_path`)."""
    np.savez(npz_path(path), log_n=log_n, depth=depth, level=level, ct=to_numpy(ct),
             s_int=np.asarray(s_int), msg=np.asarray(msg), impl=str(impl), ks=ks)


def resume_impl(stored: str, impl: str | None = None) -> str:
    """The slot order in which a state file resumes: the file's own impl;
    where the file holds "" (the JAX package writes the caller's impl, so
    "" when its caller named none), the caller's impl, else
    ALCHEMY_NTT_IMPL when set, else the default "mxu" — the JAX package's
    reading of "" (deep_circuit.py:73-75 through fast.py:35). An impl that
    names another slot order than a non-empty stored one raises ValueError."""
    if stored and impl is not None and fast.IMPLS.get(impl) != fast.IMPLS.get(stored):
        raise ValueError(f"impl={impl!r}: the state file was saved in impl={stored!r}")
    return stored or impl or os.environ.get("ALCHEMY_NTT_IMPL") or fast.DEFAULT_NTT_IMPL


def run(log_n: int = 9, depth: int = 16, seed: int = 0, verbose: bool = True,
        impl: str | None = None, ks: str = "trivgad", device="cuda",
        stop_at_level: int | None = None, state_path: str | None = None,
        resume: bool = False):
    """Runs the chain (deep_circuit.py:52) and returns (ok, ct, level_ms): ok
    when the decryption equals the squaring chain, the final ciphertext, and
    the host-clock milliseconds of each level run (hint, multiply, rescale).
    impl is the NTT slot order (None: the `FastParams` default); ks is
    "trivgad", "hybrid" or "auto" (hybrid from 12 limbs on).

    With stop_at_level and state_path, the chain saves its state before that
    level (`save_state`) and returns (None, level). With resume, it loads the
    state from state_path (log_n, depth, ks and the seed's key and message
    come from the file; the other arguments but impl, device and verbose are
    not read), reseeds from OS entropy, runs the remaining levels on
    `device` and checks the whole chain. The slot order of a resumed chain is
    the file's impl (`resume_impl`)."""
    if (stop_at_level is not None or resume) and state_path is None:
        raise ValueError("stop_at_level and resume need a state_path")
    if resume:
        st = np.load(npz_path(state_path), allow_pickle=False)
        log_n, depth, level0 = int(st["log_n"]), int(st["depth"]), int(st["level"])
        impl, ks = resume_impl(str(st["impl"]), impl), str(st["ks"])
        s_int, msg = st["s_int"], st["msg"]
        rng = np.random.default_rng()        # OS entropy: never replay the saved run's
    else:
        rng = np.random.default_rng(seed)
        level0 = 0
    p = FastParams.make(log_n, depth + 2, zp=2, impl=impl or fast.DEFAULT_NTT_IMPL)
    if ks == "auto":
        ks = "hybrid" if len(p.qs) >= 12 else "trivgad"
    if ks not in ("trivgad", "hybrid"):
        raise ValueError(f"ks={ks!r}: want 'trivgad', 'hybrid' or 'auto'")

    def key_at(pp):
        return fast._ntt_p(pp, fast._residues(s_int, pp.qs, device))

    cur_p = replace(p, qs=p.qs[:len(p.qs) - level0])
    if resume:
        ct = to_torch(st["ct"], device)
        if tuple(ct.shape) != (2, len(cur_p.qs), p.n):
            raise ValueError(f"state ct {tuple(ct.shape)}: want (2, {len(cur_p.qs)}, {p.n})")
    else:
        s_int = gaussian_coeffs(rng, 1.0, p.n)
        s = key_at(p)
        msg = rng.integers(0, 2, p.n)
        ct = fast.encrypt(p, s, msg, rng)
    level_ms = []
    for level in range(level0, depth):
        if level == stop_at_level:
            save_state(state_path, log_n=log_n, depth=depth, level=level, ct=ct, s_int=s_int,
                       msg=msg, impl=p.impl, ks=ks)
            if verbose:
                print(f"checkpointed at level {level} -> {npz_path(state_path)}")
            return None, level
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
    ap.add_argument("--impl", default=None, choices=sorted(fast.IMPLS),
                    help="NTT slot order (default: the FastParams default, mxu)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels), or cpu for the plain versions")
    ap.add_argument("--stop-at-level", type=int, default=None,
                    help="save the state before this level and exit")
    ap.add_argument("--state-path", default=None, help="the state file (.npz)")
    ap.add_argument("--resume", action="store_true",
                    help="finish the chain saved at --state-path")
    args = ap.parse_args()
    ok = run(log_n=args.log_n, depth=args.depth, impl=args.impl, ks=args.ks,
             device=args.device, stop_at_level=args.stop_at_level,
             state_path=args.state_path, resume=args.resume)[0]
    sys.exit(0 if ok is None or ok else 1)
