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

`run` makes each level's hint as it reaches the level. A caller that
evaluates the chain many times makes every level's parameters and hints
once (`chain_keys`) and runs the chain from them (`square_chain`): each
level's multiply-relinearize and rescale, back to back, with no host
sampling and no synchronize.

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
from typing import NamedTuple

import numpy as np
import torch

from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.she import fast, hybrid
from alchemy_tpu_torch.she.fast import FastParams
from alchemy_tpu_torch.she.hybrid import HybridKS, hybrid_relin_hint
from alchemy_tpu_torch.she.keys import gaussian_coeffs
from alchemy_tpu_torch.she.serialize import npz_path
from alchemy_tpu_torch.utils.profiling import span


def expected_square_chain_mod2(msg: np.ndarray, n: int, depth: int) -> np.ndarray:
    """Coefficients of msg^(2^depth) in Z_2[x]/(x^n+1) (deep_circuit.py:24)."""
    cur = np.asarray(msg, dtype=np.int64) % 2
    for _ in range(depth):
        # x^j ↦ x^{2j}, folded by x^n = −1 ≡ 1: j and j + n/2 both land on 2j
        nxt = np.zeros(n, dtype=np.int64)
        nxt[0::2] = cur[:n // 2] ^ cur[n // 2:]
        cur = nxt
    return cur


class Level(NamedTuple):
    """What one level of the chain needs: the chain it starts at (p), its
    hybrid key-switching parameters (hk, None for TrivGad) and its
    relinearization hint (hints: hybrid (B, A), or TrivGad's Shoup pairs)."""

    p: FastParams
    hk: HybridKS | None
    hints: tuple


def key_at(p: FastParams, s_int, device) -> torch.Tensor:
    """The secret key given by its integer coefficients, NTT domain over p.qs."""
    return fast._ntt_p(p, fast._residues(s_int, p.qs, device))


def level_keys(p: FastParams, s_int, rng: np.random.Generator, ks: str, device,
               variance: float = 1.0) -> Level:
    """The `Level` at chain p: `HybridKS.make(p)` and its hint (ks
    "hybrid"), or TrivGad's Shoup hint (ks "trivgad"), drawn from rng with
    the given error variance."""
    if ks == "hybrid":
        hk = HybridKS.make(p)
        return Level(p, hk, hybrid_relin_hint(hk, s_int, rng, variance, device=device))
    return Level(p, None, fast.relin_hint(p, key_at(p, s_int, device), rng, variance, shoup=True))


def chain_keys(p: FastParams, depth: int, s_int, rng: np.random.Generator, ks: str, device,
               variance: float = 1.0) -> list[Level]:
    """Every level of a depth-`depth` chain that starts at p, with its hint
    made now: level i at p.qs[:len(p.qs) − i], drawn from rng in the order
    `run` draws them."""
    return [level_keys(replace(p, qs=p.qs[:len(p.qs) - i]), s_int, rng, ks, device, variance)
            for i in range(depth)]


def square_level(level: int, lv: Level, ct: torch.Tensor) -> torch.Tensor:
    """One level: ct·ct relinearized (`hybrid.mul_relin_hybrid`, or
    `fast.mul_relin`), then `fast.rescale` by one limb, [..., 2, L, n] →
    [..., 2, L − 1, n]. Traced as the span `chain.level` (attributes level,
    L)."""
    with span("chain.level", level=level, L=len(lv.p.qs)):
        if lv.hk is not None:
            ct = hybrid.mul_relin_hybrid(lv.hk, ct, ct, *lv.hints)
        else:
            ct = fast.mul_relin(lv.p, ct, ct, *lv.hints)
        return fast.rescale(lv.p, ct, 1)


def square_chain(levels: list[Level], ct: torch.Tensor) -> torch.Tensor:
    """The chain from prepared levels (`chain_keys`): [..., 2, L, n] at
    levels[0].p → [..., 2, L − depth, n], every level launched back to back
    with no synchronize. Traced as the root span `square_chain` (attributes
    batch, L, depth, n) over one `chain.level` span a level."""
    with span("square_chain") as root:
        if root is not None:
            p = levels[0].p
            root.attrs.update(batch=ct.numel() // (2 * len(p.qs) * p.n), L=len(p.qs),
                              depth=len(levels), n=p.n)
        for level, lv in enumerate(levels):
            ct = square_level(level, lv, ct)
        return ct


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

    cur_p = replace(p, qs=p.qs[:len(p.qs) - level0])
    if resume:
        ct = to_torch(st["ct"], device)
        if tuple(ct.shape) != (2, len(cur_p.qs), p.n):
            raise ValueError(f"state ct {tuple(ct.shape)}: want (2, {len(cur_p.qs)}, {p.n})")
    else:
        s_int = gaussian_coeffs(rng, 1.0, p.n)
        s = key_at(p, s_int, device)
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
        ct = square_level(level, level_keys(cur_p, s_int, rng, ks, device), ct)
        cur_p = replace(cur_p, qs=cur_p.qs[:-1])
        if ct.is_cuda:
            torch.cuda.synchronize(ct.device)
        level_ms.append((time.perf_counter() - t0) * 1e3)
        if verbose:
            print(f"level {level + 1}: limbs={len(cur_p.qs)} {level_ms[-1]:.1f} ms")
    dec = fast.decrypt(cur_p, key_at(cur_p, s_int, device), ct)
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
