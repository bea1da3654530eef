"""Exact 2-factor (4-step) negacyclic NTT in plain torch (port of
`alchemy_tpu/backend/ntt_mxu.py`).

n = n1·n2 with both ≤ 256 and n1 as close to 128 as possible (`_pick_split`).
Forward: natural order [..., L, n], viewed as the (j1, j2) grid, → slot
k1·n2 + k2, which holds x(ψ^{2K+1}) with K = k1 + n1·k2 and
ψ = root_of_unity(2n, q). The stages are those of `ntt_mxu`: the DFT over
j1 (the ψ^{j1·n2} twist folded into W1), the twiddle ω^{k1·j2}·ψ^{j2}, the
DFT over j2; the inverse runs them backwards with ψ^{-j}·n⁻¹ folded into W1i
and the inverse twiddle. This is the slot order of `FastParams(impl="mxu")`,
the JAX package's default; the TPU's bf16 digit planes are not carried over.

Each matrix stage is `ntt3._matmul_mod`: one float64 matmul of 16-bit halves,
every partial sum below 2^16·2^16·256 = 2^40 < 2^53, so exact in any
summation order, on the CPU and on the card. These transforms are the plain
versions of CUDA kernels 8 and 9 and of the mxu order of kernels A, B, 4, 7.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from alchemy_tpu_torch.backend.ntt3 import _matmul_mod, psi_powers

MAX_FACTOR = 256  # contraction size bound of the exact matmul (ntt_mxu.py:36)


def _pick_split(n: int) -> tuple[int, int]:
    """n = n1·n2 with both ≤ MAX_FACTOR, n1 as close to 128 as possible
    (ntt_mxu.py:39)."""
    best = None
    n1 = 1
    while n1 <= n:
        n2 = n // n1
        if n1 * n2 == n and n1 <= MAX_FACTOR and n2 <= MAX_FACTOR:
            score = abs(n1 - 128)
            if best is None or score < best[0]:
                best = (score, n1, n2)
        n1 *= 2
    if best is None:
        raise ValueError(f"ring size {n} too large for the 2-factor NTT")
    return best[1], best[2]


@lru_cache(maxsize=None)
def ntt2_tables(n: int, qs: tuple[int, ...]) -> dict:
    """Raw integer tables of `mxu_tables` (ntt_mxu.py:72-152) as int64 numpy
    arrays: W1, W1i [L, n1, n1], W2, W2i [L, n2, n2], tw, itw [L, n1, n2];
    every entry a power of ψ (times n⁻¹ in W1i)."""
    n1, n2 = _pick_split(n)
    two_n = 2 * n
    a1, a2 = np.arange(n1, dtype=np.int64), np.arange(n2, dtype=np.int64)
    # ψ-exponents mod 2n (ω = ψ², ω1 = ω^{n2}, ω2 = ω^{n1}); the inverses negate them
    e_w1 = (2 * n2 * np.outer(a1, a1) + n2 * a1[None, :]) % two_n      # [k1, j1]
    e_w1i = (-2 * n2 * np.outer(a1, a1) - n2 * a1[:, None]) % two_n    # [j1, k1]
    e_w2 = (2 * n1 * np.outer(a2, a2)) % two_n                          # [k2, j2]
    e_tw = (2 * np.outer(a1, a2) + a2[None, :]) % two_n                 # [k1, j2]
    tabs = {k: [] for k in ("W1", "W1i", "W2", "W2i", "tw", "itw")}
    for q in qs:
        p = psi_powers(n, q)
        neg = lambda e: p[(two_n - e) % two_n]
        tabs["W1"].append(p[e_w1])
        tabs["W1i"].append(p[e_w1i] * pow(n, -1, q) % q)
        tabs["W2"].append(p[e_w2])
        tabs["W2i"].append(neg(e_w2))
        tabs["tw"].append(p[e_tw])
        tabs["itw"].append(neg(e_tw))
    out = {k: np.stack(v) for k, v in tabs.items()}
    out.update(n1=n1, n2=n2)
    return out


@lru_cache(maxsize=None)
def _device_tables(n: int, qs: tuple[int, ...], device: str) -> dict:
    out = {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
           for k, v in ntt2_tables(n, qs).items()}
    col = lambda vals: torch.tensor(vals, dtype=torch.int64, device=device)[:, None, None]
    out.update(q=col(qs), r16=col([(1 << 16) % q for q in qs]),
               r32=col([(1 << 32) % q for q in qs]))
    return out


def _tables(n, qs, device) -> dict:
    return _device_tables(n, tuple(qs), str(torch.device(device)))


def _forward_tail(y, t):
    """Twiddle and DFT over j2 of the stage-1 output y [..., L, k1, j2]."""
    return _matmul_mod(y * t["tw"] % t["q"], t["W2"], t)


def ntt2(x: torch.Tensor, n: int, qs: tuple[int, ...]) -> torch.Tensor:
    """Forward negacyclic NTT, [..., L, n] natural order → 2-factor slot
    order (`ntt_mxu`, ntt_mxu.py:325); any uint32 input, canonical output."""
    t = _tables(n, qs, x.device)
    n1, n2 = t["n1"], t["n2"]
    lead, L = x.shape[:-2], x.shape[-2]
    xg = x.reshape(*lead, L, n1, n2).transpose(-1, -2)        # [..., L, j2, j1]
    y = _matmul_mod(xg, t["W1"], t).transpose(-1, -2)         # [..., L, k1, j2]
    return _forward_tail(y, t).reshape(*lead, L, n)


def ntt2_bcast(x: torch.Tensor, n: int, qs: tuple[int, ...]) -> torch.Tensor:
    """Forward NTT of each row of x [..., D, n] under every limb's tables
    → [..., D, L, n] (`ntt_mxu_bcast`, ntt_mxu.py:364); rows may be
    unreduced uint32."""
    t = _tables(n, qs, x.device)
    n1, n2 = t["n1"], t["n2"]
    lead = x.shape[:-1]
    xg = x.reshape(*lead, n1, n2).transpose(-1, -2).unsqueeze(-3)  # [..., D, 1, j2, j1]
    y = _matmul_mod(xg, t["W1"], t).transpose(-1, -2)              # [..., D, L, k1, j2]
    return _forward_tail(y, t).reshape(*lead, len(qs), n)


def intt2(x: torch.Tensor, n: int, qs: tuple[int, ...]) -> torch.Tensor:
    """Inverse of ntt2 (`intt_mxu`, ntt_mxu.py:389): slot order in (any
    uint32), natural order out."""
    t = _tables(n, qs, x.device)
    n1, n2 = t["n1"], t["n2"]
    lead, L = x.shape[:-2], x.shape[-2]
    z = _matmul_mod(x.reshape(*lead, L, n1, n2), t["W2i"], t)      # [..., L, k1, j2]
    z = (z * t["itw"] % t["q"]).transpose(-1, -2)                  # [..., L, j2, k1]
    y = _matmul_mod(z, t["W1i"], t)                                # [..., L, j2, j1]
    return y.transpose(-1, -2).reshape(*lead, L, n)
