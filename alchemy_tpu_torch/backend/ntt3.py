"""Exact 3-factor negacyclic NTT in plain torch (port of
`alchemy_tpu/backend/ntt_mxu3.py`).

n = A·B·r with A = B = 2^k ≤ 128 and r ∈ {1, 2, 4} (`_split3`). Forward:
natural order [..., L, n] → slot k1·(B·r) + k3·B + k2, which holds
x(ψ^{2K+1}) with K = k1 + A·k3 + A·r·k2 and ψ = root_of_unity(2n, q). The
stages are those of `ntt_mxu3` (stage-1 DFT_A with the ψ twist, big
twiddle, radix-r DFT, small twiddle, stage-3 DFT_B), on the raw integer
tables; the TPU's bf16 digit planes are not carried over.

Values are uint32 held in int64 tensors (see modarith). Each matrix stage
is one float64 matmul of 16-bit halves: every partial sum stays below
2^16·2^16·128 < 2^53, so it is exact in any summation order, on the CPU and
on the card. These transforms are the standalone NTT of keygen, encrypt,
decrypt and rescale, and the reference of the CUDA kernels' transforms.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from alchemy_tpu_torch.nt.primes import root_of_unity


def _split3(n: int) -> tuple[int, int, int]:
    """n = A·B·r with A = B = 2^k ≤ 128 and the radix r ∈ {1, 2, 4} as small
    as possible (ntt_mxu3.py:49)."""
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"ring size {n} is not a power of two")
    for r in (1, 2, 4):
        rest = log_n - (r.bit_length() - 1)
        if rest % 2 == 0 and rest // 2 <= 7:
            A = B = 1 << (rest // 2)
            return A, B, r
    raise ValueError(f"ring size {n}: no A=B≤128, r∈(1,2,4) split")


def psi_powers(n: int, q: int) -> np.ndarray:
    """ψ^e mod q for e in [0, 2n), ψ = root_of_unity(2n, q) (int64)."""
    psi = root_of_unity(2 * n, q)
    p = np.ones(2 * n, dtype=np.int64)
    p[1] = psi
    k = 2
    while k < 2 * n:
        # doubling: ψ^{k+j} = ψ^j·ψ^k (products < 2^62)
        p[k:2 * k] = p[:k] * pow(psi, k, q) % q
        k *= 2
    return p


@lru_cache(maxsize=None)
def ntt3_tables(n: int, qs: tuple[int, ...]) -> dict:
    """Raw integer tables of `mxu3_tables` (ntt_mxu3.py:63-160), as int64
    numpy arrays; every entry is a power of ψ (times n⁻¹ in W1i)."""
    A, B, r = _split3(n)
    Br = B * r
    two_n = 2 * n
    a_ = np.arange(A, dtype=np.int64)
    b_ = np.arange(B, dtype=np.int64)
    m_ = np.arange(Br, dtype=np.int64)
    k3_ = np.arange(r, dtype=np.int64)
    # ψ-exponents of each table (mod 2n); the inverses negate them
    e_w1 = (2 * Br * np.outer(a_, a_) + Br * a_[None, :]) % two_n       # [k1, j1]
    e_w1i = (-2 * Br * np.outer(a_, a_) - Br * a_[:, None]) % two_n     # [j1, k1]
    e_w2 = (2 * A * r * np.outer(b_, b_)) % two_n
    e_t = (2 * np.outer(a_, m_) + m_[None, :]) % two_n                   # [k1, m]
    e_tb = (2 * A * np.outer(k3_, b_)) % two_n                           # [k3, j2]
    e_ur = (2 * A * B * np.outer(k3_, k3_)) % two_n                      # [k3, j3]
    tabs = {k: [] for k in ("W1", "W1i", "W2", "W2i", "T", "Ti", "tb", "tbi",
                            "urth", "urth_i")}
    for q in qs:
        p = psi_powers(n, q)
        neg = lambda e: p[(two_n - e) % two_n]
        n_inv = pow(n, -1, q)
        tabs["W1"].append(p[e_w1])
        tabs["W1i"].append(p[e_w1i] * n_inv % q)
        tabs["W2"].append(p[e_w2])
        tabs["W2i"].append(neg(e_w2))
        tabs["T"].append(p[e_t])
        tabs["Ti"].append(neg(e_t))
        tabs["tb"].append(p[e_tb])
        tabs["tbi"].append(neg(e_tb))
        tabs["urth"].append(p[e_ur])
        tabs["urth_i"].append(neg(e_ur))
    out = {k: np.stack(v) for k, v in tabs.items()}
    out.update(A=A, B=B, r=r)
    return out


@lru_cache(maxsize=None)
def _device_tables(n: int, qs: tuple[int, ...], device: str) -> dict:
    t = ntt3_tables(n, qs)
    out = {k: (torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v)
           for k, v in t.items()}
    out["q"] = torch.tensor(qs, dtype=torch.int64, device=device)[:, None, None]
    out["r16"] = torch.tensor([(1 << 16) % q for q in qs], dtype=torch.int64,
                              device=device)[:, None, None]
    out["r32"] = torch.tensor([(1 << 32) % q for q in qs], dtype=torch.int64,
                              device=device)[:, None, None]
    return out


def _tables(n, qs, device) -> dict:
    return _device_tables(n, tuple(qs), str(torch.device(device)))


def _matmul_mod(x, W, t):
    """out[..., l, r, a] = Σ_k W[l, a, k]·x[..., l, r, k] mod q_l for any
    uint32 x [..., L or 1, R, K] and canonical W [L, Ko, K]."""
    xs = torch.stack([x & 0xFFFF, x >> 16]).to(torch.float64)
    wt = W.transpose(-1, -2)
    ws = torch.stack([wt & 0xFFFF, wt >> 16]).to(torch.float64)
    ws = ws.view(1, 2, *([1] * (x.dim() - 3)), *wt.shape)
    s = torch.matmul(xs.unsqueeze(1), ws).to(torch.int64)   # [2, 2, ..., R, Ko]
    q = t["q"]
    mid = (s[0, 1] + s[1, 0]) % q
    return (s[0, 0] % q + mid * t["r16"] + s[1, 1] % q * t["r32"]) % q


def _dft_r(blocks, roots, q):
    """Radix-r DFT over r [..., B] blocks with the [L, r, r] root table."""
    r = len(blocks)
    if r == 1:
        return blocks
    return [
        sum(roots[:, k3, j3][:, None, None] * blocks[j3] % q
            for j3 in range(r)) % q
        for k3 in range(r)
    ]


def _forward_tail(y, t):
    """Big twiddle, radix-r DFT, small twiddle and stage-3 DFT_B of the
    stage-1 output y [..., L, A, B·r] (k1 rows, m = j3·B + j2 lanes)."""
    B, r = t["B"], t["r"]
    q = t["q"]
    y = y * t["T"] % q
    blocks = _dft_r([y[..., k * B:(k + 1) * B] for k in range(r)], t["urth"], q)
    outs = []
    for k3, b in enumerate(blocks):
        if k3 > 0:
            b = b * t["tb"][:, k3][:, None, :] % q
        outs.append(_matmul_mod(b, t["W2"], t))
    return torch.cat(outs, dim=-1)


def ntt3(x: torch.Tensor, n: int, qs: tuple[int, ...]) -> torch.Tensor:
    """Forward negacyclic NTT, [..., L, n] natural order → 3-factor slot
    order (`ntt_mxu3`, ntt_mxu3.py:190); any uint32 input, canonical output."""
    t = _tables(n, qs, x.device)
    A, Br = t["A"], t["B"] * t["r"]
    lead, L = x.shape[:-2], x.shape[-2]
    xg = x.reshape(*lead, L, A, Br).transpose(-1, -2)        # [..., L, m, j1]
    y = _matmul_mod(xg, t["W1"], t).transpose(-1, -2)         # [..., L, k1, m]
    return _forward_tail(y, t).reshape(*lead, L, n)


def ntt3_bcast(x: torch.Tensor, n: int, qs: tuple[int, ...]) -> torch.Tensor:
    """Forward NTT of each row of x [..., D, n] under every limb's tables
    → [..., D, L, n] (`ntt_mxu3_bcast`, ntt_mxu3.py:252); rows may be
    unreduced uint32."""
    t = _tables(n, qs, x.device)
    A, Br = t["A"], t["B"] * t["r"]
    lead = x.shape[:-1]
    xg = x.reshape(*lead, A, Br).transpose(-1, -2).unsqueeze(-3)  # [..., D, 1, m, j1]
    y = _matmul_mod(xg, t["W1"], t).transpose(-1, -2)             # [..., D, L, k1, m]
    return _forward_tail(y, t).reshape(*lead, len(qs), n)


def intt3(x: torch.Tensor, n: int, qs: tuple[int, ...]) -> torch.Tensor:
    """Inverse of ntt3 (`intt_mxu3`, ntt_mxu3.py:222): slot order in,
    natural order out."""
    t = _tables(n, qs, x.device)
    A, B, r = t["A"], t["B"], t["r"]
    q = t["q"]
    lead, L = x.shape[:-2], x.shape[-2]
    xg = x.reshape(*lead, L, A, B * r)
    blocks = []
    for k3 in range(r):
        b = _matmul_mod(xg[..., k3 * B:(k3 + 1) * B], t["W2i"], t)
        if k3 > 0:
            b = b * t["tbi"][:, k3][:, None, :] % q
        blocks.append(b)
    y = torch.cat(_dft_r(blocks, t["urth_i"], q), dim=-1)
    y = (y * t["Ti"] % q).transpose(-1, -2)                   # [..., L, m, k1]
    z = _matmul_mod(y, t["W1i"], t)                           # [..., L, m, j1]
    return z.transpose(-1, -2).reshape(*lead, L, n)
