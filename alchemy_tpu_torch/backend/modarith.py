"""Exact mod-q lane arithmetic on uint32 values held in int64 tensors.

Port of the lane helpers of `alchemy_tpu/backend/xla.py:33-134`. The JAX
versions compute on uint32 lanes with 16-bit splits because the TPU has no
64-bit lanes; here every value is a uint32 held in an int64 tensor, so a
product of a uint32 and a value below 2^31 is exact, and each helper
returns what its JAX counterpart returns for every uint32 input (wrapping
sums are masked to 32 bits as the uint32 lanes wrap).

Residues are stored as int32 tensors (their uint32 bit pattern): `widen`
and `narrow` convert between that storage and the int64 working form.

Also the exact mixed-radix (Garner) lifting and base extension of hybrid
key-switching (`alchemy_tpu/she/hybrid.py:78-125`), shared by `she/hybrid.py`
and the plain versions of kernels 4 and 7.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 storage (uint32 bit pattern) → int64 holding the uint32 value."""
    return x.to(torch.int64) & _M32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value → int32 storage of its bit pattern."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _split(a):
    return a & _M16, a >> 16


def mulhi_u32(a, b):
    """High 32 bits of the 64-bit product of two uint32 values."""
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    mid = a0 * b1 + a1 * b0 + ((a0 * b0) >> 16)
    return a1 * b1 + (mid >> 16)


def mul_u32_hilo(a, b):
    """(high, low) 32-bit halves of the 64-bit product a·b."""
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    lo = (((a0 * b1 + a1 * b0) << 16) + a0 * b0) & _M32
    return mulhi_u32(a, b), lo


def _cond_sub(r, q):
    return torch.where(r >= q, r - q, r)


def shoup_const(w: int, q: int) -> int:
    """⌊w·2^32/q⌋ as a uint32 constant (requires w < q)."""
    return (int(w) << 32) // int(q)


def mulmod_shoup(a, w, ws, q):
    """a·w mod q for constant w with Shoup companion ws; exact for any
    uint32 a. w, ws and q may be tensors broadcastable against a."""
    hi = mulhi_u32(a, ws)
    r = (a * w - hi * q) & _M32
    return _cond_sub(r, q)


@lru_cache(maxsize=None)
def _qcol_cached(qs: tuple[int, ...], device: str) -> torch.Tensor:
    return torch.tensor(qs, dtype=torch.int64, device=device)[:, None]


def qcol(qs: tuple[int, ...], device) -> torch.Tensor:
    """The moduli as an int64 [L, 1] column on `device`."""
    return _qcol_cached(tuple(qs), str(torch.device(device)))


def mulmod(a, b, qs: tuple[int, ...]):
    """a·b mod q per limb (limb axis second-to-last), for any uint32 a, b
    and q < 2^31, as `alchemy_tpu.backend.xla.mulmod` returns it."""
    q = qcol(qs, a.device)
    return (a % q) * (b % q) % q


def _add_mod(a, b, q):
    return _cond_sub((a + b) & _M32, q)


def _sub_mod(a, b, q):
    return torch.where(a >= b, a - b, (a + q - b) & _M32)


def _neg_mod(a, q):
    return torch.where(a == 0, a, (q - a) & _M32)


@lru_cache(maxsize=None)
def _garner_tables(chain: tuple[int, ...]):
    """pi[k] = ∏_{j<k} chain[j] (exact ints) and inv[k] = pi[k]⁻¹ mod
    chain[k] (hybrid.py:79)."""
    pi = [1]
    for g in chain[:-1]:
        pi.append(pi[-1] * g)
    inv = [1] + [pow(pi[k] % chain[k], -1, chain[k]) for k in range(1, len(chain))]
    return tuple(pi), tuple(inv)


def garner_digits(res, chain: tuple[int, ...]) -> list:
    """Mixed-radix digits x_k of the value V ∈ [0, ∏chain) whose residue mod
    chain[k] is res[..., k, :]: V = Σ_k x_k·π_k with 0 ≤ x_k < chain[k]
    (hybrid.py:89). int64 in and out, exact and integer-only."""
    pi, inv = _garner_tables(tuple(chain))
    xs = [res[..., 0, :]]
    for k in range(1, len(chain)):
        g = chain[k]
        acc = xs[0] % g                          # V_{k-1} mod g_k
        for j in range(1, k):
            acc = (acc + xs[j] * (pi[j] % g)) % g
        xs.append(_sub_mod(res[..., k, :], acc, g) * inv[k] % g)
    return xs


def _sign_terms(xs: list, drop: tuple[int, ...], zp: int):
    """For the dropped part V = Σ_k x_k·π_k of each coefficient: is_neg
    (V > P//2, a lexicographic compare of the digits) and the centered
    t ≡ (−V_c)·P⁻¹ (mod zp) with t_neg = t > zp//2 (hybrid.py:175-197):
    the plain form of kernel 7's sign terms and of the mesh path's rescale."""
    P = math.prod(drop)
    pi, _ = _garner_tables(drop)
    hd, h = [], P // 2
    for g in drop:
        hd.append(h % g)
        h //= g
    gt = torch.zeros_like(xs[0], dtype=torch.bool)
    eq = torch.ones_like(xs[0], dtype=torch.bool)
    for k in range(len(drop) - 1, -1, -1):
        gt = gt | (eq & (xs[k] > hd[k]))
        eq = eq & (xs[k] == hd[k])
    mask = zp - 1
    vz = torch.zeros_like(xs[0])
    for k, x in enumerate(xs):
        vz = (vz + (x & mask) * (pi[k] % zp)) & mask
    vz = torch.where(gt, (vz + zp - P % zp) & mask, vz)
    inv_p = pow(P % zp, -1, zp) if zp > 1 else 0
    t = (((zp - vz) & mask) * inv_p) & mask
    return gt, t, t > zp // 2


@lru_cache(maxsize=None)
def _extend_consts(chain: tuple[int, ...], targets: tuple[int, ...]):
    """[K, T] int64 numpy: [π_k]_{q_t} (hybrid.py:106; exact int64 products
    need no Shoup companions)."""
    pi, _ = _garner_tables(chain)
    return np.array([[p % q for q in targets] for p in pi], dtype=np.int64)


@lru_cache(maxsize=None)
def _extend_weights(chain: tuple[int, ...], targets: tuple[int, ...], device: str):
    """`_extend_consts` on `device`, uploaded once (a captured CUDA graph may
    not copy from the host)."""
    return torch.from_numpy(_extend_consts(chain, targets)).to(device)


def extend_digits(xs, chain: tuple[int, ...], targets: tuple[int, ...]):
    """Residues of V = Σ_k x_k·π_k modulo every target limb: K digit
    tensors [..., n] (int64, any uint32) → [..., T, n] (hybrid.py:117)."""
    dev = xs[0].device
    w = _extend_weights(tuple(chain), tuple(targets), str(dev))
    q = qcol(targets, dev)
    out = None
    for k, x in enumerate(xs):
        term = x[..., None, :] * w[k][:, None] % q
        out = term if out is None else _add_mod(out, term, q)
    return out
