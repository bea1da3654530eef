"""Exact mod-q lane arithmetic on uint32 values held in int64 tensors.

Port of the lane helpers of `alchemy_tpu/backend/xla.py:33-134`. The JAX
versions compute on uint32 lanes with 16-bit splits because the TPU has no
64-bit lanes; here every value is a uint32 held in an int64 tensor, so a
product of a uint32 and a value below 2^31 is exact, and each helper
returns what its JAX counterpart returns for every uint32 input (wrapping
sums are masked to 32 bits as the uint32 lanes wrap).

Residues are stored as int32 tensors (their uint32 bit pattern): `widen`
and `narrow` convert between that storage and the int64 working form.
"""

from __future__ import annotations

from functools import lru_cache

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
