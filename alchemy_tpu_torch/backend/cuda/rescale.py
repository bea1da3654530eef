"""Kernels 5, 6 and 7: the standalone per-limb NTTs and the forward half of
the joint rescale by P — wrappers, plain versions and launch counters.

Kernel 5, `intt3_grid` (replaces `alchemy_tpu/backend/pallas/
rescale_pallas.py:52 _intt_grid_kernel`, "kernel C", wrapper
`intt3_grid_pallas` :109): rows [G, T, n] in the 3-factor slot order →
natural-order coefficients, per limb.

Kernel 6, `ntt3_grid` (replaces `rescale_pallas.py:142 _ntt_grid_kernel`,
wrapper `ntt3_grid_pallas` :180): the forward transform, any uint32 input.

Kernel 7, `rescale_fwd` (replaces `rescale_pallas.py:206
_rescale_fwd_kernel`, "kernel D", wrapper `rescale_joint_pallas` :306): for
every keep limb q_j, the base extension of the K dropped limbs' Garner
digits, the centered correction δ, the exact division by P, and the
forward NTT.

Same structure and bounds as kernels A, B and 4 (`mul_relin.py`): kernels 5
and 6 split each limb over two blocks, each with half of it in shared
memory (n ≤ 2^16); kernel 7 keeps one block per (limb, row) with the whole
limb (n ≤ 2^15) and raises at 2^16. Each wrapper
takes the plain PyTorch version for CPU tensors only; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda import build
from alchemy_tpu_torch.backend.cuda.mul_relin import (
    _check,
    _device_tables,
    _kernel_device,
    _with_shoup,
)
from alchemy_tpu_torch.backend.modarith import (
    _add_mod,
    _garner_tables,
    _sub_mod,
    extend_digits,
    narrow,
    qcol,
    widen,
)
from alchemy_tpu_torch.backend.ntt3 import intt3, ntt3

#: launches of each kernel since the last `reset_launches()`
LAUNCHES = {"intt_grid": 0, "ntt_grid": 0, "rescale_fwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (exact int64)
# ---------------------------------------------------------------------------


def intt3_grid_plain(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Plain kernel 5: [G, T, n] int32 → [G, T, n] int32."""
    return narrow(intt3(widen(x), n, qs))


def ntt3_grid_plain(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Plain kernel 6: [G, T, n] int32 → [G, T, n] int32."""
    return narrow(ntt3(widen(x), n, qs))


@lru_cache(maxsize=None)
def rescale_consts(keep: tuple[int, ...], drop: tuple[int, ...]) -> np.ndarray:
    """[L, 4 + 2K] uint32 per keep limb q_j: P mod q_j, its Shoup companion,
    P⁻¹ mod q_j, its companion, then [π_k]_{q_j} for the K dropped limbs'
    Garner digits and their companions (`_rescale_consts`,
    rescale_pallas.py:283)."""
    P, pis = math.prod(drop), _garner_tables(drop)[0]
    rows = []
    for q in keep:
        pm = P % q
        sc = _with_shoup(np.array([pm, pow(pm, -1, q)]), q)       # [2, 2]
        ext = _with_shoup(np.array([pi % q for pi in pis]), q)     # [2, K]
        rows.append(np.concatenate([sc.T.reshape(-1), ext.reshape(-1)]))
    return np.stack(rows).astype(np.uint32)


def rescale_fwd_plain(n: int, keep: tuple[int, ...], drop: tuple[int, ...], zp: int,
                      coeff, xs, is_neg, t, t_neg) -> torch.Tensor:
    """Plain kernel 7: → [G, L, n] int32 (see `rescale_fwd`)."""
    dev, L, P = coeff.device, len(keep), math.prod(drop)
    q = qcol(keep, dev)
    p_mod = torch.tensor([P % qj for qj in keep], device=dev)[:, None]
    p_inv = torch.tensor([pow(P % qj, -1, qj) for qj in keep], device=dev)[:, None]
    xw = widen(xs)
    v = extend_digits([xw[:, k] for k in range(len(drop))], drop, keep)     # [G, L, n]
    v = torch.where(is_neg[:, None, :] != 0, _sub_mod(v, p_mod, q), v)
    tw = widen(t)[:, None, :]
    tc = torch.where(t_neg[:, None, :] != 0, q - (zp - tw), tw)
    delta = _add_mod(v, tc * p_mod % q, q)
    diff = _sub_mod(widen(coeff[:, :L]), delta, q)
    return narrow(ntt3(diff * p_inv % q, n, keep))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _grid(name: str, twiddles: str, n: int, qs: tuple[int, ...], x: torch.Tensor,
          plain) -> torch.Tensor:
    qs = tuple(qs)
    G, T, dev = x.shape[0], len(qs), x.device
    _check("x", x, (G, T, n), dev)
    if dev.type == "cpu":
        return plain(n, qs, x)
    _kernel_device(n, dev)
    t = _device_tables(n, qs, str(dev))
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(getattr(build.library(), name)(
        x.data_ptr(), out.data_ptr(), t["limbs"].data_ptr(), t[twiddles].data_ptr(),
        t["slot_inv"].data_ptr(), G, T, n.bit_length() - 1, stream), name)
    LAUNCHES[name] += 1
    return out


def intt3_grid(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Kernel 5: rows x [G, T, n] (int32, slot order, any uint32) → natural-
    order coefficients [G, T, n], canonical."""
    return _grid("intt_grid", "inv", n, qs, x, intt3_grid_plain)


def ntt3_grid(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Kernel 6: coefficient rows x [G, T, n] (int32, any uint32) → the
    3-factor slot order [G, T, n], canonical."""
    return _grid("ntt_grid", "fwd", n, qs, x, ntt3_grid_plain)


@lru_cache(maxsize=None)
def _device_consts(keep: tuple[int, ...], drop: tuple[int, ...], device: str) -> torch.Tensor:
    return torch.from_numpy(rescale_consts(keep, drop).view(np.int32)).to(device)


def rescale_fwd(n: int, keep: tuple[int, ...], drop: tuple[int, ...], zp: int,
                coeff: torch.Tensor, xs: torch.Tensor, is_neg: torch.Tensor,
                t: torch.Tensor, t_neg: torch.Tensor) -> torch.Tensor:
    """Kernel 7: coefficients coeff [G, L + K, n] over keep + drop (rows
    j < L are read), the Garner digits xs [G, K, n] of the K dropped rows
    and the sign terms is_neg, t, t_neg [G, n] of `she.hybrid.rescale_joint`
    (all int32) → the rescaled rows [G, L, n] over keep, NTT domain."""
    keep, drop = tuple(keep), tuple(drop)
    L, K = len(keep), len(drop)
    G, dev = coeff.shape[0], coeff.device
    _check("coeff", coeff, (G, L + K, n), dev)
    _check("xs", xs, (G, K, n), dev)
    for name, f in (("is_neg", is_neg), ("t", t), ("t_neg", t_neg)):
        _check(name, f, (G, n), dev)
    if dev.type == "cpu":
        return rescale_fwd_plain(n, keep, drop, zp, coeff, xs, is_neg, t, t_neg)
    _kernel_device(n, dev, split=False)
    tab = _device_tables(n, keep, str(dev))
    out = torch.empty((G, L, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library().rescale_fwd(
        coeff.data_ptr(), xs.data_ptr(), is_neg.data_ptr(), t.data_ptr(), t_neg.data_ptr(),
        _device_consts(keep, drop, str(dev)).data_ptr(), out.data_ptr(),
        tab["limbs"].data_ptr(), tab["fwd"].data_ptr(), tab["slot_ct"].data_ptr(),
        G, L, K, zp, n.bit_length() - 1, stream), "rescale_fwd")
    LAUNCHES["rescale_fwd"] += 1
    return out
