"""Kernels 5–9: the standalone per-limb NTTs in both slot orders and the
forward half of the joint rescale by P — wrappers, plain versions and launch
counters.

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
forward NTT, in either slot order.

Kernels 8 and 9, `ntt2_grid` and `intt2_grid` (replace `alchemy_tpu/backend/
pallas/ntt_pallas.py:211 _fwd_kernel` and `:232 _inv_kernel`, wrappers
`ntt_pallas` :289 and `intt_pallas` :314): kernels 6 and 5 in the 2-factor
slot order of `backend/ntt2.py` (`FastParams(impl="mxu")`). The TPU computes
them as a 4-step NTT of bf16 digit-plane matmuls on its matrix unit; here
they are the split radix-2 NTT of kernels 5 and 6 run with the 2-factor
slot table: the same values x(ψ^{2K+1}), in the same slots.

`ntt_vpu_grid` and `intt_vpu_grid`: kernels 6 and 5 with the radix-2 slot
table of `backend/ntt.py` (`FastParams(impl="vpu")`), the counterparts of
`alchemy_tpu/backend/ntt.py:149 ntt_negacyclic` and `:173 intt_negacyclic`,
which the JAX package computes in jnp, with no Pallas kernel.

Same structure as kernels A, B and 4 (`mul_relin.py`): two blocks per (limb,
row), each with half of the limb in shared memory (n ≤ 2^16); every kernel
runs B's register-blocked passes (5 and 9 their inverse mirror) and takes
each block's slots in slot order through `slot_own`; on grids that fit one
wave 5, 6, 8 and 9 spread a limb over four blocks, and kernel 7 at
n ≤ 2^15 splits its prologue between the two blocks of a cluster
(`csrc/rescale.cu` says why).
Each wrapper takes the plain PyTorch version for CPU tensors only; for CUDA
tensors it launches its kernel or raises.
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
    count_launch,
    plain_transforms,
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
from alchemy_tpu_torch.backend.ntt import intt_vpu, ntt_vpu
from alchemy_tpu_torch.backend.ntt2 import intt2, ntt2
from alchemy_tpu_torch.backend.ntt3 import intt3, ntt3

#: launches of each kernel since the last `reset_launches()`
LAUNCHES = {"intt_grid": 0, "ntt_grid": 0, "rescale_fwd": 0, "intt2_grid": 0, "ntt2_grid": 0,
            "intt_vpu_grid": 0, "ntt_vpu_grid": 0}
#: launches of each kernel by shape since the last `reset_launches()`:
#: {(name, G, T, n): count} for the standalone transforms (5, 6, 8, 9 and the
#: vpu order's) and
#: {("rescale_fwd", G, L, K, n): count} for kernel 7
LAUNCHES_BY_SHAPE: dict[tuple, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()


# ---------------------------------------------------------------------------
# plain versions (exact int64)
# ---------------------------------------------------------------------------


def intt3_grid_plain(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Plain kernel 5: [G, T, n] int32 → [G, T, n] int32."""
    return narrow(intt3(widen(x), n, qs))


def ntt3_grid_plain(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Plain kernel 6: [G, T, n] int32 → [G, T, n] int32."""
    return narrow(ntt3(widen(x), n, qs))


def intt2_grid_plain(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Plain kernel 9: [G, T, n] int32 → [G, T, n] int32."""
    return narrow(intt2(widen(x), n, qs))


def ntt2_grid_plain(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Plain kernel 8: [G, T, n] int32 → [G, T, n] int32."""
    return narrow(ntt2(widen(x), n, qs))


def intt_vpu_grid_plain(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Plain kernel 5 in the vpu order: [G, T, n] int32 → [G, T, n] int32."""
    return narrow(intt_vpu(widen(x), n, qs))


def ntt_vpu_grid_plain(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Plain kernel 6 in the vpu order: [G, T, n] int32 → [G, T, n] int32."""
    return narrow(ntt_vpu(widen(x), n, qs))


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
                      coeff, xs, is_neg, t, t_neg, order: str = "pallas") -> torch.Tensor:
    """Plain kernel 7: → [G, L, n] int32 (see `rescale_fwd`)."""
    ntt = plain_transforms(order)[0]
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
    return narrow(ntt(diff * p_inv % q, n, keep))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _grid(name: str, entry: str, order: str, n: int, qs: tuple[int, ...], x: torch.Tensor,
          plain) -> torch.Tensor:
    """Launch C entry point `entry` ("intt_grid" or "ntt_grid") with the
    slot table of `order`, counted as kernel `name`."""
    qs = tuple(qs)
    G, T, dev = x.shape[0], len(qs), x.device
    _check("x", x, (G, T, n), dev)
    if dev.type == "cpu":
        return plain(n, qs, x)
    _kernel_device(n, dev)
    t = _device_tables(n, qs, order, str(dev))
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    twiddles = t["inv"] if entry == "intt_grid" else t["fwd"]
    build.check(getattr(build.library(), entry)(
        x.data_ptr(), out.data_ptr(), t["limbs"].data_ptr(), twiddles.data_ptr(),
        t["grid_own"].data_ptr(), G, T, n.bit_length() - 1, stream), name)
    count_launch(LAUNCHES, LAUNCHES_BY_SHAPE, name, G, T, n)
    return out


def intt3_grid(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Kernel 5: rows x [G, T, n] (int32, slot order, any uint32) → natural-
    order coefficients [G, T, n], canonical."""
    return _grid("intt_grid", "intt_grid", "pallas", n, qs, x, intt3_grid_plain)


def ntt3_grid(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Kernel 6: coefficient rows x [G, T, n] (int32, any uint32) → the
    3-factor slot order [G, T, n], canonical."""
    return _grid("ntt_grid", "ntt_grid", "pallas", n, qs, x, ntt3_grid_plain)


def intt2_grid(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Kernel 9: rows x [G, T, n] (int32, 2-factor slot order, any uint32) →
    natural-order coefficients [G, T, n], canonical."""
    return _grid("intt2_grid", "intt_grid", "mxu", n, qs, x, intt2_grid_plain)


def ntt2_grid(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Kernel 8: coefficient rows x [G, T, n] (int32, any uint32) → the
    2-factor slot order [G, T, n], canonical."""
    return _grid("ntt2_grid", "ntt_grid", "mxu", n, qs, x, ntt2_grid_plain)


def intt_vpu_grid(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Kernel 5 in the vpu order: rows x [G, T, n] (int32, bit-reversed slot
    order, any uint32) → natural-order coefficients [G, T, n], canonical."""
    return _grid("intt_vpu_grid", "intt_grid", "vpu", n, qs, x, intt_vpu_grid_plain)


def ntt_vpu_grid(n: int, qs: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Kernel 6 in the vpu order: coefficient rows x [G, T, n] (int32, any
    uint32) → the bit-reversed slot order [G, T, n], canonical."""
    return _grid("ntt_vpu_grid", "ntt_grid", "vpu", n, qs, x, ntt_vpu_grid_plain)


#: (forward, inverse) standalone transforms of each slot order, kernels and plain
_GRID = {"pallas": ((ntt3_grid, intt3_grid), (ntt3_grid_plain, intt3_grid_plain)),
         "mxu": ((ntt2_grid, intt2_grid), (ntt2_grid_plain, intt2_grid_plain)),
         "vpu": ((ntt_vpu_grid, intt_vpu_grid), (ntt_vpu_grid_plain, intt_vpu_grid_plain))}


def grid_transforms(order: str, plain: bool = False):
    """(forward, inverse) standalone transforms of a slot order: kernels 6
    and 5 ("pallas"), 8 and 9 ("mxu"), 6 and 5 with the radix-2 table
    ("vpu"), or their plain versions."""
    plain_transforms(order)
    return _GRID[order][plain]


@lru_cache(maxsize=None)
def _device_consts(keep: tuple[int, ...], drop: tuple[int, ...], device: str) -> torch.Tensor:
    return torch.from_numpy(rescale_consts(keep, drop).view(np.int32)).to(device)


def rescale_fwd(n: int, keep: tuple[int, ...], drop: tuple[int, ...], zp: int,
                coeff: torch.Tensor, xs: torch.Tensor, is_neg: torch.Tensor,
                t: torch.Tensor, t_neg: torch.Tensor, order: str = "pallas") -> torch.Tensor:
    """Kernel 7: coefficients coeff [G, L + K, n] over keep + drop (rows
    j < L are read), the Garner digits xs [G, K, n] of the K dropped rows
    and the sign terms is_neg, t, t_neg [G, n] of `she.hybrid.rescale_joint`
    (all int32) → the rescaled rows [G, L, n] over keep, NTT domain in slot
    `order`."""
    keep, drop = tuple(keep), tuple(drop)
    L, K = len(keep), len(drop)
    G, dev = coeff.shape[0], coeff.device
    _check("coeff", coeff, (G, L + K, n), dev)
    _check("xs", xs, (G, K, n), dev)
    for name, f in (("is_neg", is_neg), ("t", t), ("t_neg", t_neg)):
        _check(name, f, (G, n), dev)
    if dev.type == "cpu":
        return rescale_fwd_plain(n, keep, drop, zp, coeff, xs, is_neg, t, t_neg, order)
    _kernel_device(n, dev)
    tab = _device_tables(n, keep, order, str(dev))
    out = torch.empty((G, L, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library().rescale_fwd(
        coeff.data_ptr(), xs.data_ptr(), is_neg.data_ptr(), t.data_ptr(), t_neg.data_ptr(),
        _device_consts(keep, drop, str(dev)).data_ptr(), out.data_ptr(),
        tab["limbs"].data_ptr(), tab["fwd"].data_ptr(), tab["slot_own"].data_ptr(),
        G, L, K, zp, n.bit_length() - 1, stream), "rescale_fwd")
    count_launch(LAUNCHES, LAUNCHES_BY_SHAPE, "rescale_fwd", G, L, K, n)
    return out
