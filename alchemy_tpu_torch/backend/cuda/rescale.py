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
every keep limb q_j, the Garner digits and sign terms of the K dropped
limbs, their base extension, the centered correction δ, the exact division
by P, and the forward NTT, in either slot order; in the hybrid product it
also adds c0 and c1 as it stores.

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
Each wrapper runs, from entry to return, inside the launch span
`launch.<kernel>` (the name `LAUNCHES` counts; `utils.profiling`), whose
attribute `entry` names the C entry point it calls.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda import build
from alchemy_tpu_torch.backend.cuda.mul_relin import (
    GARNER_MAX_DIGITS,
    GARNER_WORDS,
    _check,
    _device_tables,
    _kernel_device,
    _ptr,
    _with_shoup,
    count_launch,
    garner_consts,
    plain_transforms,
)
from alchemy_tpu_torch.backend.modarith import (
    _add_mod,
    _garner_tables,
    _sign_terms,
    _sub_mod,
    extend_digits,
    garner_digits,
    narrow,
    qcol,
    widen,
)
from alchemy_tpu_torch.backend.ntt import intt_vpu, ntt_vpu
from alchemy_tpu_torch.backend.ntt2 import intt2, ntt2
from alchemy_tpu_torch.backend.ntt3 import intt3, ntt3
from alchemy_tpu_torch.utils.profiling import span

#: launches of each kernel since the last `reset_launches()`
LAUNCHES = {"intt_grid": 0, "ntt_grid": 0, "rescale_fwd": 0, "intt2_grid": 0, "ntt2_grid": 0,
            "intt_vpu_grid": 0, "ntt_vpu_grid": 0}
#: the launch span of each kernel (`utils.profiling`)
_LAUNCH_SPANS = {name: f"launch.{name}" for name in LAUNCHES}
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


@lru_cache(maxsize=None)
def drop_consts(drop: tuple[int, ...], zp: int) -> np.ndarray:
    """The words of rescale.cu `DropConsts`, uint32, which kernel 7 takes by
    value: `garner_consts(drop)` padded to GARNER_MAX_DIGITS rows, the
    mixed-radix digits of P//2 and [π_k]_zp (each padded to
    GARNER_MAX_DIGITS), zp, P mod zp and P⁻¹ mod zp (`_sign_terms`). zp
    must be a power of two ≤ 2^16."""
    if zp & (zp - 1) or not 0 < zp <= 1 << 16:
        raise ValueError(f"zp={zp}: kernel 7 takes a power-of-two zp <= 2^16")
    rows = np.zeros((GARNER_MAX_DIGITS, GARNER_WORDS), dtype=np.uint32)
    rows[:len(drop)] = garner_consts(drop)
    P, pi = math.prod(drop), _garner_tables(drop)[0]
    half, h = np.zeros(GARNER_MAX_DIGITS, dtype=np.uint32), P // 2
    for k, g in enumerate(drop):
        half[k], h = h % g, h // g
    pi_zp = np.zeros(GARNER_MAX_DIGITS, dtype=np.uint32)
    pi_zp[:len(drop)] = [x % zp for x in pi]
    p_inv_zp = pow(P % zp, -1, zp) if zp > 1 else 0
    return np.concatenate([rows.ravel(), half, pi_zp, [zp, P % zp, p_inv_zp]]).astype(np.uint32)


def rescale_fwd_plain(n: int, keep: tuple[int, ...], drop: tuple[int, ...], zp: int,
                      coeff, order: str = "pallas", c01=None) -> torch.Tensor:
    """Plain kernel 7: → [G, L, n] int32, or [G/2, 2, L, n] with c01 (see
    `rescale_fwd`)."""
    ntt = plain_transforms(order)[0]
    dev, L, P = coeff.device, len(keep), math.prod(drop)
    q = qcol(keep, dev)
    p_mod = torch.tensor([P % qj for qj in keep], device=dev)[:, None]
    p_inv = torch.tensor([pow(P % qj, -1, qj) for qj in keep], device=dev)[:, None]
    xs = garner_digits(widen(coeff[:, L:]), drop)
    is_neg, t, t_neg = _sign_terms(xs, drop, zp)
    v = extend_digits(xs, drop, keep)                                     # [G, L, n]
    v = torch.where(is_neg[:, None, :], _sub_mod(v, p_mod, q), v)
    tw = t[:, None, :]
    tc = torch.where(t_neg[:, None, :], q - (zp - tw), tw)
    delta = _add_mod(v, tc * p_mod % q, q)
    diff = _sub_mod(widen(coeff[:, :L]), delta, q)
    out = ntt(diff * p_inv % q, n, keep)
    if c01 is not None:
        r01 = out.reshape(2, -1, L, n)
        out = torch.stack([_add_mod(widen(c), r, q) for c, r in zip(c01, r01)], dim=1)
    return narrow(out)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _grid(name: str, entry: str, order: str, n: int, qs: tuple[int, ...], x: torch.Tensor,
          plain) -> torch.Tensor:
    """Launch C entry point `entry` ("intt_grid" or "ntt_grid") with the
    slot table of `order`, counted as kernel `name`."""
    with span(_LAUNCH_SPANS[name], entry=entry):
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
                coeff: torch.Tensor, order: str = "pallas", c01=None) -> torch.Tensor:
    """Kernel 7: canonical coefficients coeff [G, L + K, n] (int32) over
    keep + drop → the rows rescaled by P = ∏ drop [G, L, n] over keep, NTT
    domain in slot `order`; the Garner digits and sign terms of the K
    dropped rows (`she.hybrid.rescale_joint`) are computed in the kernel's
    load. With c01 = (c0, c1), each [G/2, L, n] in slot order, → [G/2, 2,
    L, n]: row g < G/2 plus c0[g] at [g, 0], row G/2 + g plus c1[g] at
    [g, 1] (the hybrid product's add-back). zp must be a power of two ≤
    2^16, and K ≤ GARNER_MAX_DIGITS on the card."""
    with span("launch.rescale_fwd", entry="rescale_fwd"):
        keep, drop = tuple(keep), tuple(drop)
        L, K = len(keep), len(drop)
        G, dev = coeff.shape[0], coeff.device
        _check("coeff", coeff, (G, L + K, n), dev)
        if c01 is not None:
            if G % 2:
                raise ValueError(f"coeff: {G} rows, want the t0 and t1 rows of each ciphertext")
            for name, c in zip(("c0", "c1"), c01):
                _check(name, c, (G // 2, L, n), dev)
        if dev.type == "cpu":
            return rescale_fwd_plain(n, keep, drop, zp, coeff, order, c01)
        _kernel_device(n, dev)
        words = drop_consts(drop, zp)
        tab = _device_tables(n, keep, order, str(dev))
        c0, c1 = (None, None) if c01 is None else c01
        out = torch.empty((G, L, n) if c01 is None else (G // 2, 2, L, n), dtype=torch.int32,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(build.library().rescale_fwd(
            coeff.data_ptr(), _ptr(c0), _ptr(c1), _device_consts(keep, drop, str(dev)).data_ptr(),
            words.ctypes.data, out.data_ptr(), tab["limbs"].data_ptr(), tab["fwd"].data_ptr(),
            tab["slot_own"].data_ptr(), G, L, K, n.bit_length() - 1, stream), "rescale_fwd")
        count_launch(LAUNCHES, LAUNCHES_BY_SHAPE, "rescale_fwd", G, L, K, n)
        return out
