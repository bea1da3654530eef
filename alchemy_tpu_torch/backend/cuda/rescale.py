"""Kernels 5–9: the standalone per-limb NTTs in every slot order and the
forward half of the joint rescale by P — wrappers and plain versions.

Kernel 5, `grid_transforms("pallas")[1]` (replaces `alchemy_tpu/backend/
pallas/rescale_pallas.py:52 _intt_grid_kernel`, "kernel C", wrapper
`intt3_grid_pallas` :109): rows [G, T, n] in the 3-factor slot order →
natural-order coefficients, per limb; given [G, S, n] with S > T, the last
T rows of each group, read in place (the joint rescale's dropped rows).

Kernel 6, `grid_transforms("pallas")[0]` (replaces `rescale_pallas.py:142
_ntt_grid_kernel`, wrapper `ntt3_grid_pallas` :180): the forward transform,
any uint32 input.

Kernel 7, `rescale_fwd` (replaces `rescale_pallas.py:206
_rescale_fwd_kernel`, "kernel D", wrapper `rescale_joint_pallas` :306,
which inverts all T rows first): for every keep limb q_j, from the K
dropped limbs' coefficients (kernel 5 or 9 on those rows alone), their
Garner digits and sign terms, their base extension, the centered
correction δ and the forward NTT of −δ·P⁻¹ alone; the keep rows stay in
the NTT domain, where (c_j − δ)·P⁻¹ transforms to c_j·P⁻¹ − NTT(δ·P⁻¹)
slot for slot, and the store adds each keep slot times P⁻¹ (and c0 and c1
in the hybrid product), in any slot order.

Kernels 8 and 9, `grid_transforms("mxu")` (replace `alchemy_tpu/backend/
pallas/ntt_pallas.py:211 _fwd_kernel` and `:232 _inv_kernel`, wrappers
`ntt_pallas` :289 and `intt_pallas` :314): kernels 6 and 5 in the 2-factor
slot order of `backend/ntt2.py` (`FastParams(impl="mxu")`). The TPU computes
them as a 4-step NTT of bf16 digit-plane matmuls on its matrix unit; here
they are the split radix-2 NTT of kernels 5 and 6 run with the 2-factor
slot table: the same values x(ψ^{2K+1}), in the same slots.

`grid_transforms("vpu")`: kernels 6 and 5 with the radix-2 slot table of
`backend/ntt.py` (`FastParams(impl="vpu")`), the counterparts of
`alchemy_tpu/backend/ntt.py:149 ntt_negacyclic` and `:173 intt_negacyclic`,
which the JAX package computes in jnp, with no Pallas kernel.

Same structure as kernels A, B and 4 (`mul_relin.py`): two blocks per
(limb, row), each with half of the limb in shared memory (n ≤ 2^16); every
kernel runs B's register-blocked passes (5 and 9 their inverse mirror) and
takes each block's slots in slot order through `slot_own`; on grids that
fit one wave 5, 6, 8 and 9 spread a limb over four blocks, and kernel 7 at
n ≤ 2^15 splits its prologue between the two blocks of a cluster
(`csrc/rescale.cu` says why). Each wrapper follows the launch protocol of
`launch.py`; the standalone transforms call the C entry points `ntt_grid`
and `intt_grid` with the slot table of their order and count under the
names of `launch.GRID_NAMES`.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda import launch
from alchemy_tpu_torch.backend.cuda.mul_relin import (
    GARNER_MAX_DIGITS,
    GARNER_WORDS,
    garner_consts,
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


#: the largest zp kernel 7 takes, which must be a power of two: the mod-zp
#: sums of its sign terms multiply two values < zp
ZP_MAX = 1 << 16


# ---------------------------------------------------------------------------
# plain versions (exact int64)
# ---------------------------------------------------------------------------


def _grid_plain(inverse: bool, n: int, qs: tuple[int, ...], x: torch.Tensor,
                order: str) -> torch.Tensor:
    """Plain kernels 5, 6, 8, 9: the last T = len(qs) rows of each group of
    x [G, S, n] int32 → [G, T, n] int32."""
    return narrow(launch.plain_transforms(order)[inverse](widen(x[:, x.shape[1] - len(qs):]),
                                                          n, qs))


def rescale_consts(keep: tuple[int, ...], drop: tuple[int, ...]) -> np.ndarray:
    """[L, 4 + 2K] uint32 per keep limb q_j: P mod q_j, its Shoup companion,
    P⁻¹ mod q_j, its companion, then [π_k]_{q_j} for the K dropped limbs'
    Garner digits and their companions (`_rescale_consts`,
    rescale_pallas.py:283)."""
    P, pis = math.prod(drop), _garner_tables(drop)[0]
    rows = []
    for q in keep:
        pm = P % q
        sc = launch.with_shoup(np.array([pm, pow(pm, -1, q)]), q)       # [2, 2]
        ext = launch.with_shoup(np.array([pi % q for pi in pis]), q)     # [2, K]
        rows.append(np.concatenate([sc.T.reshape(-1), ext.reshape(-1)]))
    return np.stack(rows).astype(np.uint32)


@lru_cache(maxsize=None)
def drop_consts(drop: tuple[int, ...], zp: int) -> np.ndarray:
    """The words of rescale.cu `DropConsts`, uint32, which kernel 7 takes by
    value: `garner_consts(drop)` padded to GARNER_MAX_DIGITS rows, the
    mixed-radix digits of P//2 and [π_k]_zp (each padded to
    GARNER_MAX_DIGITS), zp, P mod zp and P⁻¹ mod zp (`_sign_terms`). zp
    must be a power of two ≤ ZP_MAX."""
    if not 0 < zp <= ZP_MAX or zp & (zp - 1):
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
                      ntt, dropped, order: str = "pallas", c01=None) -> torch.Tensor:
    """Plain kernel 7: → [G, L, n] int32, or [G/2, 2, L, n] with c01 (see
    `rescale_fwd`)."""
    fwd = launch.plain_transforms(order)[0]
    dev, L, P = ntt.device, len(keep), math.prod(drop)
    q = qcol(keep, dev)
    p_mod = torch.tensor([P % qj for qj in keep], device=dev)[:, None]
    p_inv = torch.tensor([pow(P % qj, -1, qj) for qj in keep], device=dev)[:, None]
    xs = garner_digits(widen(dropped), drop)
    is_neg, t, t_neg = _sign_terms(xs, drop, zp)
    v = extend_digits(xs, drop, keep)                                     # [G, L, n]
    v = torch.where(is_neg[:, None, :], _sub_mod(v, p_mod, q), v)
    tw = t[:, None, :]
    tc = torch.where(t_neg[:, None, :], q - (zp - tw), tw)
    delta = _add_mod(v, tc * p_mod % q, q)
    correction = fwd(_sub_mod(torch.zeros_like(delta), delta, q) * p_inv % q, n, keep)
    out = _add_mod(correction, widen(ntt[:, :L]) * p_inv % q, q)
    if c01 is not None:
        r01 = out.reshape(2, -1, L, n)
        out = torch.stack([_add_mod(widen(c), r, q) for c, r in zip(c01, r01)], dim=1)
    return narrow(out)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _grid(inverse: bool, n: int, qs: tuple[int, ...], x: torch.Tensor,
          order: str) -> torch.Tensor:
    """Kernel 6, 8 (forward) or 5, 9 (inverse) of `order` on the last T =
    len(qs) rows of each group of x [G, S, n] (int32, any uint32; S = T for
    the whole tensor) → [G, T, n], canonical: the slot order from
    coefficients, or natural-order coefficients from the slot order. The
    rows are read in place."""
    name = launch.GRID_NAMES[order][inverse]
    with launch.span(name):
        qs = tuple(qs)
        G, T, dev = x.shape[0], len(qs), x.device
        S = x.shape[1] if x.dim() == 3 else T             # rows a group, the last T taken
        launch.check("x", x, (G, max(S, T), n), dev)
        if not launch.on_card(n, dev):
            return _grid_plain(inverse, n, qs, x, order)
        t = launch.device_tables(n, qs, order, str(dev))
        out = x.new_empty(G, T, n)
        launch.run(name, n, dev, (G, T), x.data_ptr() + 4 * (S - T) * n, out.data_ptr(),
                   t["limbs"].data_ptr(), t["inv" if inverse else "fwd"].data_ptr(),
                   t["grid_own"].data_ptr(), G, T, S)
        return out


@lru_cache(maxsize=None)
def grid_transforms(order: str, plain: bool = False):
    """(forward, inverse) standalone transforms of a slot order, each
    f(n, qs, x) on rows [G, T, n]: kernels 6 and 5 ("pallas"), 8 and 9
    ("mxu"), 6 and 5 with the radix-2 table ("vpu"), or their plain
    versions."""
    launch.plain_transforms(order)
    f = _grid_plain if plain else _grid
    return partial(f, False, order=order), partial(f, True, order=order)


def rescale_fwd(n: int, keep: tuple[int, ...], drop: tuple[int, ...], zp: int,
                ntt: torch.Tensor, dropped: torch.Tensor, order: str = "pallas",
                c01=None) -> torch.Tensor:
    """Kernel 7: the rows ntt [G, L + K, n] (int32, NTT domain in slot
    `order` over keep + drop; the first L of each group read, any uint32)
    rescaled by P = ∏ drop, with the K dropped rows as canonical
    coefficients dropped [G, K, n] (kernel 9 or 5 on the last K rows) →
    [G, L, n] over keep, NTT domain in slot `order`. The kernel's load
    computes the dropped rows' Garner digits and sign terms
    (`she.hybrid.rescale_joint`) and the correction δ, and transforms only
    (q_j − δ)·P⁻¹; its store adds each keep slot times P⁻¹. With c01 =
    (c0, c1), each [G/2, L, n] in slot order, → [G/2, 2, L, n]: row g < G/2
    plus c0[g] at [g, 0], row G/2 + g plus c1[g] at [g, 1] (the hybrid
    product's add-back). zp must be one `drop_consts` takes, and K ≤
    GARNER_MAX_DIGITS on the card."""
    with launch.span("rescale_fwd"):
        keep, drop = tuple(keep), tuple(drop)
        L, K = len(keep), len(drop)
        G, dev = ntt.shape[0], ntt.device
        launch.check("ntt", ntt, (G, L + K, n), dev)
        launch.check("dropped", dropped, (G, K, n), dev)
        if c01 is not None:
            if G % 2:
                raise ValueError(f"ntt: {G} rows, want the t0 and t1 rows of each ciphertext")
            for name, c in zip(("c0", "c1"), c01):
                launch.check(name, c, (G // 2, L, n), dev)
        if not launch.on_card(n, dev):
            return rescale_fwd_plain(n, keep, drop, zp, ntt, dropped, order, c01)
        words = drop_consts(drop, zp)
        t = launch.device_tables(n, keep, order, str(dev))
        consts = launch.uploaded(rescale_consts, keep, drop, device=str(dev))
        c0, c1 = (None, None) if c01 is None else c01
        out = ntt.new_empty(*((G, L, n) if c01 is None else (G // 2, 2, L, n)))
        launch.run("rescale_fwd", n, dev, (G, L, K), ntt.data_ptr(), dropped.data_ptr(),
                   launch.ptr(c0), launch.ptr(c1), consts.data_ptr(), words.ctypes.data,
                   out.data_ptr(), t["limbs"].data_ptr(), t["fwd"].data_ptr(),
                   t["slot_own"].data_ptr(), G, L, K)
        return out
