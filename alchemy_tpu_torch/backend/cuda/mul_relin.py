"""Kernels A, B and 4 of BGV multiply + relinearize, and the Garner digits
between A and 4: wrappers and plain versions.

Kernel A, `tensor_intt` (replaces `alchemy_tpu/backend/pallas/
mul_relin_pallas.py:232 _tensor_intt_kernel`): per limb, the Karatsuba
tensor product c0 = a0·b0, c2 = a1·b1, c1 = (a0+a1)(b0+b1) − c0 − c2, and
the inverse NTT of c2 to canonical coefficients c2c.

Kernel B, `digit_relin` (replaces `mul_relin_pallas.py:439
_digit_relin_ctmajor_kernel` and `:319 _digit_relin_kernel`, the
limb-major variant the TPU runs at 2^16 and for raw hints): for every
output limb l, the forward NTT of every gadget digit i (the residue c2c[i]
mod q_i, reduced mod q_l) and out0 = c0 + Σ_i d_i·hb[i, l],
out1 = c1 + Σ_i d_i·ha[i, l], with raw hints or Shoup hint pairs.
`digit_relin(..., tenant=)` runs kernel B over many tenants' keys
(`digit_relin_tenants`): Shoup hint tables [T, L, L, n] and a tenant index a
ciphertext, each ciphertext relinearized under its own tenant's hints
(`she/tenants.py`).

Kernel 4, `hybrid_digit_stage` (replaces `mul_relin_pallas.py:807
_hybrid_digit_relin_kernel`, wrapper `hybrid_digit_stage_pallas` :932): for
every limb t of the extended chain (T = L + K limbs), the base extension
Σ_k x_k·[π_k]_{q_t} of each digit group's Garner digits, its forward NTT,
and the sums t0 = Σ_j D_j·hb[j, t], t1 = Σ_j D_j·ha[j, t] from zero, with
raw hints or Shoup pairs; c0 and c1 join after the rescale by P.

`garner_pack` (replaces no TPU kernel: the JAX package computes it in XLA,
`alchemy_tpu/she/hybrid.py:446-451`): c2c's Garner mixed-radix digits
within each digit group, kernel 4's input, one coefficient a thread.

On the H100 every kernel (and 5–9 in `rescale.py`) runs two blocks per
(limb, row), each with half of the limb's n words in shared memory (64 KB
at n = 2^15, 128 KB at 2^16, where a whole limb of 256 KB exceeds the
227 KB a block can have); they take n ≤ 2^16. Every kernel runs the
register-blocked NTT passes of `csrc/zq.cuh` and reads or writes each
block's slots in slot order through `slot_own`; A (like 5 and 9) spreads a
limb over four blocks on grids that fit one wave of the card, and so does B
at 2^10 ≤ n ≤ 2^15, two blocks an SM, and its tenant form on every grid
there: `digit_relin_form`. See `csrc/mul_relin.cu` for what
bounds them.

Every wrapper takes a slot `order` and follows the launch protocol of
`launch.py`. The plain versions compute in exact int64 and are the
reference the kernels are held against.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda import build, launch
from alchemy_tpu_torch.backend.modarith import (
    _add_mod,
    _garner_tables,
    _sub_mod,
    extend_digits,
    garner_digits,
    mulmod,
    mulmod_shoup,
    narrow,
    qcol,
    shoup_const,
    widen,
)

#: the longest chain whose Garner digits the kernels compute in registers
#: (zq.cuh kMaxDigits), and the words of one row of `garner_consts`
GARNER_MAX_DIGITS = 8
GARNER_WORDS = 4 + 2 * GARNER_MAX_DIGITS


# ---------------------------------------------------------------------------
# plain versions (exact int64)
# ---------------------------------------------------------------------------


def tensor_intt_plain(n: int, qs: tuple[int, ...], ct_a: torch.Tensor,
                      ct_b: torch.Tensor, order: str = "pallas"):
    """Plain kernel A: [Bt, 2, L, n] × [Bt, 2, L, n] → (c0, c1, c2c), each
    [Bt, L, n] int32 (c0, c1 in slot order, c2c natural coefficients)."""
    intt = launch.plain_transforms(order)[1]
    a, b = widen(ct_a), widen(ct_b)
    q = qcol(qs, a.device)
    a0, a1, b0, b1 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    c0 = mulmod(a0, b0, qs)
    c2 = mulmod(a1, b1, qs)
    cross = mulmod(_add_mod(a0, a1, q), _add_mod(b0, b1, q), qs)
    c1 = _sub_mod(cross, _add_mod(c0, c2, q), q)
    return narrow(c0), narrow(c1), narrow(intt(c2, n, qs))


def digit_relin_plain(n: int, qs: tuple[int, ...], c0, c1, c2c, hint_b, hint_a,
                      order: str = "pallas", tenant=None):
    """Plain kernel B: → [Bt, 2, L, n] int32. Hints are raw [L, L, n] or
    (values, companions) Shoup pairs; [Bt, L, L, n] gives each ciphertext
    hints of its own, and with `tenant` ([Bt] int32) they are tables
    [T, L, L, n] from which each ciphertext takes its tenant's."""
    if tenant is not None:
        rows = tenant.long()
        hint_b, hint_a = (tuple(h[rows] for h in pair) for pair in (hint_b, hint_a))
    q = qcol(qs, c2c.device)
    dig = launch.plain_transforms(order)[2](widen(c2c), n, qs)          # [Bt, digit, limb, n]
    out0, out1 = widen(c0), widen(c1)
    shoup = isinstance(hint_b, (tuple, list))
    for i in range(len(qs)):
        d = dig[:, i]
        row = lambda h: widen(h[..., i, :, :])     # noqa: E731  (digit i's hint rows)
        if shoup:
            pb = mulmod_shoup(d, row(hint_b[0]), row(hint_b[1]), q)
            pa = mulmod_shoup(d, row(hint_a[0]), row(hint_a[1]), q)
        else:
            pb = mulmod(d, row(hint_b), qs)
            pa = mulmod(d, row(hint_a), qs)
        out0 = _add_mod(out0, pb, q)
        out1 = _add_mod(out1, pa, q)
    return narrow(torch.stack([out0, out1], dim=1))


def hybrid_ext_consts(groups: tuple[tuple[int, ...], ...],
                      targets: tuple[int, ...]) -> np.ndarray:
    """[T, 2, L] uint32: [π_k]_{q_t} for the L Garner digit rows (group-major,
    π_k the product of the limbs before k in its group) and the Shoup
    companions (`_hybrid_ext_consts`, mul_relin_pallas.py:914)."""
    pis = [pi for grp in groups for pi in _garner_tables(grp)[0]]
    return np.stack([launch.with_shoup(np.array([p % q for p in pis]), q) for q in targets])


def garner_consts(chain: tuple[int, ...]) -> np.ndarray:
    """[K, GARNER_WORDS] uint32, the Garner digits' constants of `chain` as
    zq.cuh `garner` reads them: row k holds g_k, [π_k⁻¹]_{g_k}, its Shoup
    companion, 0, then [π_j]_{g_k} for j < k (π_0 = 1) and their companions
    from word 4 + GARNER_MAX_DIGITS, zero past k. Raises for chains longer
    than GARNER_MAX_DIGITS, whose digits the kernels do not take."""
    if not 0 < len(chain) <= GARNER_MAX_DIGITS:
        raise NotImplementedError(f"a chain of {len(chain)} limbs: the kernels take Garner "
                                  f"digits over 1 to {GARNER_MAX_DIGITS} limbs")
    pi, inv = _garner_tables(chain)
    rows = np.zeros((len(chain), GARNER_WORDS), dtype=np.uint32)
    for k, g in enumerate(chain):
        rows[k, :3] = (g, inv[k], shoup_const(inv[k], g))
        ws = launch.with_shoup(np.array([pi[j] % g for j in range(k)], dtype=np.int64), g)
        rows[k, 4:4 + k], rows[k, 4 + GARNER_MAX_DIGITS:4 + GARNER_MAX_DIGITS + k] = ws
    return rows


def garner_pack_plain(n: int, groups, c2c: torch.Tensor) -> torch.Tensor:
    """Plain `garner_pack`: → [Bt, L, n] int32."""
    res, xs, off = widen(c2c), [], 0
    for grp in groups:
        xs.extend(garner_digits(res[:, off:off + len(grp)], tuple(grp)))
        off += len(grp)
    return narrow(torch.stack(xs, dim=1))


def hybrid_digit_stage_plain(n: int, ext_qs: tuple[int, ...], groups, x, hint_b, hint_a,
                             order: str = "pallas"):
    """Plain kernel 4: → [2, Bt, T, n] int32 (see `hybrid_digit_stage`)."""
    ntt = launch.plain_transforms(order)[0]
    q = qcol(ext_qs, x.device)
    xw = widen(x)
    shoup = isinstance(hint_b, (tuple, list))
    k0 = 0
    for j, grp in enumerate(groups):
        dig = extend_digits([xw[:, k] for k in range(k0, k0 + len(grp))], grp, ext_qs)
        k0 += len(grp)
        d = ntt(dig, n, ext_qs)
        if shoup:
            pb = mulmod_shoup(d, widen(hint_b[0][j]), widen(hint_b[1][j]), q)
            pa = mulmod_shoup(d, widen(hint_a[0][j]), widen(hint_a[1][j]), q)
        else:
            pb = mulmod(d, widen(hint_b[j]), ext_qs)
            pa = mulmod(d, widen(hint_a[j]), ext_qs)
        t0 = pb if j == 0 else _add_mod(t0, pb, q)
        t1 = pa if j == 0 else _add_mod(t1, pa, q)
    return narrow(torch.stack([t0, t1]))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def tensor_intt(n: int, qs: tuple[int, ...], ct_a: torch.Tensor,
                ct_b: torch.Tensor, order: str = "pallas"):
    """Kernel A on canonical ciphertexts [Bt, 2, L, n] (int32 storage, slot
    `order`)."""
    with launch.span("tensor_intt"):
        qs = tuple(qs)
        Bt, L, dev = ct_a.shape[0], len(qs), ct_a.device
        launch.check("ct_a", ct_a, (Bt, 2, L, n), dev)
        launch.check("ct_b", ct_b, (Bt, 2, L, n), dev)
        if not launch.on_card(n, dev):
            return tensor_intt_plain(n, qs, ct_a, ct_b, order)
        t = launch.device_tables(n, qs, order, str(dev))
        c0, c1, c2c = (torch.empty((Bt, L, n), dtype=torch.int32, device=dev)
                       for _ in range(3))
        launch.run("tensor_intt", n, dev, (Bt, L), ct_a.data_ptr(), ct_b.data_ptr(),
                   c0.data_ptr(), c1.data_ptr(), c2c.data_ptr(), t["limbs"].data_ptr(),
                   t["inv"].data_ptr(), t["grid_own"].data_ptr(), Bt, L)
        return c0, c1, c2c


def _hint_list(hint_b, hint_a, shape: tuple, device: torch.device) -> tuple[bool, list]:
    """(shoup, [hb, hbs, ha, has]) with None for the companions of raw
    hints, each checked against `shape`."""
    shoup = isinstance(hint_b, (tuple, list))
    hints = [*hint_b, *hint_a] if shoup else [hint_b, None, hint_a, None]
    for h in hints:
        if h is not None:
            launch.check("hint", h, shape, device)
    return shoup, hints


def digit_relin(n: int, qs: tuple[int, ...], c0: torch.Tensor, c1: torch.Tensor,
                c2c: torch.Tensor, hint_b, hint_a, order: str = "pallas",
                tenant: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel B: kernel A's (c0, c1, c2c) and the relinearization hints
    (raw [L, L, n] or Shoup pairs) → [Bt, 2, L, n], slot `order`. With
    `tenant` ([Bt] int32 on the device), kernel B's tenant-indexed form
    `digit_relin_tenants`: the hints are T tenants' Shoup tables, each
    [T, L, L, n], and ciphertext b is relinearized under tenant[b]'s. The
    card reads no index back: one outside [0, T) stops the kernel with a
    CUDA error (`she.tenants.TenantKeys.batch` refuses it on the host)."""
    name = "digit_relin" if tenant is None else "digit_relin_tenants"
    with launch.span(name) as sp:
        qs = tuple(qs)
        Bt, L, dev = c2c.shape[0], len(qs), c2c.device
        for arg, t in (("c0", c0), ("c1", c1), ("c2c", c2c)):
            launch.check(arg, t, (Bt, L, n), dev)
        if tenant is not None and not isinstance(hint_b, (tuple, list)):
            raise ValueError("digit_relin: a tenant index wants Shoup hint tables "
                             "(values, companions)")
        lead = () if tenant is None else (hint_b[0].shape[0],)       # (T,)
        shoup, hints = _hint_list(hint_b, hint_a, (*lead, L, L, n), dev)
        if tenant is not None:
            launch.check("tenant", tenant, (Bt,), dev)
        if not launch.on_card(n, dev):
            return digit_relin_plain(n, qs, c0, c1, c2c, hint_b, hint_a, order, tenant)
        launch.aligned(c0, c1, *hints)
        if sp is not None:
            sp.attrs["parts"] = digit_relin_form(n, L, Bt, tenant is not None)[0]
        t = launch.device_tables(n, qs, order, str(dev))
        out = torch.empty((Bt, 2, L, n), dtype=torch.int32, device=dev)
        which = (int(shoup),) if tenant is None else (tenant.data_ptr(), *lead)
        launch.run(name, n, dev, (Bt, L, *lead), c2c.data_ptr(), c0.data_ptr(), c1.data_ptr(),
                   *map(launch.ptr, hints), out.data_ptr(), t["limbs"].data_ptr(),
                   t["fwd"].data_ptr(), t["grid_own"].data_ptr(), *which, Bt, L)
        return out


@lru_cache(maxsize=None)
def digit_relin_form(n: int, L: int, Bt: int, tenants: bool = False) -> tuple[int, int]:
    """(parts, blocks an SM) of kernel B on the card for Bt ciphertexts of L
    limbs at ring size n, or of its tenant-indexed form, as the library
    reports them: the blocks a limb is split over and the blocks of it an
    SM holds at once. At 2^10 ≤ n ≤ 2^15 quarters (4, two blocks an SM)
    for the tenant form, and for one key where 4·L·Bt blocks fit one wave
    of the card, else halves (2, one block an SM); halves below 2^10 and at
    2^16. The launch span of each card launch of B carries the parts
    (`parts`)."""
    parts, blocks = ctypes.c_int(), ctypes.c_int()
    build.check(build.library().digit_relin_form(n.bit_length() - 1, int(tenants), Bt, L,
                                                 ctypes.byref(parts), ctypes.byref(blocks)),
                "digit_relin_form")
    return parts.value, blocks.value


def _group_width(groups, ext_qs: tuple[int, ...]) -> int:
    """α of hybrid digit groups that split the base chain (the first limbs of
    ext_qs) in order into runs of α limbs, the last one possibly shorter."""
    alpha = len(groups[0]) if groups else 0
    if (not groups or tuple(q for g in groups for q in g) != ext_qs[:sum(map(len, groups))]
            or any(len(g) != alpha for g in groups[:-1]) or not 0 < len(groups[-1]) <= alpha):
        raise ValueError(f"digit groups {groups}: want runs of α limbs of the chain in order")
    return alpha


def hybrid_digit_stage(n: int, ext_qs: tuple[int, ...], groups, x: torch.Tensor,
                       hint_b, hint_a, order: str = "pallas") -> torch.Tensor:
    """Kernel 4: the Garner digits x [Bt, L, n] of c2c (natural order; rows
    group-major, as `garner_pack` makes them) and the hybrid hints
    over ext_qs (raw [dnum, T, n] or Shoup pairs, slot `order`) →
    [2, Bt, T, n], the accumulator (t0, t1) before the rescale by P."""
    with launch.span("hybrid_digit_relin"):
        ext_qs, groups = tuple(ext_qs), tuple(map(tuple, groups))
        alpha = _group_width(groups, ext_qs)
        L, T, dnum = sum(map(len, groups)), len(ext_qs), len(groups)
        Bt, dev = x.shape[0], x.device
        launch.check("x", x, (Bt, L, n), dev)
        shoup, hints = _hint_list(hint_b, hint_a, (dnum, T, n), dev)
        if not launch.on_card(n, dev):
            return hybrid_digit_stage_plain(n, ext_qs, groups, x, hint_b, hint_a, order)
        launch.aligned(*hints)
        t = launch.device_tables(n, ext_qs, order, str(dev))
        ext = launch.uploaded(hybrid_ext_consts, groups, ext_qs, device=str(dev))
        out = torch.empty((2, Bt, T, n), dtype=torch.int32, device=dev)
        launch.run("hybrid_digit_relin", n, dev, (Bt, L, T, dnum), x.data_ptr(), ext.data_ptr(),
                   *map(launch.ptr, hints), out.data_ptr(), t["limbs"].data_ptr(),
                   t["fwd"].data_ptr(), t["slot_own"].data_ptr(), int(shoup), Bt, L, T, dnum,
                   alpha)
        return out


def garner_rows(groups) -> np.ndarray:
    """The groups' `garner_consts`, row l for limb l of the chain."""
    return np.concatenate([garner_consts(tuple(g)) for g in groups])


def garner_pack(n: int, groups, c2c: torch.Tensor) -> torch.Tensor:
    """The Garner digits of c2c [Bt, L, n] (int32 coefficients, canonical)
    within each digit group, rows group-major → [Bt, L, n] int32: kernel 4's
    input (`x_pack` of hybrid.py:446-451, here in natural coefficient
    order). groups split the chain in order into runs of α limbs, the last
    possibly shorter; α ≤ GARNER_MAX_DIGITS on the card."""
    with launch.span("garner_pack"):
        groups = tuple(map(tuple, groups))
        chain = tuple(q for g in groups for q in g)
        alpha = _group_width(groups, chain)
        Bt, L, dev = c2c.shape[0], len(chain), c2c.device
        launch.check("c2c", c2c, (Bt, L, n), dev)
        if not launch.on_card(n, dev):
            return garner_pack_plain(n, groups, c2c)
        consts = launch.uploaded(garner_rows, groups, device=str(dev))
        out = torch.empty_like(c2c)
        launch.run("garner_pack", n, dev, (Bt, L, alpha), c2c.data_ptr(), out.data_ptr(),
                   consts.data_ptr(), Bt, L, alpha)
        return out
