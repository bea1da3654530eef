"""Kernels A, B and 4 of BGV multiply + relinearize, and the Garner digits
between A and 4: wrappers, plain versions and launch counters.

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
limb over four blocks on grids that fit one wave of the card. The kernels
work in the bit-reversed order of a radix-2 NTT; `kernel_tables` maps it to
the slot order at their boundaries, which is the `order` argument of every
wrapper: "pallas", the 3-factor order of `backend/ntt3.py`, "mxu", the
2-factor order of `backend/ntt2.py`, or "vpu", the bit-reversed order of
`backend/ntt.py` (`FastParams.order`). See
`csrc/mul_relin.cu` for what bounds them.

Each wrapper takes the plain PyTorch version for CPU tensors only; for CUDA
tensors it launches its kernel or raises.
Each wrapper runs, from entry to return, inside the launch span
`launch.<kernel>` (the name `LAUNCHES` counts; `utils.profiling`), whose
attribute `entry` names the C entry point it calls. The plain versions compute in
exact int64 and are the reference the kernels are held against.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda import build
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
from alchemy_tpu_torch.backend.ntt import intt_vpu, ntt_vpu, ntt_vpu_bcast
from alchemy_tpu_torch.backend.ntt2 import _pick_split, intt2, ntt2, ntt2_bcast
from alchemy_tpu_torch.backend.ntt3 import _split3, intt3, ntt3, ntt3_bcast, psi_powers
from alchemy_tpu_torch.utils.profiling import span

#: launches of each kernel since the last `reset_launches()`
LAUNCHES = {"tensor_intt": 0, "digit_relin": 0, "hybrid_digit_relin": 0, "garner_pack": 0}
#: launches of each kernel by shape since the last `reset_launches()`:
#: {("tensor_intt", Bt, L, n): count}, {("digit_relin", Bt, L, n): count},
#: {("hybrid_digit_relin", Bt, L, T, dnum, n): count} and
#: {("garner_pack", Bt, L, alpha, n): count}
LAUNCHES_BY_SHAPE: dict[tuple, int] = {}

#: shared memory one block may use on sm_90 (bytes)
MAX_SHARED_BYTES = 232448
#: the longest chain whose Garner digits the kernels compute in registers
#: (zq.cuh kMaxDigits), and the words of one row of `garner_consts`
GARNER_MAX_DIGITS = 8
GARNER_WORDS = 4 + 2 * GARNER_MAX_DIGITS


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()


def count_launch(launches: dict, by_shape: dict, name: str, *dims) -> None:
    """Add one launch of kernel `name` to `launches` and, keyed (name,
    *dims), to `by_shape`."""
    launches[name] += 1
    by_shape[(name, *dims)] = by_shape.get((name, *dims), 0) + 1


def _bitrev(v: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def _with_shoup(w: np.ndarray, q: int) -> np.ndarray:
    """[2, n] uint32: values w < q and their companions ⌊w·2^32/q⌋."""
    w = w.astype(np.uint64)
    return np.stack([w, (w << np.uint64(32)) // np.uint64(q)]).astype(np.uint32)


#: the slot orders the kernels take at their boundaries, with the plain
#: transforms of each: (forward, inverse, forward of each row under every limb)
ORDERS = {"pallas": (ntt3, intt3, ntt3_bcast), "mxu": (ntt2, intt2, ntt2_bcast),
          "vpu": (ntt_vpu, intt_vpu, ntt_vpu_bcast)}


def plain_transforms(order: str):
    """(ntt, intt, ntt_bcast) of a slot order, "pallas", "mxu" or "vpu"."""
    if order not in ORDERS:
        raise ValueError(f"slot order {order!r}: want one of {sorted(ORDERS)}")
    return ORDERS[order]


@lru_cache(maxsize=None)
def slot_tables(n: int, order: str) -> tuple[np.ndarray, np.ndarray]:
    """(slot_ct, slot_inv), [n] int32 each. Slot s holds x(ψ^{2K+1}) with
    K = k1 + A·k3 + A·r·k2 for s = k1·(B·r) + k3·B + k2 in the 3-factor
    order ("pallas"), K = k1 + n1·k2 for s = k1·n2 + k2 in the 2-factor
    order ("mxu"), K = bitrev(s) in the radix-2 order ("vpu"); a radix-2 NTT
    leaves that value at index bitrev(K), which is slot_ct[s]. slot_inv is
    its inverse, radix-2 index → slot: a block holding half h of a limb owns
    the slots slot_inv[h·n/2 : (h+1)·n/2]."""
    plain_transforms(order)
    s = np.arange(n, dtype=np.int64)
    bits = n.bit_length() - 1
    if order == "pallas":
        A, B, r = _split3(n)
        K = s // (B * r) + A * ((s % (B * r)) // B) + A * r * (s % B)
    elif order == "mxu":
        n1, n2 = _pick_split(n)
        K = s // n2 + n1 * (s % n2)
    else:
        # `ntt_negacyclic` is itself a ψ-twisted radix-2 DIF NTT whose output
        # stays bit-reversed (ntt.py:1-13), the kernels' own order: slot s
        # holds x(ψ^{2·bitrev(s)+1}), so slot_ct is the identity
        K = _bitrev(s, bits)
    slot_ct = _bitrev(K, bits).astype(np.int32)
    slot_inv = np.empty(n, dtype=np.int32)
    slot_inv[slot_ct] = s
    return slot_ct, slot_inv


@lru_cache(maxsize=None)
def kernel_tables(n: int, qs: tuple[int, ...], order: str = "pallas") -> dict:
    """Host tables of the kernels (numpy):

    - `slot_ct`, `slot_inv` [n] int32: `slot_tables(n, order)`;
    - `slot_own` [n] int32, every kernel: for each half h, the slots it
      owns (those of slot_inv[h·n/2 : (h+1)·n/2]) in slot order, each
      packed with its radix-2 index in the half:
      s | (slot_ct[s] − h·n/2) << 16 (n ≤ 2^16);
    - `slot_own4` [n] int32, kernels A, 5, 6, 8, 9 with a limb over four
      blocks: the same for each quarter;
    - `fwd`, `inv` [L, 2, n] uint32: ψ^{±bitrev(k)} and Shoup companions;
    - `limbs` [L, 8] uint32: q, n⁻¹, its companion, ⌊2^32/q⌋ and the two
      words of ⌊2^64/q⌋ (zq.cuh `Limb`).
    """
    slot_ct, slot_inv = slot_tables(n, order)

    def owned(parts):
        own = np.sort(slot_inv.reshape(parts, n // parts).astype(np.int64), axis=1)
        local = slot_ct[own] - np.arange(parts)[:, None] * (n // parts)
        return (own | local << 16).reshape(n).astype(np.int32)
    br = _bitrev(np.arange(n, dtype=np.int64), n.bit_length() - 1)
    L = len(qs)
    fwd = np.empty((L, 2, n), dtype=np.uint32)
    inv = np.empty((L, 2, n), dtype=np.uint32)
    limbs = np.zeros((L, 8), dtype=np.uint32)
    for li, q in enumerate(qs):
        p = psi_powers(n, q)
        fwd[li] = _with_shoup(p[br], q)
        inv[li] = _with_shoup(p[(2 * n - br) % (2 * n)], q)
        n_inv = pow(n, -1, q)
        barrett = (1 << 64) // q
        limbs[li, :6] = (q, n_inv, shoup_const(n_inv, q), (1 << 32) // q,
                         barrett & 0xFFFFFFFF, barrett >> 32)
    return {"slot_ct": slot_ct, "slot_inv": slot_inv, "slot_own": owned(2),
            "slot_own4": owned(4), "fwd": fwd, "inv": inv, "limbs": limbs}


@lru_cache(maxsize=None)
def _device_tables(n: int, qs: tuple[int, ...], order: str, device: str) -> dict:
    """The tables the kernels read on `device`: `limbs`, `fwd`, `inv`,
    `slot_own`, and `grid_own` [2n] (slot_own, then slot_own4) for the
    kernels that may split a limb over four blocks (A, 5, 6, 8, 9)."""
    t = kernel_tables(n, qs, order)
    host = {k: t[k] for k in ("limbs", "fwd", "inv", "slot_own")}
    host["grid_own"] = np.concatenate([t["slot_own"], t["slot_own4"]])
    return {k: torch.from_numpy(v.view(np.int32)).to(device) for k, v in host.items()}


# ---------------------------------------------------------------------------
# plain versions (exact int64)
# ---------------------------------------------------------------------------


def tensor_intt_plain(n: int, qs: tuple[int, ...], ct_a: torch.Tensor,
                      ct_b: torch.Tensor, order: str = "pallas"):
    """Plain kernel A: [Bt, 2, L, n] × [Bt, 2, L, n] → (c0, c1, c2c), each
    [Bt, L, n] int32 (c0, c1 in slot order, c2c natural coefficients)."""
    intt = plain_transforms(order)[1]
    a, b = widen(ct_a), widen(ct_b)
    q = qcol(qs, a.device)
    a0, a1, b0, b1 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    c0 = mulmod(a0, b0, qs)
    c2 = mulmod(a1, b1, qs)
    cross = mulmod(_add_mod(a0, a1, q), _add_mod(b0, b1, q), qs)
    c1 = _sub_mod(cross, _add_mod(c0, c2, q), q)
    return narrow(c0), narrow(c1), narrow(intt(c2, n, qs))


def digit_relin_plain(n: int, qs: tuple[int, ...], c0, c1, c2c, hint_b, hint_a,
                      order: str = "pallas"):
    """Plain kernel B: → [Bt, 2, L, n] int32. Hints are raw [L, L, n] or
    (values, companions) Shoup pairs."""
    q = qcol(qs, c2c.device)
    dig = plain_transforms(order)[2](widen(c2c), n, qs)          # [Bt, digit, limb, n]
    out0, out1 = widen(c0), widen(c1)
    shoup = isinstance(hint_b, (tuple, list))
    for i in range(len(qs)):
        d = dig[:, i]
        if shoup:
            pb = mulmod_shoup(d, widen(hint_b[0][i]), widen(hint_b[1][i]), q)
            pa = mulmod_shoup(d, widen(hint_a[0][i]), widen(hint_a[1][i]), q)
        else:
            pb = mulmod(d, widen(hint_b[i]), qs)
            pa = mulmod(d, widen(hint_a[i]), qs)
        out0 = _add_mod(out0, pb, q)
        out1 = _add_mod(out1, pa, q)
    return narrow(torch.stack([out0, out1], dim=1))


@lru_cache(maxsize=None)
def hybrid_ext_consts(groups: tuple[tuple[int, ...], ...],
                      targets: tuple[int, ...]) -> np.ndarray:
    """[T, 2, L] uint32: [π_k]_{q_t} for the L Garner digit rows (group-major,
    π_k the product of the limbs before k in its group) and the Shoup
    companions (`_hybrid_ext_consts`, mul_relin_pallas.py:914)."""
    pis = [pi for grp in groups for pi in _garner_tables(grp)[0]]
    return np.stack([_with_shoup(np.array([p % q for p in pis]), q) for q in targets])


@lru_cache(maxsize=None)
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
        ws = _with_shoup(np.array([pi[j] % g for j in range(k)], dtype=np.int64), g)
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
    ntt = plain_transforms(order)[0]
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


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if (t.dtype != torch.int32 or tuple(t.shape) != shape
            or not t.is_contiguous() or t.device != device):
        raise ValueError(
            f"{name}: want a contiguous int32 tensor {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _kernel_device(n: int, device: torch.device) -> None:
    """Raise unless the kernels run at ring size n on `device`: each block
    keeps half a limb in shared memory (2n bytes: n ≤ 2^16)."""
    if device.type != "cuda":
        raise ValueError(f"tensors on {device}: want cpu or cuda")
    if 2 * n > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"n={n}: half a limb ({2 * n} bytes) does not fit a block's shared "
            "memory; the kernels take n ≤ 2^16")


def tensor_intt(n: int, qs: tuple[int, ...], ct_a: torch.Tensor,
                ct_b: torch.Tensor, order: str = "pallas"):
    """Kernel A on canonical ciphertexts [Bt, 2, L, n] (int32 storage, slot
    `order`)."""
    with span("launch.tensor_intt", entry="tensor_intt"):
        qs = tuple(qs)
        Bt, L, dev = ct_a.shape[0], len(qs), ct_a.device
        _check("ct_a", ct_a, (Bt, 2, L, n), dev)
        _check("ct_b", ct_b, (Bt, 2, L, n), dev)
        if dev.type == "cpu":
            return tensor_intt_plain(n, qs, ct_a, ct_b, order)
        _kernel_device(n, dev)
        t = _device_tables(n, qs, order, str(dev))
        c0, c1, c2c = (torch.empty((Bt, L, n), dtype=torch.int32, device=dev)
                       for _ in range(3))
        lib = build.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.tensor_intt(
            ct_a.data_ptr(), ct_b.data_ptr(), c0.data_ptr(), c1.data_ptr(),
            c2c.data_ptr(), t["limbs"].data_ptr(), t["inv"].data_ptr(),
            t["grid_own"].data_ptr(), Bt, L, n.bit_length() - 1, stream), "tensor_intt")
        count_launch(LAUNCHES, LAUNCHES_BY_SHAPE, "tensor_intt", Bt, L, n)
        return c0, c1, c2c


def _aligned(*tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: kernels B and 4
    read hint and sum rows 16 bytes at a time."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"tensor at {t.data_ptr():#x}: kernels B and 4 want 16-byte "
                             "aligned rows (a fresh tensor is)")


def _hint_list(hint_b, hint_a, shape: tuple, device: torch.device) -> tuple[bool, list]:
    """(shoup, [hb, hbs, ha, has]) with None for the companions of raw
    hints, each checked against `shape`."""
    shoup = isinstance(hint_b, (tuple, list))
    hints = [*hint_b, *hint_a] if shoup else [hint_b, None, hint_a, None]
    for h in hints:
        if h is not None:
            _check("hint", h, shape, device)
    return shoup, hints


def _ptr(t):
    return None if t is None else t.data_ptr()


def digit_relin(n: int, qs: tuple[int, ...], c0: torch.Tensor, c1: torch.Tensor,
                c2c: torch.Tensor, hint_b, hint_a, order: str = "pallas") -> torch.Tensor:
    """Kernel B: kernel A's (c0, c1, c2c) and the relinearization hints
    (raw [L, L, n] or Shoup pairs) → [Bt, 2, L, n], slot `order`."""
    with span("launch.digit_relin", entry="digit_relin"):
        qs = tuple(qs)
        Bt, L, dev = c2c.shape[0], len(qs), c2c.device
        for name, t in (("c0", c0), ("c1", c1), ("c2c", c2c)):
            _check(name, t, (Bt, L, n), dev)
        shoup, hints = _hint_list(hint_b, hint_a, (L, L, n), dev)
        if dev.type == "cpu":
            return digit_relin_plain(n, qs, c0, c1, c2c, hint_b, hint_a, order)
        _kernel_device(n, dev)
        _aligned(c0, c1, *hints)
        t = _device_tables(n, qs, order, str(dev))
        out = torch.empty((Bt, 2, L, n), dtype=torch.int32, device=dev)
        lib = build.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.digit_relin(
            c2c.data_ptr(), c0.data_ptr(), c1.data_ptr(), *map(_ptr, hints), out.data_ptr(),
            t["limbs"].data_ptr(), t["fwd"].data_ptr(), t["slot_own"].data_ptr(), int(shoup), Bt,
            L, n.bit_length() - 1, stream), "digit_relin")
        count_launch(LAUNCHES, LAUNCHES_BY_SHAPE, "digit_relin", Bt, L, n)
        return out


def _group_width(groups, ext_qs: tuple[int, ...]) -> int:
    """α of hybrid digit groups that split the base chain (the first limbs of
    ext_qs) in order into runs of α limbs, the last one possibly shorter."""
    alpha = len(groups[0]) if groups else 0
    if (not groups or tuple(q for g in groups for q in g) != ext_qs[:sum(map(len, groups))]
            or any(len(g) != alpha for g in groups[:-1]) or not 0 < len(groups[-1]) <= alpha):
        raise ValueError(f"digit groups {groups}: want runs of α limbs of the chain in order")
    return alpha


@lru_cache(maxsize=None)
def _device_ext(groups, ext_qs: tuple[int, ...], device: str) -> torch.Tensor:
    return torch.from_numpy(hybrid_ext_consts(groups, ext_qs).view(np.int32)).to(device)


def hybrid_digit_stage(n: int, ext_qs: tuple[int, ...], groups, x: torch.Tensor,
                       hint_b, hint_a, order: str = "pallas") -> torch.Tensor:
    """Kernel 4: the Garner digits x [Bt, L, n] of c2c (natural order; rows
    group-major, as `garner_pack` makes them) and the hybrid hints
    over ext_qs (raw [dnum, T, n] or Shoup pairs, slot `order`) →
    [2, Bt, T, n], the accumulator (t0, t1) before the rescale by P."""
    with span("launch.hybrid_digit_relin", entry="hybrid_digit_relin"):
        ext_qs, groups = tuple(ext_qs), tuple(map(tuple, groups))
        alpha = _group_width(groups, ext_qs)
        L, T, dnum = sum(map(len, groups)), len(ext_qs), len(groups)
        Bt, dev = x.shape[0], x.device
        _check("x", x, (Bt, L, n), dev)
        shoup, hints = _hint_list(hint_b, hint_a, (dnum, T, n), dev)
        if dev.type == "cpu":
            return hybrid_digit_stage_plain(n, ext_qs, groups, x, hint_b, hint_a, order)
        _kernel_device(n, dev)
        _aligned(*hints)
        t = _device_tables(n, ext_qs, order, str(dev))
        out = torch.empty((2, Bt, T, n), dtype=torch.int32, device=dev)
        lib = build.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.hybrid_digit_relin(
            x.data_ptr(), _device_ext(groups, ext_qs, str(dev)).data_ptr(), *map(_ptr, hints),
            out.data_ptr(), t["limbs"].data_ptr(), t["fwd"].data_ptr(), t["slot_own"].data_ptr(),
            int(shoup), Bt, L, T, dnum, alpha, n.bit_length() - 1, stream), "hybrid_digit_relin")
        count_launch(LAUNCHES, LAUNCHES_BY_SHAPE, "hybrid_digit_relin", Bt, L, T, dnum, n)
        return out


@lru_cache(maxsize=None)
def _device_garner(groups, device: str) -> torch.Tensor:
    """The groups' `garner_consts`, row l for limb l of the chain, on
    `device`, uploaded once (a captured CUDA graph may not copy from the
    host)."""
    rows = np.concatenate([garner_consts(tuple(g)) for g in groups])
    return torch.from_numpy(rows.view(np.int32)).to(device)


def garner_pack(n: int, groups, c2c: torch.Tensor) -> torch.Tensor:
    """The Garner digits of c2c [Bt, L, n] (int32 coefficients, canonical)
    within each digit group, rows group-major → [Bt, L, n] int32: kernel 4's
    input (`x_pack` of hybrid.py:446-451, here in natural coefficient
    order). groups split the chain in order into runs of α limbs, the last
    possibly shorter; α ≤ GARNER_MAX_DIGITS on the card."""
    with span("launch.garner_pack", entry="garner_pack"):
        groups = tuple(map(tuple, groups))
        chain = tuple(q for g in groups for q in g)
        alpha = _group_width(groups, chain)
        Bt, L, dev = c2c.shape[0], len(chain), c2c.device
        _check("c2c", c2c, (Bt, L, n), dev)
        if dev.type == "cpu":
            return garner_pack_plain(n, groups, c2c)
        _kernel_device(n, dev)
        consts = _device_garner(groups, str(dev))
        out = torch.empty_like(c2c)
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(build.library().garner_pack(
            c2c.data_ptr(), out.data_ptr(), consts.data_ptr(), Bt, L, alpha, n.bit_length() - 1,
            stream), "garner_pack")
        count_launch(LAUNCHES, LAUNCHES_BY_SHAPE, "garner_pack", Bt, L, alpha, n)
        return out
