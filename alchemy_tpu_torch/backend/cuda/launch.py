"""The host side that every CUDA kernel wrapper of the port shares
(`mul_relin.py`: A, B, 4 and `garner_pack`; `rescale.py`: 5–9; `modq.py`:
the general path's mod-q kernels): the slot orders and their tables, and the
launch protocol with its one set of counters.

The kernels work in the bit-reversed order of a radix-2 NTT; `kernel_tables`
maps it to the slot order at their boundaries, the `order` argument of every
wrapper: "pallas", the 3-factor order of `backend/ntt3.py`, "mxu", the
2-factor order of `backend/ntt2.py`, or "vpu", the bit-reversed order of
`backend/ntt.py` (`FastParams.order`).

A wrapper runs from entry to return inside its launch span (`span`),
`check`s its tensors, runs its plain PyTorch version for CPU tensors
(`on_card`), and otherwise takes its tables on the device (`device_tables`,
`uploaded`: built and copied once, so a captured CUDA graph copies nothing
from the host), allocates its outputs and launches through `run`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda import build
from alchemy_tpu_torch.backend.modarith import shoup_const
from alchemy_tpu_torch.backend.ntt import intt_vpu, ntt_vpu, ntt_vpu_bcast
from alchemy_tpu_torch.backend.ntt2 import _pick_split, intt2, ntt2, ntt2_bcast
from alchemy_tpu_torch.backend.ntt3 import _split3, intt3, ntt3, ntt3_bcast, psi_powers
from alchemy_tpu_torch.utils import profiling

#: the slot orders the kernels take at their boundaries, with the plain
#: transforms of each: (forward, inverse, forward of each row under every limb)
ORDERS = {"pallas": (ntt3, intt3, ntt3_bcast), "mxu": (ntt2, intt2, ntt2_bcast),
          "vpu": (ntt_vpu, intt_vpu, ntt_vpu_bcast)}
#: the launch counter of each slot order's (forward, inverse) standalone
#: transform, the C entry points `ntt_grid` and `intt_grid` with its slot
#: table: kernels 6 and 5, 8 and 9, 6 and 5 with the radix-2 table
GRID_NAMES = {"pallas": ("ntt_grid", "intt_grid"), "mxu": ("ntt2_grid", "intt2_grid"),
              "vpu": ("ntt_vpu_grid", "intt_vpu_grid")}
#: the general path's mod-q kernels (`modq.py`), whose C entry points and
#: CUDA functions share their names
MODQ_NAMES = ("gp_split16", "gp_recombine", "gp_binop", "gp_scale_pad", "gp_rescale_step")
#: the C entry point of each kernel: A, B (one key, or many tenants' keys), 4
#: and `garner_pack` (`mul_relin.py`), 7 and the standalone transforms
#: (`rescale.py`), the mod-q kernels
ENTRIES = {**{k: k for k in ("tensor_intt", "digit_relin", "digit_relin_tenants",
                             "hybrid_digit_relin", "garner_pack", "rescale_fwd", *MODQ_NAMES)},
           **{name: entry for names in GRID_NAMES.values()
              for name, entry in zip(names, ("ntt_grid", "intt_grid"))}}
#: launches of each kernel since the last `reset_launches()`
LAUNCHES = dict.fromkeys(ENTRIES, 0)
#: launches of each kernel by shape since the last `reset_launches()`, keyed
#: (name, *key, n) with the key each wrapper gives `run`:
#: ("tensor_intt", Bt, L, n), ("digit_relin", Bt, L, n),
#: ("digit_relin_tenants", Bt, L, T, n),
#: ("hybrid_digit_relin", Bt, L, T, dnum, n), ("garner_pack", Bt, L, alpha, n),
#: (name, G, T, n) for the standalone transforms and ("rescale_fwd", G, L, K, n);
#: the mod-q kernels, which take no ring size, (name, *key) (`modq.py`)
LAUNCHES_BY_SHAPE: dict[tuple, int] = {}
_SPANS = {name: f"launch.{name}" for name in ENTRIES}

#: shared memory one block may use on sm_90 (bytes)
MAX_SHARED_BYTES = 232448


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()


# ---------------------------------------------------------------------------
# slot orders and their tables
# ---------------------------------------------------------------------------


def _bitrev(v: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def with_shoup(w: np.ndarray, q: int) -> np.ndarray:
    """[2, ...] uint32: values w < q and their companions ⌊w·2^32/q⌋."""
    w = w.astype(np.uint64)
    return np.stack([w, (w << np.uint64(32)) // np.uint64(q)]).astype(np.uint32)


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


def limb_words(q: int, w: int = 0, w2: int = 0) -> tuple[int, ...]:
    """The 8 uint32 words of zq.cuh `Limb` for q: q, w and its Shoup
    companion (n⁻¹ mod q for the NTT kernels, a mod-q kernel's own constant
    in `modq.py`), ⌊2^32/q⌋, the two words of ⌊2^64/q⌋, a second constant w2
    and its companion (0 and 0 where unused)."""
    barrett = (1 << 64) // q
    return (q, w, shoup_const(w, q), (1 << 32) // q, barrett & 0xFFFFFFFF, barrett >> 32,
            w2, shoup_const(w2, q))


@lru_cache(maxsize=None)
def kernel_tables(n: int, qs: tuple[int, ...], order: str = "pallas") -> dict:
    """Host tables of the kernels (numpy):

    - `slot_ct`, `slot_inv` [n] int32: `slot_tables(n, order)`;
    - `slot_own` [n] int32, every kernel: for each half h, the slots it
      owns (those of slot_inv[h·n/2 : (h+1)·n/2]) in slot order, each
      packed with its radix-2 index in the half:
      s | (slot_ct[s] − h·n/2) << 16 (n ≤ 2^16);
    - `slot_own4` [n] int32, kernels A, B, 5, 6, 8, 9 with a limb over four
      blocks: the same for each quarter;
    - `fwd`, `inv` [L, 2, n] uint32: ψ^{±bitrev(k)} and Shoup companions;
    - `limbs` [L, 8] uint32: `limb_words(q, n⁻¹ mod q)` (zq.cuh `Limb`).
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
        fwd[li] = with_shoup(p[br], q)
        inv[li] = with_shoup(p[(2 * n - br) % (2 * n)], q)
        limbs[li] = limb_words(q, pow(n, -1, q))
    return {"slot_ct": slot_ct, "slot_inv": slot_inv, "slot_own": owned(2),
            "slot_own4": owned(4), "fwd": fwd, "inv": inv, "limbs": limbs}


@lru_cache(maxsize=None)
def device_tables(n: int, qs: tuple[int, ...], order: str, device: str) -> dict:
    """The tables the kernels read on `device`: `limbs`, `fwd`, `inv`,
    `slot_own`, and `grid_own` [2n] (slot_own, then slot_own4) for the
    kernels that may split a limb over four blocks (A, B, 5, 6, 8, 9)."""
    t = kernel_tables(n, qs, order)
    host = {k: t[k] for k in ("limbs", "fwd", "inv", "slot_own")}
    host["grid_own"] = np.concatenate([t["slot_own"], t["slot_own4"]])
    return {k: torch.from_numpy(v.view(np.int32)).to(device) for k, v in host.items()}


@lru_cache(maxsize=None)
def uploaded(consts, *args, device: str) -> torch.Tensor:
    """consts(*args), a kernel's uint32 numpy table, as int32 on `device`,
    uploaded once."""
    return torch.from_numpy(consts(*args).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# the launch protocol
# ---------------------------------------------------------------------------


def span(name: str):
    """The launch span `launch.<name>` of kernel `name`'s wrapper."""
    return profiling.span(_SPANS[name], entry=ENTRIES[name])


def check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if (t.dtype != torch.int32 or tuple(t.shape) != shape
            or not t.is_contiguous() or t.device != device):
        raise ValueError(
            f"{name}: want a contiguous int32 tensor {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def on_card(n: int | None, device: torch.device) -> bool:
    """False for CPU tensors, whose wrapper runs its plain version; True
    where the kernels run at ring size n on `device` (n None: the mod-q
    kernels, which take rows of any length). Raises otherwise: each block of
    an NTT kernel keeps half a limb in shared memory (2n bytes: n ≤ 2^16)."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"tensors on {device}: want cpu or cuda")
    if n is not None and 2 * n > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"n={n}: half a limb ({2 * n} bytes) does not fit a block's shared "
            "memory; the kernels take n ≤ 2^16")
    return True


def aligned(*tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: kernels B and 4
    read hint and sum rows 16 bytes at a time."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"tensor at {t.data_ptr():#x}: kernels B and 4 want 16-byte "
                             "aligned rows (a fresh tensor is)")


def ptr(t):
    return None if t is None else t.data_ptr()


def run(name: str, n: int | None, device: torch.device, key: tuple, *args) -> None:
    """Call kernel `name`'s C entry point with args, log2 n (none where n is
    None: the mod-q kernels) and the current stream of `device`; raise on the
    CUDA error it returns, and count one launch keyed (name, *key, n), or
    (name, *key)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if n is not None:
        args = (*args, n.bit_length() - 1)
        key = (*key, n)
    build.check(getattr(build.library(), ENTRIES[name])(*args, stream), name)
    LAUNCHES[name] += 1
    key = (name, *key)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
