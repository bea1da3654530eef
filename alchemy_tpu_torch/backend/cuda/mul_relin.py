"""Kernels A and B of BGV multiply + relinearize: wrappers, plain versions
and launch counters.

Kernel A, `tensor_intt` (replaces `alchemy_tpu/backend/pallas/
mul_relin_pallas.py:232 _tensor_intt_kernel`): per limb, the Karatsuba
tensor product c0 = a0·b0, c2 = a1·b1, c1 = (a0+a1)(b0+b1) − c0 − c2, and
the inverse NTT of c2 to canonical coefficients c2c.

Kernel B, `digit_relin` (replaces `mul_relin_pallas.py:439
_digit_relin_ctmajor_kernel`): for every output limb l, the forward NTT of
every gadget digit i (the residue c2c[i] mod q_i, reduced mod q_l) and
out0 = c0 + Σ_i d_i·hb[i, l], out1 = c1 + Σ_i d_i·ha[i, l] with Shoup hint
pairs.

On the H100 each kernel runs one block per (limb, ciphertext) with the
limb's n words in shared memory (128 KB at n = 2^15, so n ≤ 2^15: at 2^16
one limb exceeds the 227 KB a block can have). The kernels work in the
bit-reversed order of a radix-2 NTT; `kernel_tables` maps it to the
3-factor slot order of `backend/ntt3.py`, which is the contract at their
boundaries. See `csrc/mul_relin.cu` for what bounds them.

Each wrapper takes the plain PyTorch version for CPU tensors only; for CUDA
tensors it launches its kernel or raises. The plain versions compute in
exact int64 and are the reference the kernels are held against.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda import build
from alchemy_tpu_torch.backend.modarith import (
    _add_mod,
    _sub_mod,
    mulmod,
    mulmod_shoup,
    narrow,
    qcol,
    shoup_const,
    widen,
)
from alchemy_tpu_torch.backend.ntt3 import _split3, intt3, ntt3_bcast, psi_powers

#: launches of each kernel since the last `reset_launches()`
LAUNCHES = {"tensor_intt": 0, "digit_relin": 0}

#: shared memory one block may use on sm_90 (bytes)
MAX_SHARED_BYTES = 232448


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bitrev(v: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def _with_shoup(w: np.ndarray, q: int) -> np.ndarray:
    """[2, n] uint32: values w < q and their companions ⌊w·2^32/q⌋."""
    w = w.astype(np.uint64)
    return np.stack([w, (w << np.uint64(32)) // np.uint64(q)]).astype(np.uint32)


@lru_cache(maxsize=None)
def kernel_tables(n: int, qs: tuple[int, ...]) -> dict:
    """Host tables of both kernels (numpy):

    - `slot_ct` [n] int32: slot s = k1·(B·r) + k3·B + k2 of the 3-factor
      order holds x(ψ^{2K+1}) with K = k1 + A·k3 + A·r·k2; a radix-2 NTT
      leaves that value at index bitrev(K), which is slot_ct[s];
    - `fwd`, `inv` [L, 2, n] uint32: ψ^{±bitrev(k)} and Shoup companions;
    - `limbs` [L, 8] uint32: q, n⁻¹, its companion, ⌊2^32/q⌋ and the two
      words of ⌊2^64/q⌋ (zq.cuh `Limb`).
    """
    A, B, r = _split3(n)
    log_n = n.bit_length() - 1
    s = np.arange(n, dtype=np.int64)
    k1, k3, k2 = s // (B * r), (s % (B * r)) // B, s % B
    slot_ct = _bitrev(k1 + A * k3 + A * r * k2, log_n).astype(np.int32)
    br = _bitrev(s, log_n)
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
    return {"slot_ct": slot_ct, "fwd": fwd, "inv": inv, "limbs": limbs}


@lru_cache(maxsize=None)
def _device_tables(n: int, qs: tuple[int, ...], device: str) -> dict:
    return {k: torch.from_numpy(v.view(np.int32)).to(device)
            for k, v in kernel_tables(n, qs).items()}


# ---------------------------------------------------------------------------
# plain versions (exact int64)
# ---------------------------------------------------------------------------


def tensor_intt_plain(n: int, qs: tuple[int, ...], ct_a: torch.Tensor,
                      ct_b: torch.Tensor):
    """Plain kernel A: [Bt, 2, L, n] × [Bt, 2, L, n] → (c0, c1, c2c), each
    [Bt, L, n] int32 (c0, c1 in slot order, c2c natural coefficients)."""
    a, b = widen(ct_a), widen(ct_b)
    q = qcol(qs, a.device)
    a0, a1, b0, b1 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    c0 = mulmod(a0, b0, qs)
    c2 = mulmod(a1, b1, qs)
    cross = mulmod(_add_mod(a0, a1, q), _add_mod(b0, b1, q), qs)
    c1 = _sub_mod(cross, _add_mod(c0, c2, q), q)
    return narrow(c0), narrow(c1), narrow(intt3(c2, n, qs))


def digit_relin_plain(n: int, qs: tuple[int, ...], c0, c1, c2c, hint_b, hint_a):
    """Plain kernel B: → [Bt, 2, L, n] int32. Hints are raw [L, L, n] or
    (values, companions) Shoup pairs."""
    q = qcol(qs, c2c.device)
    dig = ntt3_bcast(widen(c2c), n, qs)          # [Bt, digit, limb, n]
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
    if device.type != "cuda":
        raise ValueError(f"tensors on {device}: want cpu or cuda")
    if 4 * n > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"n={n}: one limb ({4 * n} bytes) does not fit a block's shared "
            "memory; the kernels take n ≤ 2^15")


def tensor_intt(n: int, qs: tuple[int, ...], ct_a: torch.Tensor,
                ct_b: torch.Tensor):
    """Kernel A on canonical ciphertexts [Bt, 2, L, n] (int32 storage)."""
    qs = tuple(qs)
    Bt, L, dev = ct_a.shape[0], len(qs), ct_a.device
    _check("ct_a", ct_a, (Bt, 2, L, n), dev)
    _check("ct_b", ct_b, (Bt, 2, L, n), dev)
    if dev.type == "cpu":
        return tensor_intt_plain(n, qs, ct_a, ct_b)
    _kernel_device(n, dev)
    t = _device_tables(n, qs, str(dev))
    c0, c1, c2c = (torch.empty((Bt, L, n), dtype=torch.int32, device=dev)
                   for _ in range(3))
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.tensor_intt(
        ct_a.data_ptr(), ct_b.data_ptr(), c0.data_ptr(), c1.data_ptr(),
        c2c.data_ptr(), t["limbs"].data_ptr(), t["inv"].data_ptr(),
        t["slot_ct"].data_ptr(), Bt, L, n.bit_length() - 1, stream), "tensor_intt")
    LAUNCHES["tensor_intt"] += 1
    return c0, c1, c2c


def digit_relin(n: int, qs: tuple[int, ...], c0: torch.Tensor, c1: torch.Tensor,
                c2c: torch.Tensor, hint_b, hint_a) -> torch.Tensor:
    """Kernel B: kernel A's (c0, c1, c2c) and the relinearization hints →
    [Bt, 2, L, n]. On CUDA the hints must be Shoup pairs."""
    qs = tuple(qs)
    Bt, L, dev = c2c.shape[0], len(qs), c2c.device
    for name, t in (("c0", c0), ("c1", c1), ("c2c", c2c)):
        _check(name, t, (Bt, L, n), dev)
    shoup = isinstance(hint_b, (tuple, list))
    hints = [*hint_b, *hint_a] if shoup else [hint_b, hint_a]
    for h in hints:
        _check("hint", h, (L, L, n), dev)
    if dev.type == "cpu":
        return digit_relin_plain(n, qs, c0, c1, c2c, hint_b, hint_a)
    _kernel_device(n, dev)
    if not shoup:
        raise NotImplementedError(
            "kernel B takes Shoup hint pairs: relin_hint(..., shoup=True)")
    t = _device_tables(n, qs, str(dev))
    out = torch.empty((Bt, 2, L, n), dtype=torch.int32, device=dev)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.digit_relin(
        c2c.data_ptr(), c0.data_ptr(), c1.data_ptr(),
        *(h.data_ptr() for h in hints), out.data_ptr(),
        t["limbs"].data_ptr(), t["fwd"].data_ptr(), t["slot_ct"].data_ptr(),
        Bt, L, n.bit_length() - 1, stream), "digit_relin")
    LAUNCHES["digit_relin"] += 1
    return out
