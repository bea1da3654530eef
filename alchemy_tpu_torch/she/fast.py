"""BGV on power-of-two rings, NTT-domain ciphertexts [..., 2, L, n] — port
of `alchemy_tpu/she/fast.py` at every `impl` the JAX package takes: "mxu"
(the 2-factor slot order of `backend/ntt2.py`, the JAX package's default),
"mxu8" (the JAX package's int8 digit planes of the same transform: the same
slot order and residues, so the port runs it as "mxu"), "pallas" (the
3-factor slot order of `backend/ntt3.py`) and "vpu" (the bit-reversed order
of the radix-2 NTT, `backend/ntt.py`).

Residues are int32 tensors holding canonical uint32 values (< q < 2^31);
Shoup companions are carried as their int32 bit pattern. Sampling stays
host numpy from the caller's `np.random.Generator`, in the same order as
the JAX package, so one seed gives bit-identical keys, hints and
ciphertexts at every impl. Every function takes an explicit device or
follows the device of its tensors. The standalone transforms `_ntt_p` /
`_intt_p` run CUDA kernels 8 and 9 ("mxu"), or 6 and 5 ("pallas", and
"vpu" with its own slot table) on the card and their plain versions on the
CPU; `mul_relin` runs through CUDA kernels A and B, in the slot order of
`impl`, on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from math import prod

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda.mul_relin import ORDERS, digit_relin, tensor_intt
from alchemy_tpu_torch.backend.cuda.rescale import grid_transforms
from alchemy_tpu_torch.backend.modarith import (
    _add_mod,
    _sub_mod,
    mulmod,
    narrow,
    qcol,
    widen,
)
from alchemy_tpu_torch.nt.primes import find_ntt_prime
from alchemy_tpu_torch.she.keys import gaussian_coeffs, uniform_residues

#: the NTT slot order of `FastParams`, as in the JAX package (fast.py:35)
DEFAULT_NTT_IMPL = "mxu"
#: every `impl` of the JAX package's `FastParams` and its slot order: "mxu8"
#: computes the 2-factor transform with int8 planes (ntt_mxu.py:177), exactly
IMPLS = {**{order: order for order in ORDERS}, "mxu8": "mxu"}


@dataclass(frozen=True)
class FastParams:
    """Ring size n (a power of two), RNS chain qs (all ≡ 1 mod 2n), the
    plaintext modulus zp and the NTT implementation impl (fast.py:47): "mxu"
    or "mxu8" (2-factor, `backend/ntt2.py`), "pallas" (3-factor,
    `backend/ntt3.py`) or "vpu" (radix-2, `backend/ntt.py`)."""

    n: int
    qs: tuple[int, ...]
    zp: int = 2
    impl: str = DEFAULT_NTT_IMPL

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl={self.impl!r}: the port has {sorted(IMPLS)}")

    @property
    def order(self) -> str:
        """The slot order of impl, which the kernels and plain transforms take."""
        return IMPLS[self.impl]

    @staticmethod
    def make(log_n: int, nlimb: int, zp: int = 2, bits: int = 30,
             impl: str = DEFAULT_NTT_IMPL) -> "FastParams":
        n = 1 << log_n
        qs: list[int] = []
        while len(qs) < nlimb:
            qs.append(find_ntt_prime(2 * n, bits, avoid=tuple(qs)))
        return FastParams(n=n, qs=tuple(qs), zp=zp, impl=impl)


def _residues(x: np.ndarray, qs, device) -> torch.Tensor:
    """Signed int64 coefficients [n] → int32 residues [L, n] on device."""
    return torch.from_numpy(np.stack([x % q for q in qs]).astype(np.int32)).to(device)


def _uniform(rng: np.random.Generator, qs, n: int, device) -> torch.Tensor:
    return torch.from_numpy(uniform_residues(rng, qs, n).astype(np.int32)).to(device)


def _ntt_p(p: FastParams, x: torch.Tensor) -> torch.Tensor:
    """Forward NTT of int32 rows [..., L, n] → int32 slot order of p.impl
    (fast.py:82): kernel 8 ("mxu") or 6 ("pallas", "vpu") for CUDA tensors,
    its plain version (`ntt2`, `ntt3`, `ntt_vpu`) for CPU ones."""
    g = x.reshape(-1, len(p.qs), p.n).contiguous()
    return grid_transforms(p.order)[0](p.n, p.qs, g).reshape(x.shape)


def _intt_p(p: FastParams, x: torch.Tensor) -> torch.Tensor:
    """Inverse of `_ntt_p` (fast.py:103): kernel 9 or 5 for CUDA tensors."""
    g = x.reshape(-1, len(p.qs), p.n).contiguous()
    return grid_transforms(p.order)[1](p.n, p.qs, g).reshape(x.shape)


def keygen(p: FastParams, rng: np.random.Generator, variance: float = 1.0,
           device="cuda") -> torch.Tensor:
    """Secret key in the NTT domain: [L, n] (fast.py:146), on `device`
    (the card unless the caller asks for the CPU)."""
    s = gaussian_coeffs(rng, variance, p.n)
    return _ntt_p(p, _residues(s, p.qs, device))


def shoup_precompute(arr: torch.Tensor, qs: tuple[int, ...]) -> tuple:
    """(values, companions ⌊w·2^32/q⌋) of runtime-constant residues with the
    limb axis second-to-last (fast.py:153)."""
    comp = (widen(arr) << 32) // qcol(qs, arr.device)
    return arr, narrow(comp)


def relin_hint(p: FastParams, s_ntt: torch.Tensor, rng: np.random.Generator,
               variance: float = 1.0, shoup: bool = False):
    """CRT-gadget hint for s² under s: (B, A), each [L, L, n], with
    B_i + A_i·s = g_i·s² + zp·e_i (mod Q) (fast.py:186); with shoup=True
    each of B and A is a (values, companions) pair."""
    dev, qs, n = s_ntt.device, p.qs, p.n
    q = qcol(qs, dev)
    s = widen(s_ntt)
    s2 = mulmod(s, s, qs)
    Q = 1
    for qi in qs:
        Q *= qi
    Bs, As = [], []
    for qi in qs:
        Qi = Q // qi
        g = Qi * pow(Qi % qi, -1, qi) % Q
        a_ntt = widen(_ntt_p(p, _uniform(rng, qs, n, dev)))
        e = gaussian_coeffs(rng, variance, n)
        e_ntt = widen(_ntt_p(p, _residues(e * p.zp, qs, dev)))
        g_col = torch.tensor([g % qj for qj in qs], dtype=torch.int64, device=dev)[:, None]
        gs2 = s2 * g_col % q
        Bs.append(_sub_mod(_add_mod(gs2, e_ntt, q), mulmod(a_ntt, s, qs), q))
        As.append(a_ntt)
    B, A = narrow(torch.stack(Bs)), narrow(torch.stack(As))
    if shoup:
        return shoup_precompute(B, qs), shoup_precompute(A, qs)
    return B, A


def encrypt(p: FastParams, s_ntt: torch.Tensor, msg_coeffs: np.ndarray,
            rng: np.random.Generator, variance: float = 1.0) -> torch.Tensor:
    """Fresh ciphertext [2, L, n] (NTT domain) encrypting msg mod zp
    (fast.py:220)."""
    dev, qs, n = s_ntt.device, p.qs, p.n
    q = qcol(qs, dev)
    lift = np.asarray(msg_coeffs, dtype=np.int64) % p.zp
    lift = np.where(lift > p.zp // 2, lift - p.zp, lift)
    mu_ntt = widen(_ntt_p(p, _residues(lift, qs, dev)))
    a_ntt = widen(_ntt_p(p, _uniform(rng, qs, n, dev)))
    e = gaussian_coeffs(rng, variance, n)
    pe_ntt = widen(_ntt_p(p, _residues(e * p.zp, qs, dev)))
    c0 = _sub_mod(_add_mod(mu_ntt, pe_ntt, q), mulmod(a_ntt, widen(s_ntt), qs), q)
    return narrow(torch.stack([c0, a_ntt]))


def garner_host(coeff: np.ndarray, qs: tuple[int, ...]) -> list[np.ndarray]:
    """Mixed-radix (Garner) digits of the CRT values in coeff[..., k, :],
    in int64 numpy (fast.py:237)."""
    L = len(qs)
    pi = [1]
    for g in qs[:-1]:
        pi.append(pi[-1] * g)
    xs = [np.asarray(coeff[..., 0, :], dtype=np.int64) % qs[0]]
    for k in range(1, L):
        g = qs[k]
        acc = xs[0] % g
        for j in range(1, k):
            acc = (acc + xs[j] * (pi[j] % g)) % g
        inv = pow(pi[k] % g, -1, g)
        xs.append(
            (np.asarray(coeff[..., k, :], dtype=np.int64) - acc) % g * inv % g)
    return xs


def _garner_centered_mod(coeff: np.ndarray, qs: tuple[int, ...],
                         m: int) -> np.ndarray:
    """(centered CRT lift of coeff) mod m, vectorized int64 (fast.py:258)."""
    L = len(qs)
    xs = garner_host(coeff, qs)
    pi = [1]
    for g in qs[:-1]:
        pi.append(pi[-1] * g)
    Q = pi[-1] * qs[-1]
    hd = []
    h = Q // 2
    for g in qs:
        hd.append(h % g)
        h //= g
    gt = np.zeros(xs[0].shape, dtype=bool)
    eq = np.ones(xs[0].shape, dtype=bool)
    for k in range(L - 1, -1, -1):
        gt |= eq & (xs[k] > hd[k])
        eq &= xs[k] == hd[k]
    v = np.zeros(xs[0].shape, dtype=np.int64)
    for k in range(L):
        v = (v + xs[k] % m * (pi[k] % m)) % m
    return np.where(gt, (v - Q % m) % m, v)


def decrypt(p: FastParams, s_ntt: torch.Tensor, ct: torch.Tensor) -> np.ndarray:
    """Decrypt one ciphertext [k, L, n] → coefficients mod zp (host numpy;
    fast.py:285)."""
    q = qcol(p.qs, ct.device)
    s = widen(s_ntt)
    acc = widen(ct[0])
    spow = None
    for k in range(1, ct.shape[0]):
        spow = s if spow is None else mulmod(spow, s, p.qs)
        acc = _add_mod(acc, mulmod(widen(ct[k]), spow, p.qs), q)
    coeff = widen(_intt_p(p, narrow(acc))).cpu().numpy()
    return _garner_centered_mod(np.moveaxis(coeff, 0, -2), p.qs, p.zp)


def kernel_hint(h, shape: tuple):
    """A hint (raw, or a Shoup pair) as kernels B and 4 take it, from any
    layout the JAX package's `mul_relin` takes: each tensor with the leading
    dims of `shape` and trailing dims that multiply to n (the kernel-grid
    shape [L, L, A, B·r] too, as `_flat` of fast.py:339) reshaped to `shape`,
    made contiguous, and on the card copied where it starts off a 16-byte
    boundary. Other shapes pass through, for the kernel wrappers to refuse."""
    if isinstance(h, (tuple, list)):
        return tuple(kernel_hint(x, shape) for x in h)
    if h.shape != shape and h.shape[:len(shape) - 1] == shape[:-1] and h.numel() == prod(shape):
        h = h.reshape(shape)
    if not h.is_contiguous():
        h = h.contiguous()
    return h.clone() if h.is_cuda and h.data_ptr() % 16 else h


def mul_relin(p: FastParams, ct_a: torch.Tensor, ct_b: torch.Tensor,
              hint_b, hint_a) -> torch.Tensor:
    """BGV multiply + relinearize, [..., 2, L, n] × [..., 2, L, n] →
    [..., 2, L, n] (fast.py:310): kernel A then kernel B, in the slot order
    of p.impl. Hints are raw [L, L, n] or Shoup pairs from
    relin_hint(shoup=True), in any layout (`kernel_hint`)."""
    lead = ct_a.shape[:-3]
    L = len(p.qs)
    shape = (-1, 2, L, p.n)
    c0, c1, c2c = tensor_intt(p.n, p.qs, ct_a.reshape(shape).contiguous(),
                              ct_b.reshape(shape).contiguous(), p.order)
    hint_b, hint_a = (kernel_hint(h, (L, L, p.n)) for h in (hint_b, hint_a))
    out = digit_relin(p.n, p.qs, c0, c1, c2c, hint_b, hint_a, p.order)
    return out.reshape(*lead, *out.shape[1:])


def rescale(p: FastParams, ct: torch.Tensor, k_drop: int = 1) -> torch.Tensor:
    """Exact BGV rescale dropping the last k_drop limbs, NTT domain in and
    out (fast.py:389); plaintext-scale bookkeeping is the caller's."""
    out = ct
    qs = tuple(p.qs)
    pz = p.zp
    mask = pz - 1
    for _ in range(k_drop):
        coeff = widen(_intt_p(replace(p, qs=qs), out))
        qk = qs[-1]
        qs = qs[:-1]
        r = coeff[..., -1, :]
        is_neg = r > qk // 2
        r_mod_p = r & mask
        rc_mod_p = torch.where(is_neg, (r_mod_p + pz - ((qk % pz) & mask)) & mask,
                               r_mod_p)
        t = (((pz - rc_mod_p) & mask) * pow(qk, -1, pz)) & mask  # (−r_c)·q_k⁻¹ mod p
        t_neg = t > pz // 2
        rows = []
        for j, qj in enumerate(qs):
            qk_mod = qk % qj
            r_red = r % qj
            rc = torch.where(is_neg, (r_red - qk_mod) % qj, r_red)
            tc = torch.where(t_neg, qj - (pz - t), t)
            delta = (rc + tc * qk_mod % qj) % qj
            diff = (coeff[..., j, :] - delta) % qj
            rows.append(diff * pow(qk, -1, qj) % qj)
        out = _ntt_p(replace(p, qs=qs), narrow(torch.stack(rows, dim=-2)))
    return out
