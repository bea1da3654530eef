"""Hybrid key-switching (dnum digit groups + special modulus P) for deep
chains — port of `alchemy_tpu/she/hybrid.py`.

The chain of L limbs is split into dnum groups of α = ⌈L/dnum⌉ limbs, and
relinearization runs over the extended chain Q·P of T = L + K limbs:

  digits:   D_j ≡ c2 (mod Q_j), |D_j| < Q_j = ∏ of group j's limbs, by exact
            Garner mixed-radix lifting;
  hint j:   B_j + A_j·s = P·ĝ_j·s² + zp·e_j (mod Q·P);
  combine:  (t0, t1) = Σ_j D_j·(B_j, A_j) over Q·P, one exact joint rescale
            by P back to Q (`rescale_joint`), added to (c0, c1).

On the card `mul_relin_hybrid` runs kernel A (tensor product + inverse NTT
of c2), the Garner digits in plain torch, kernel 4 (base extension, digit
NTTs, hint products) and `rescale_joint`: kernel 9 ("mxu") or 5 ("pallas"),
the Garner digits and sign terms of the dropped limbs in plain torch,
kernel 7; every kernel in the slot order of `FastParams.impl`. On CPU tensors
every kernel wrapper runs its plain version; `mul_relin_hybrid_plain` and
`_rescale_joint_plain` run the plain versions on any device, the reference
the kernel path is held against on the card. Sampling follows the JAX
package call for call, so one seed gives bit-identical keys and hints.
The Garner lifting and base extension of hybrid.py:78-125 (`garner_digits`,
`extend_digits`) live in `backend/modarith.py`, where the plain versions of
kernels 4 and 7 share them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda.mul_relin import (
    hybrid_digit_stage,
    hybrid_digit_stage_plain,
    tensor_intt,
    tensor_intt_plain,
)
from alchemy_tpu_torch.backend.cuda.rescale import (
    grid_transforms,
    rescale_fwd,
    rescale_fwd_plain,
)
from alchemy_tpu_torch.backend.modarith import (
    _add_mod,
    _garner_tables,
    _sub_mod,
    garner_digits,
    mulmod,
    narrow,
    qcol,
    widen,
)
from alchemy_tpu_torch.nt.primes import find_ntt_prime
from alchemy_tpu_torch.she.fast import FastParams, _ntt_p, _residues, _uniform, kernel_hint
from alchemy_tpu_torch.she.keys import gaussian_coeffs

# ---------------------------------------------------------------------------
# joint rescale: drop the last k limbs in one inverse/forward round trip
# ---------------------------------------------------------------------------


def _sign_terms(xs: list, drop: tuple[int, ...], zp: int):
    """For the dropped part V = Σ_k x_k·π_k of each coefficient: is_neg
    (V > P//2, a lexicographic compare of the digits) and the centered
    t ≡ (−V_c)·P⁻¹ (mod zp) with t_neg = t > zp//2 (hybrid.py:175-197)."""
    P = math.prod(drop)
    pi, _ = _garner_tables(drop)
    hd, h = [], P // 2
    for g in drop:
        hd.append(h % g)
        h //= g
    gt = torch.zeros_like(xs[0], dtype=torch.bool)
    eq = torch.ones_like(xs[0], dtype=torch.bool)
    for k in range(len(drop) - 1, -1, -1):
        gt = gt | (eq & (xs[k] > hd[k]))
        eq = eq & (xs[k] == hd[k])
    mask = zp - 1
    vz = torch.zeros_like(xs[0])
    for k, x in enumerate(xs):
        vz = (vz + (x & mask) * (pi[k] % zp)) & mask
    vz = torch.where(gt, (vz + zp - P % zp) & mask, vz)
    inv_p = pow(P % zp, -1, zp) if zp > 1 else 0
    t = (((zp - vz) & mask) * inv_p) & mask
    return gt, t, t > zp // 2


def _rescale_joint(p: FastParams, ct: torch.Tensor, k_drop: int, plain: bool) -> torch.Tensor:
    if p.zp & (p.zp - 1) or p.zp > (1 << 16):
        # the mod-zp sums of `_sign_terms` multiply two values < zp
        raise ValueError("rescale_joint requires a power-of-two zp <= 2^16")
    intt = grid_transforms(p.order, plain)[1]
    fwd = rescale_fwd_plain if plain else rescale_fwd
    qs = tuple(p.qs)
    keep, drop = qs[:-k_drop], qs[-k_drop:]
    lead = ct.shape[:-2]
    coeff = intt(p.n, qs, ct.reshape(-1, len(qs), p.n).contiguous())   # [G, T, n]
    xs = garner_digits(widen(coeff[:, len(keep):]), drop)
    is_neg, t, t_neg = _sign_terms(xs, drop, p.zp)
    out = fwd(p.n, keep, drop, p.zp, coeff, narrow(torch.stack(xs, dim=1)),
              is_neg.to(torch.int32), narrow(t), t_neg.to(torch.int32), p.order)
    return out.reshape(*lead, len(keep), p.n)


def rescale_joint(p: FastParams, ct: torch.Tensor, k_drop: int) -> torch.Tensor:
    """Exact BGV rescale by P = ∏ of the last k_drop limbs, in one inverse/
    forward NTT round trip (hybrid.py:134): ct [..., T, n] int32, NTT
    domain → [..., T − k_drop, n]. zp must be a power of two ≤ 2^16. Kernel 9
    ("mxu") or 5 ("pallas"), then the Garner digits and sign terms of the
    dropped rows, then kernel 7. At k_drop = 1 it equals `fast.rescale`."""
    return _rescale_joint(p, ct, k_drop, plain=False)


def _rescale_joint_plain(p: FastParams, ct: torch.Tensor, k_drop: int) -> torch.Tensor:
    """`rescale_joint` through the plain versions of its kernels, on any
    device (the counterpart of `_rescale_joint_jnp`, hybrid.py:160)."""
    return _rescale_joint(p, ct, k_drop, plain=True)


# ---------------------------------------------------------------------------
# hybrid key-switch parameters, keygen/hint, fused mul+relin
# ---------------------------------------------------------------------------


def pick_dnum(L: int) -> int:
    """Smallest dnum with α = ⌈L/dnum⌉ ≤ 4 (hybrid.py:219)."""
    return max(1, (L + 3) // 4)


@dataclass(frozen=True)
class HybridKS:
    """Static hybrid-KS configuration over a FastParams chain (hybrid.py:225)."""

    p: FastParams
    dnum: int
    ps: tuple[int, ...]       # special-modulus limbs, P = ∏ ps

    @staticmethod
    def make(p: FastParams, dnum: int | None = None, k_sp: int | None = None,
             bits: int | None = None) -> "HybridKS":
        L = len(p.qs)
        dnum = pick_dnum(L) if dnum is None else dnum
        alpha = -(-L // dnum)
        dnum = -(-L // alpha)        # the group count, which may be below the dnum asked for
        k_sp = alpha if k_sp is None else k_sp
        # the noise bound needs P ≥ max Q_j: start the special primes at the
        # chain's own width and widen until it holds
        if bits is None:
            bits = max(q.bit_length() for q in p.qs)
        max_Qj = max(math.prod(p.qs[i:i + alpha]) for i in range(0, L, alpha))
        while True:
            ps: list[int] = []
            while len(ps) < k_sp:
                ps.append(find_ntt_prime(2 * p.n, bits, avoid=tuple(p.qs) + tuple(ps)))
            if math.prod(ps) >= max_Qj or bits >= 31:
                break
            bits += 1
        return HybridKS(p=p, dnum=dnum, ps=tuple(ps))

    @property
    def pe(self) -> FastParams:
        """The extended chain Q·P (T = L + K limbs), in the slot order of p."""
        return replace(self.p, qs=self.p.qs + self.ps)

    @property
    def groups(self) -> tuple[tuple[int, ...], ...]:
        L = len(self.p.qs)
        alpha = -(-L // self.dnum)
        return tuple(tuple(self.p.qs[i:i + alpha]) for i in range(0, L, alpha))


def hybrid_keygen_hint(hk: HybridKS, rng: np.random.Generator, variance: float = 1.0,
                       hint_variance: float = 1.0, device="cuda"):
    """Secret key (NTT domain at the base chain, as `fast.keygen` makes it)
    and the hybrid relinearization hint (B, A), each [dnum, T, n] (hybrid.py:281)."""
    s = gaussian_coeffs(rng, variance, hk.p.n)
    s_ntt = _ntt_p(hk.p, _residues(s, hk.p.qs, device))
    return s_ntt, hybrid_relin_hint(hk, s, rng, hint_variance, device)


def hybrid_relin_hint(hk: HybridKS, s_coeffs: np.ndarray, rng: np.random.Generator,
                      hint_variance: float = 1.0, device="cuda"):
    """Hybrid relinearization hint for a secret key given by its centered
    integer coefficients: (B, A), each [dnum, T, n] int32, NTT domain over
    the extended chain, B_j + A_j·s = P·ĝ_j·s² + zp·e_j (hybrid.py:292)."""
    p, pe = hk.p, hk.pe
    n = p.n
    s = np.asarray(s_coeffs, dtype=np.int64)
    s_e = widen(_ntt_p(pe, _residues(s, pe.qs, device)))
    s2_e = mulmod(s_e, s_e, pe.qs)
    q = qcol(pe.qs, device)
    Q, P = math.prod(p.qs), math.prod(hk.ps)
    Bs, As = [], []
    for grp in hk.groups:
        Qj = math.prod(grp)
        Qi = Q // Qj
        g_j = P * (Qi * pow(Qi % Qj, -1, Qj) % Q) % (Q * P)
        g_col = torch.tensor([g_j % qe for qe in pe.qs], device=device)[:, None]
        a = widen(_ntt_p(pe, _uniform(rng, pe.qs, n, device)))
        e = gaussian_coeffs(rng, hint_variance, n)
        e_ntt = widen(_ntt_p(pe, _residues(e * p.zp, pe.qs, device)))
        Bs.append(_sub_mod(_add_mod(s2_e * g_col % q, e_ntt, q), mulmod(a, s_e, pe.qs), q))
        As.append(a)
    return narrow(torch.stack(Bs)), narrow(torch.stack(As))


def garner_pack(hk: HybridKS, c2c: torch.Tensor) -> torch.Tensor:
    """Garner digits of c2c [Bt, L, n] (int32 coefficients) within each
    digit group, rows group-major → [Bt, L, n] int32: kernel 4's input
    (`x_pack` of hybrid.py:446-451, here in natural coefficient order)."""
    res, xs, off = widen(c2c), [], 0
    for grp in hk.groups:
        xs.extend(garner_digits(res[:, off:off + len(grp)], grp))
        off += len(grp)
    return narrow(torch.stack(xs, dim=1))


def _mul_relin_hybrid(hk: HybridKS, ct_a, ct_b, hint_b, hint_a, tensor, digit_stage,
                      rescale) -> torch.Tensor:
    p, pe = hk.p, hk.pe
    L, n = len(p.qs), p.n
    lead = ct_a.shape[:-3]
    shape = (-1, 2, L, n)
    c0, c1, c2c = tensor(n, p.qs, ct_a.reshape(shape).contiguous(),
                         ct_b.reshape(shape).contiguous(), p.order)
    hint_b, hint_a = (kernel_hint(h, (hk.dnum, len(pe.qs), n)) for h in (hint_b, hint_a))
    t01 = digit_stage(n, pe.qs, hk.groups, garner_pack(hk, c2c), hint_b, hint_a, p.order)
    r01 = widen(rescale(pe, t01, len(hk.ps)))            # [2, Bt, L, n]
    q = qcol(p.qs, c0.device)
    out = torch.stack([_add_mod(widen(c0), r01[0], q), _add_mod(widen(c1), r01[1], q)], dim=1)
    return narrow(out).reshape(*lead, 2, L, n)


def mul_relin_hybrid(hk: HybridKS, ct_a: torch.Tensor, ct_b: torch.Tensor,
                     hint_b, hint_a) -> torch.Tensor:
    """BGV multiply + hybrid relinearization (hybrid.py:334): [..., 2, L, n]
    NTT-domain ciphertexts at the base chain → the same. Hints are raw
    [dnum, T, n] or Shoup pairs (`fast.shoup_precompute` over hk.pe.qs), in
    any layout (`fast.kernel_hint`).
    Kernel A → Garner digits → kernel 4 → `rescale_joint` → + (c0, c1), in
    the slot order of hk.p.impl."""
    return _mul_relin_hybrid(hk, ct_a, ct_b, hint_b, hint_a, tensor_intt,
                             hybrid_digit_stage, rescale_joint)


def mul_relin_hybrid_plain(hk: HybridKS, ct_a: torch.Tensor, ct_b: torch.Tensor,
                           hint_b, hint_a) -> torch.Tensor:
    """`mul_relin_hybrid` through the plain versions of its kernels, on any
    device."""
    return _mul_relin_hybrid(hk, ct_a, ct_b, hint_b, hint_a, tensor_intt_plain,
                             hybrid_digit_stage_plain, _rescale_joint_plain)
