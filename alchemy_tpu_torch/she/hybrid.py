"""Hybrid key-switching (dnum digit groups + special modulus P) for deep
chains — port of `alchemy_tpu/she/hybrid.py`.

The chain of L limbs is split into dnum groups of α = ⌈L/dnum⌉ limbs, and
relinearization runs over the extended chain Q·P of T = L + K limbs:

  digits:   D_j ≡ c2 (mod Q_j), |D_j| < Q_j = ∏ of group j's limbs, by exact
            Garner mixed-radix lifting;
  hint j:   B_j + A_j·s = P·ĝ_j·s² + zp·e_j (mod Q·P);
  combine:  (t0, t1) = Σ_j D_j·(B_j, A_j) over Q·P, one exact joint rescale
            by P back to Q (`rescale_joint`), added to (c0, c1).

On the card `mul_relin_hybrid` launches five kernels and no torch op:
kernel A (tensor product + inverse NTT of c2), `garner_pack` (c2's Garner
digits), kernel 4 (base extension, digit NTTs, hint products) and
`rescale_joint`'s kernel 9 ("mxu") or 5 ("pallas", "vpu") on the K dropped
limbs alone and kernel 7, which computes their Garner digits and sign terms
in its load and scales the kept limbs, still in the NTT domain, by P⁻¹ and
adds (c0, c1) in its store; every kernel in the slot order of
`FastParams.impl`. `fast.rescale` runs the same joint rescale one limb at a
time. On CPU tensors every kernel wrapper runs its plain version
(`backend/cuda/launch.py`); `mul_relin_hybrid_plain` and
`_rescale_joint_plain` run the plain versions on any device, the reference
the kernel path is held against on the card. Sampling follows the JAX package call for call, so one seed gives
bit-identical keys and hints. The Garner lifting, base extension and sign
terms of hybrid.py:78-125, 175-197 (`garner_digits`, `extend_digits`,
`_sign_terms`) live in `backend/modarith.py`, where the plain versions of
the kernels share them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda.mul_relin import (
    garner_pack,
    garner_pack_plain,
    hybrid_digit_stage,
    hybrid_digit_stage_plain,
    tensor_intt,
    tensor_intt_plain,
)
from alchemy_tpu_torch.backend.cuda.rescale import ZP_MAX
from alchemy_tpu_torch.backend.modarith import (
    _add_mod,
    _sub_mod,
    mulmod,
    narrow,
    qcol,
    widen,
)
from alchemy_tpu_torch.nt.primes import find_ntt_prime
from alchemy_tpu_torch.she.fast import (
    FastParams,
    _ntt_p,
    _rescale_joint,
    _residues,
    _uniform,
    kernel_hint,
)
from alchemy_tpu_torch.she.keys import gaussian_coeffs
from alchemy_tpu_torch.utils.profiling import span

# ---------------------------------------------------------------------------
# joint rescale: drop the last k limbs, only they leave the NTT domain
# ---------------------------------------------------------------------------


def rescale_joint(p: FastParams, ct: torch.Tensor, k_drop: int) -> torch.Tensor:
    """Exact BGV rescale by P = ∏ of the last k_drop limbs (hybrid.py:134):
    ct [..., T, n] int32, NTT domain → [..., T − k_drop, n]. zp must be a
    power of two ≤ 2^16. Kernel 9 ("mxu") or 5 ("pallas", "vpu") inverts
    only the k_drop dropped rows; kernel 7 computes their Garner digits and
    sign terms in its load, transforms only the correction −δ·P⁻¹, and
    multiplies the kept rows, still in the NTT domain, by P⁻¹ as it stores.
    The residues equal those of the JAX package's inverse/forward round
    trip. At k_drop = 1 it equals `fast.rescale`."""
    if p.zp > ZP_MAX:
        raise ValueError(f"zp={p.zp}: kernel 7 takes a zp <= {ZP_MAX}")
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


def _mul_relin_hybrid(hk: HybridKS, ct_a, ct_b, hint_b, hint_a, plain: bool) -> torch.Tensor:
    tensor, garner, digit_stage = ((tensor_intt_plain, garner_pack_plain, hybrid_digit_stage_plain)
                                   if plain else (tensor_intt, garner_pack, hybrid_digit_stage))
    with span("mul_relin_hybrid") as root:
        p, pe = hk.p, hk.pe
        L, n = len(p.qs), p.n
        lead = ct_a.shape[:-3]
        shape = (-1, 2, L, n)
        a, b = ct_a.reshape(shape).contiguous(), ct_b.reshape(shape).contiguous()
        if root is not None:
            root.attrs.update(batch=a.shape[0], L=L, n=n)
        c0, c1, c2c = tensor(n, p.qs, a, b, p.order)
        hint_b, hint_a = (kernel_hint(h, (hk.dnum, len(pe.qs), n)) for h in (hint_b, hint_a))
        t01 = digit_stage(n, pe.qs, hk.groups, garner(n, hk.groups, c2c), hint_b, hint_a,
                          p.order)                                   # [2, Bt, T, n]
        out = _rescale_joint(pe, t01, len(hk.ps), plain, (c0, c1))   # [Bt, 2, L, n]
        return out.reshape(*lead, 2, L, n)


def mul_relin_hybrid(hk: HybridKS, ct_a: torch.Tensor, ct_b: torch.Tensor,
                     hint_b, hint_a) -> torch.Tensor:
    """BGV multiply + hybrid relinearization (hybrid.py:334): [..., 2, L, n]
    NTT-domain ciphertexts at the base chain → the same. Hints are raw
    [dnum, T, n] or Shoup pairs (`fast.shoup_precompute` over hk.pe.qs), in
    any layout (`fast.kernel_hint`).
    Kernel A → `garner_pack` → kernel 4 → `rescale_joint` (kernel 9 or 5,
    then kernel 7, which adds (c0, c1) as it stores), in the slot order of
    hk.p.impl; on the card five launches and no torch op. Traced as the
    root span `mul_relin_hybrid` (attributes batch, L, n) over the kernels'
    launch spans and `rescale_joint` (`utils.profiling`)."""
    return _mul_relin_hybrid(hk, ct_a, ct_b, hint_b, hint_a, plain=False)


def mul_relin_hybrid_plain(hk: HybridKS, ct_a: torch.Tensor, ct_b: torch.Tensor,
                           hint_b, hint_a) -> torch.Tensor:
    """`mul_relin_hybrid` through the plain versions of its kernels, on any
    device."""
    return _mul_relin_hybrid(hk, ct_a, ct_b, hint_b, hint_a, plain=True)
