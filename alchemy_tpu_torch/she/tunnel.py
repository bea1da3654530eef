"""Ring tunneling (GHPS ring switching): homomorphically evaluate an
E-linear map R_r → R_s while switching keys R_{r'} → R_{s'}.

Rebuild of SymmSHE `tunnel`/`TunnelHint`/`tunnelHint` (SURVEY.md §2.3;
KeysHints.hs:120-129, Eval.hs:127,134; compiled use PT2CT.hs:207-229).

Construction (see DESIGN.md): with e' = e·(r'/r), the relative basis
d_j of R_{r'}/R_{e'} coincides with that of R_r/R_e (validated — for the
decoding basis too: the dec structure sits on primes absent from e, which
the validation pins to be identical between r and r'), and the
induced map f'(d_j) = embed_{s→s'}(ỹ_j) (ỹ = centered-lifted images)
satisfies f'∘embed = embed∘f. The hint publishes gadget encryptions of
f'(d_j·s_in) under s_out; tunneling writes c1 = Σ_j c1_j·d_j and outputs

  out0 = f'(c0) + Σ_{j,k} digit_k(c1_j)·B_{j,k}
  out1 =          Σ_{j,k} digit_k(c1_j)·A_{j,k}

so out0 + out1·s_out = f'(c0 + c1·s_in) + p·noise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.ring import get_ring
from alchemy_tpu_torch.nt.factor import totient
from alchemy_tpu_torch.she.bgv import lift_pt_centered
from alchemy_tpu_torch.she.ct import CT
from alchemy_tpu_torch.she.gadget import Gadget
from alchemy_tpu_torch.she.keys import SK, uniform_residues
from alchemy_tpu_torch.she.linear import LinearMap


def _validate_extension(e: int, r: int, s: int, r_p: int, s_p: int) -> int:
    """Check the GHPS compatibility conditions; return e' = e·(r'/r)."""
    t = r_p // r
    assert r_p % r == 0, (r, r_p)
    e_p = e * t
    if s_p % e_p != 0:
        raise ValueError(f"tunnel: e'={e_p} must divide s'={s_p}")
    if totient(r_p) // totient(e_p) != totient(r) // totient(e):
        raise ValueError("tunnel: relative dimensions of r'/e' and r/e differ")
    rr, ee, rpr, epr = get_ring(r), get_ring(e), get_ring(r_p), get_ring(e_p)
    for f in rpr.factors:
        a_r = rr.factor_exponent(f.p)
        a_rp = f.e
        a_e = ee.factor_exponent(f.p)
        if a_rp != a_r and a_r != a_e:
            raise ValueError(
                f"tunnel: prime {f.p} grows from r to r' while r/e is "
                f"nontrivial there; relative bases would not coincide"
            )
    return e_p


def _rel_basis_elem(m: int, m_sub: int, j: int, qs, bk, basis: str) -> Cyc:
    """The j-th relative basis element of R_m over R_{m_sub}."""
    coeffs = [
        Cyc.constant(m_sub, qs, 1 if k == j else 0, bk)
        for k in range(totient(m) // totient(m_sub))
    ]
    return Cyc.from_rel_coeffs(m, m_sub, coeffs, qs, bk, basis=basis)


def _lift_images(f: LinearMap, s_p: int, qs, bk) -> list[Cyc]:
    """Centered-lifted images ỹ_j embedded into R_{s'} over the chain."""
    out = []
    for y in f.images:
        lifted = lift_pt_centered(y)
        small = Cyc.from_coeffs(f.s, qs, np.stack([lifted % q for q in qs]), bk)
        out.append(small.embed(s_p).to_crt())
    return out


def _f_prime_apply(z: Cyc, e_p: int, s_p: int, images_sp: list[Cyc],
                   basis: str) -> Cyc:
    """f'(z) = Σ_j embed_{e'→s'}(z_j)·ỹ_j for z ∈ R_{r'} (coefficients go
    through one fused embed+CRT batch)."""
    coeffs = [c.to_pow() for c in z.rel_coeffs(e_p, basis=basis)]
    embedded = Cyc.batched_embed_crt(coeffs, s_p)
    acc = None
    for zj, yj in zip(embedded, images_sp):
        term = zj * yj
        acc = term if acc is None else acc + term
    return acc


@dataclass
class TunnelHint:
    f: LinearMap
    e_p: int
    r_p: int
    s_p: int
    qs: tuple[int, ...]
    gadget: Gadget
    zp: int
    images_sp: list[Cyc]  # ỹ_j over qs in R_{s'} (CRT)
    rows: tuple[tuple[tuple[Cyc, Cyc], ...], ...]  # [dim][ndigit] of (B, A)


def tunnel_hint(f: LinearMap, sk_out: SK, sk_in: SK, gadget: Gadget,
                qs: tuple[int, ...], zp: int, rng: np.random.Generator, bk) -> TunnelHint:
    from alchemy_tpu_torch.she.gadget import HybridGad

    if isinstance(gadget, HybridGad):
        raise TypeError(
            "HybridGad is supported for quad-circ relinearization only; "
            "tunnel with TrivGad or BaseBGad (per-op gadget choice, "
            "PT2CT.hs:136-140)")
    r_p, s_p = sk_in.m, sk_out.m
    e_p = _validate_extension(f.e, f.r, f.s, r_p, s_p)
    images_sp = _lift_images(f, s_p, qs, bk)
    s_in = sk_in.as_cyc(qs, bk)
    s_out = sk_out.as_cyc(qs, bk)
    ring_sp = get_ring(s_p)
    factors = gadget.factors(qs)
    rows = []
    for j in range(f.dim):
        d_j = _rel_basis_elem(r_p, e_p, j, qs, bk, f.basis)
        w_j = _f_prime_apply(d_j.to_crt() * s_in.to_crt(), e_p, s_p, images_sp,
                             f.basis)
        digit_rows = []
        for g in factors:
            a = Cyc.from_coeffs(s_p, qs, uniform_residues(rng, qs, ring_sp.phi), bk).to_crt()
            e, _ = sk_out.error(qs, rng, bk)
            b = w_j.scalar_mul(g) + e.scalar_mul(zp).to_crt() - a * s_out.to_crt()
            digit_rows.append((b, a))
        rows.append(tuple(digit_rows))
    return TunnelHint(f, e_p, r_p, s_p, qs, gadget, zp, images_sp, tuple(rows))


def tunnel(hint: TunnelHint, ct: CT) -> CT:
    """Apply the tunnel to a linear ciphertext over R_{r'} encrypting
    x ∈ R_r; result is over R_{s'} encrypting f(x) ∈ R_s."""
    assert ct.degree == 1
    assert ct.qs == hint.qs, (ct.qs, hint.qs)
    assert ct.m == hint.f.r and ct.m_prime == hint.r_p
    c0, c1 = ct.comps
    out0 = _f_prime_apply(c0.to_crt(), hint.e_p, hint.s_p, hint.images_sp,
                          hint.f.basis)
    out1 = None
    c1_coeffs = c1.rel_coeffs(hint.e_p, basis=hint.f.basis)
    # every digit of every coefficient goes through ONE fused embed+CRT pass
    all_digits = []
    rows_flat = []
    for j, zj in enumerate(c1_coeffs):
        digits = hint.gadget.digits(zj)
        for d, row in zip(digits, hint.rows[j]):
            all_digits.append(d)
            rows_flat.append(row)
    all_digits = Cyc.batched_embed_crt(all_digits, hint.s_p)
    for dd, (b, a) in zip(all_digits, rows_flat):
        out0 = out0 + dd * b
        out1 = dd * a if out1 is None else out1 + dd * a
    return CT(m=hint.f.s, zp=ct.zp, scale=ct.scale, comps=(out0, out1))
