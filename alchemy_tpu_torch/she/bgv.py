"""BGV symmetric-key homomorphic operations.

This is the rebuild of the consumed `Crypto.Lol.Applications.SymmSHE` surface
(SURVEY.md §2.3 table 2): encrypt/decrypt, add, mul, addPublic/mulPublic,
modSwitch (RNS rescale, both directions), modSwitchPT (plaintext-modulus
switch = the compiled `div2_`), keySwitchQuadCirc with gadget hints, and the
error-term probe. Ring tunneling lives in she/tunnel.py.

Semantics are pinned by the self-differential oracle (SURVEY.md §4): the
plaintext interpreter and the homomorphic pipeline must agree after decrypt.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from alchemy_tpu_torch.core.cyc import Cyc, crt_lift_host
from alchemy_tpu_torch.core.ring import get_ring, twace_factor_matrix
from alchemy_tpu_torch.she.ct import CT
from alchemy_tpu_torch.she.gadget import Gadget
from alchemy_tpu_torch.she.keys import SK, uniform_residues

# ---------------------------------------------------------------------------
# plaintext lifting helpers
# ---------------------------------------------------------------------------


def lift_pt_centered(pt: Cyc) -> np.ndarray:
    """Centered integer lift of a plaintext element (single limb mod p)."""
    assert pt.nlimb == 1
    arr = pt.bk.to_numpy(pt.to_pow().data)[0].astype(np.int64)
    p = pt.qs[0]
    return np.where(arr > p // 2, arr - p, arr)


def embed_pt(pt: Cyc, m_prime: int, qs: tuple[int, ...], scale: int = 1,
             out_bk=None) -> Cyc:
    """Embed scale·(plaintext mod p) into R_{m'} over the ciphertext chain,
    via the centered lift (small-norm representative).

    Computed entirely on the golden (numpy) backend — the plaintext is a
    compile-time constant — then re-homed to `out_bk` (defaults to the
    plaintext's)."""
    from alchemy_tpu_torch.backend import golden_backend

    gb = golden_backend()
    out_bk = out_bk or pt.bk
    p = pt.qs[0]
    pt_g = Cyc(pt.ring, pt.qs, pt.basis, gb.asarray(pt.bk.to_numpy(pt.data), pt.qs), gb)
    scaled = pt_g.scalar_mul(scale % p)
    lifted = lift_pt_centered(scaled)
    small = Cyc.from_coeffs(pt.m, qs, np.stack([lifted % q for q in qs]), gb)
    emb = small.embed(m_prime).to_pow()
    return Cyc(emb.ring, emb.qs, emb.basis,
               out_bk.asarray(gb.to_numpy(emb.data), emb.qs), out_bk)


def twace_int_host(arr: np.ndarray, m: int, m_sub: int, p: int) -> np.ndarray:
    """Exact integer twace R_m → R_{m_sub} on signed host coefficients,
    reduced mod p: int64 in [0, p). The values stay Python ints until the
    reduction, so an error term past 2^63 decrypts (the JAX package's int64
    cast raises there)."""
    ring, sub = get_ring(m), get_ring(m_sub)
    x = arr.astype(object).reshape(ring.shape)
    for ax, f in enumerate(ring.factors):
        M = twace_factor_matrix(f.p, f.e, sub.factor_exponent(f.p)).astype(object)
        x = np.moveaxis(np.tensordot(M, np.moveaxis(x, ax, 0), axes=(1, 0)), 0, ax)
    return np.asarray([int(v) % p for v in x.reshape(-1)], dtype=np.int64)


# ---------------------------------------------------------------------------
# encrypt / decrypt / error term
# ---------------------------------------------------------------------------


def encrypt(sk: SK, pt: Cyc, m_prime: int, qs: tuple[int, ...], rng: np.random.Generator) -> CT:
    """c = (µ̃ + p·e − a·s, a) so that c0 + c1·s = µ̃ + p·e (mod Q)."""
    p = pt.qs[0]
    bk = pt.bk
    ring = get_ring(m_prime)
    a = Cyc.from_coeffs(m_prime, qs, uniform_residues(rng, qs, ring.phi), bk)
    e, _ = sk.error(qs, rng, bk)
    s = sk.as_cyc(qs, bk)
    mu = embed_pt(pt, m_prime, qs)
    c0 = mu + e.scalar_mul(p) - (a * s)
    return CT(m=pt.m, zp=p, scale=1, comps=(c0, a))


def error_term_int(sk: SK, ct: CT) -> np.ndarray:
    """Centered integer coefficients of Σ c_k s^k mod Q (host, exact).
    Counterpart of Lol `errorTermUnrestricted` (Eval.hs:150-160)."""
    s = sk.as_cyc(ct.qs, ct.bk)
    acc = ct.comps[0]
    spow = None
    for k in range(1, len(ct.comps)):
        spow = s if spow is None else spow * s
        acc = acc + ct.comps[k] * spow
    return np.asarray(crt_lift_host(acc), dtype=object)


def error_rate(sk: SK, ct: CT) -> float:
    """max |e_i| / Q (Eval.hs:158-160)."""
    e = error_term_int(sk, ct)
    Q = 1
    for q in ct.qs:
        Q *= q
    return float(max(abs(int(v)) for v in e) / Q)


def decrypt(sk: SK, ct: CT) -> Cyc:
    """Recover µ ∈ R_m over Z_p: twace(centered error term mod p)/scale."""
    e = error_term_int(sk, ct)
    p = ct.zp
    e_sub = twace_int_host(e, ct.m_prime, ct.m, p)
    inv_scale = pow(ct.scale % p, -1, p)
    return Cyc.from_coeffs(ct.m, (p,), e_sub * inv_scale % p, ct.bk)


# ---------------------------------------------------------------------------
# linear homomorphic ops
# ---------------------------------------------------------------------------


def _match_scales(a: CT, b: CT) -> tuple[CT, CT]:
    if a.scale == b.scale:
        return a, b
    # adjust b's payload to a's scale: multiply components by scale_a/scale_b
    f = a.scale * pow(b.scale, -1, b.zp) % b.zp
    fb = _scalar_int_mul(b, f)
    return a, fb.with_comps(fb.comps, scale=a.scale)


def _scalar_int_mul(ct: CT, k: int) -> CT:
    """Multiply every component by the centered lift of k mod p."""
    kc = k % ct.zp
    if kc > ct.zp // 2:
        kc -= ct.zp
    return ct.with_comps(tuple(c.scalar_mul(kc) for c in ct.comps))


def add(a: CT, b: CT) -> CT:
    assert (a.m, a.zp, a.qs, a.m_prime) == (b.m, b.zp, b.qs, b.m_prime)
    a, b = _match_scales(a, b)
    n = max(len(a.comps), len(b.comps))
    comps = []
    for i in range(n):
        if i < len(a.comps) and i < len(b.comps):
            comps.append(a.comps[i] + b.comps[i])
        else:
            comps.append(a.comps[i] if i < len(a.comps) else b.comps[i])
    return a.with_comps(comps)


def neg(a: CT) -> CT:
    return a.with_comps(tuple(-c for c in a.comps))


def mul(a: CT, b: CT) -> CT:
    """Tensor product: (a0,a1)·(b0,b1) = (a0b0, a0b1+a1b0, a1b1),
    decrypting against (1, s, s²). Requires linear inputs."""
    assert a.degree == 1 and b.degree == 1
    assert (a.m, a.zp, a.qs, a.m_prime) == (b.m, b.zp, b.qs, b.m_prime)
    a0, a1 = (c.to_crt() for c in a.comps)
    b0, b1 = (c.to_crt() for c in b.comps)
    comps = (a0 * b0, a0 * b1 + a1 * b0, a1 * b1)
    return CT(m=a.m, zp=a.zp, scale=a.scale * b.scale % a.zp, comps=comps)


def add_public(pt: Cyc, ct: CT) -> CT:
    """ct + public plaintext (SymmSHE addPublic)."""
    mu = embed_pt(pt, ct.m_prime, ct.qs, scale=ct.scale, out_bk=ct.bk)
    comps = list(ct.comps)
    comps[0] = comps[0] + mu
    return ct.with_comps(comps)


def mul_public(pt: Cyc, ct: CT) -> CT:
    """ct · public plaintext (SymmSHE mulPublic): multiply every component by
    the centered-lifted embedding of the plaintext."""
    mu = embed_pt(pt, ct.m_prime, ct.qs, scale=1, out_bk=ct.bk)
    return ct.with_comps(tuple(c * mu for c in ct.comps))


# ---------------------------------------------------------------------------
# modulus switching
# ---------------------------------------------------------------------------


def _rescale_drop_last(c: Cyc, zp: int) -> Cyc:
    """Drop the last limb q_k: c' = (c − δ)/q_k with δ ≡ c (mod q_k),
    δ ≡ 0 (mod p), δ small. Exact, elementwise, no base extension
    (device-resident on the torch backend)."""
    x = c.to_pow()
    new_qs = c.qs[:-1]
    out = c.bk.rescale_step(x.data, c.qs, zp)
    return Cyc(c.ring, new_qs, "POW", out, c.bk)


def mod_switch(ct: CT, new_qs: tuple[int, ...]) -> CT:
    """Switch to another prefix of the chain (either direction; SymmSHE
    modSwitch). Down: iterated exact rescale; up: exact scaling by the new
    limbs' product (new limbs are ≡ 0)."""
    old, new = ct.qs, tuple(new_qs)
    if old == new:
        return ct
    if len(new) < len(old):
        assert new == old[: len(new)], "modSwitch target must be a chain prefix"
        p = ct.zp
        comps = list(ct.comps)
        scale = ct.scale
        for drop in range(len(old) - len(new)):
            qk = comps[0].qs[-1]
            comps = [_rescale_drop_last(c, p) for c in comps]
            scale = scale * pow(qk, -1, p) % p
        return ct.with_comps(comps, scale=scale)
    assert old == new[: len(old)], "modSwitch source must be a chain prefix"
    d = 1
    for q in new[len(old):]:
        d *= q
    bk = ct.bk
    comps = []
    for c in ct.comps:
        x = c.to_pow()
        comps.append(Cyc(c.ring, new, "POW", bk.modswitch_up(x.data, old, new), bk))
    return ct.with_comps(comps, scale=ct.scale * (d % ct.zp) % ct.zp)


def mod_switch_pt(ct: CT) -> CT:
    """Plaintext-modulus switch Z_{2^{k+1}} → Z_{2^k} (SymmSHE modSwitchPT;
    compiled target of `div2_`, PT2CT.hs:179-189): multiply by 2^{-1} mod Q.
    Exact when the scaled plaintext is even (the RescaleTree contract)."""
    p = ct.zp
    assert p % 2 == 0 and p > 2, f"modSwitchPT needs p = 2^k, k>=2: {p}"
    inv2 = [(q + 1) // 2 for q in ct.qs]
    comps = tuple(
        c.like(c.bk.mul_const(c.data, [iv for iv in inv2], c.qs)) for c in ct.comps
    )
    return CT(m=ct.m, zp=p // 2, scale=ct.scale % (p // 2), comps=comps)


# ---------------------------------------------------------------------------
# key switching
# ---------------------------------------------------------------------------


@dataclass
class KSQuadCircHint:
    """Gadget 'encryption' of s² under s at the hint modulus
    (SymmSHE KSQuadCircHint; KeysHints.hs:101-113). For a HybridGad the
    rows live at the EXTENDED chain qs+ps (ext_qs) and encrypt P·ĝ_j·s²."""

    m_prime: int
    qs: tuple[int, ...]
    gadget: Gadget
    zp: int
    rows: tuple[tuple[Cyc, Cyc], ...]  # per digit: (b_k, a_k)
    ext_qs: tuple[int, ...] | None = None


def ks_quad_circ_hint(sk: SK, gadget: Gadget, qs: tuple[int, ...], zp: int,
                      rng: np.random.Generator, bk) -> KSQuadCircHint:
    from alchemy_tpu_torch.she.gadget import HybridGad

    if isinstance(gadget, HybridGad):
        return _hybrid_quad_hint(sk, gadget, qs, zp, rng, bk)
    s = sk.as_cyc(qs, bk)
    s2 = s * s
    factors = gadget.factors(qs)
    ring = get_ring(sk.m)
    rows = []
    for g in factors:
        a = Cyc.from_coeffs(sk.m, qs, uniform_residues(rng, qs, ring.phi), bk)
        e, _ = sk.error(qs, rng, bk)
        gs2 = s2.scalar_mul(g)
        b = gs2 + e.scalar_mul(zp) - a * s
        rows.append((b.to_crt(), a.to_crt()))
    return KSQuadCircHint(sk.m, qs, gadget, zp, tuple(rows))


def _hybrid_quad_hint(sk: SK, gadget, qs: tuple[int, ...], zp: int,
                      rng: np.random.Generator, bk) -> KSQuadCircHint:
    """Hybrid hint rows at the extended chain: B_j + A_j·s = P·ĝ_j·s² + zp·e_j
    (mod Q·P) — she/hybrid.py hybrid_relin_hint over general cyclotomics."""
    ps = gadget.special_primes(qs, sk.m)
    ext = tuple(qs) + ps
    P = 1
    for g in ps:
        P *= g
    Q = 1
    for q in qs:
        Q *= q
    s = sk.as_cyc(ext, bk)
    s2 = s * s
    ring = get_ring(sk.m)
    rows = []
    for g_hat in gadget.factors(qs):
        g = P * g_hat % (Q * P)
        a = Cyc.from_coeffs(sk.m, ext, uniform_residues(rng, ext, ring.phi), bk)
        e, _ = sk.error(ext, rng, bk)
        b = s2.scalar_mul(g) + e.scalar_mul(zp) - a * s
        rows.append((b.to_crt(), a.to_crt()))
    return KSQuadCircHint(sk.m, tuple(qs), gadget, zp, tuple(rows), ext_qs=ext)


def key_switch_quad(hint: KSQuadCircHint, ct: CT) -> CT:
    """Re-linearize a quadratic ciphertext (SymmSHE keySwitchQuadCirc).
    All gadget digits go through ONE batched CRT transform. Hybrid hints
    run the extended-modulus dataflow: group-Garner digits extended to
    Q·P, hint inner product at Q·P, exact rescale by P back to Q."""
    assert ct.degree == 2
    assert ct.qs == hint.qs, (ct.qs, hint.qs)
    c0, c1, c2 = ct.comps
    if hint.ext_qs is not None:
        return _key_switch_quad_hybrid(hint, ct)
    digits = Cyc.batched_to_basis(hint.gadget.digits(c2), "CRT")
    acc0, acc1 = c0.to_crt(), c1.to_crt()
    for dc, (b, a) in zip(digits, hint.rows):
        acc0 = acc0 + dc * b
        acc1 = acc1 + dc * a
    return ct.with_comps((acc0, acc1))


def _key_switch_quad_hybrid(hint: KSQuadCircHint, ct: CT) -> CT:
    c0, c1, c2 = ct.comps
    ext = hint.ext_qs
    ps = ext[len(ct.qs):]
    bk = ct.bk
    x = c2.to_pow()
    groups = hint.gadget.groups_of(ct.qs)
    dig_rows = bk.hybrid_digit_rows(x.data, ct.qs, groups, ext)
    ring = x.ring
    t0 = t1 = None
    for j, (b, a) in enumerate(hint.rows):
        dc = Cyc(ring, ext, "POW", dig_rows[j], bk).to_crt()
        u0, u1 = dc * b, dc * a
        t0 = u0 if t0 is None else t0 + u0
        t1 = u1 if t1 is None else t1 + u1
    # exact rescale by P = ∏ ps: iterated one-limb drops (she/bgv.py
    # _rescale_drop_last semantics); the payload's P factor cancels
    for _ in ps:
        t0 = _rescale_drop_last(t0, hint.zp)
        t1 = _rescale_drop_last(t1, hint.zp)
    return ct.with_comps((c0.to_crt() + t0.to_crt(), c1.to_crt() + t1.to_crt()))
