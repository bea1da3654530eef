"""The plain reference that decides `correct` for configurations with
"system": "homomrlwr_jit": ALCHEMY's HomomRLWR (Crockett, Peikert, Sharp,
CCS 2018; the reference's examples/HomomRLWR.hs:29-71) computed in the
clear, and ALCHEMY's BGV decryption of the ciphertexts it judges, in plain
PyTorch int64 (numpy only for the seed's draws). It imports nothing of the
port and takes nothing the port made but those ciphertexts.

Rings. R_m = Z[ζ_m] is the tensor product, over the prime powers p^e of m
in ascending order of p, of Z[x]/Φ_{p^e}(x) (LPR toolkit, Eurocrypt 2013,
§4-6; Λ∘λ, CCS 2016, §4). An element over Z_q is an int64 tensor
[..., φ(m)] of its coefficients in the powerful basis, the tensor of the
factors' bases (x^j, j < φ(p^e)), the first factor slowest.
- product: per axis a polynomial product reduced mod
  Φ_{p^e}(x) = Σ_{i<p} x^{i·p^{e−1}};
- decoding basis: on an odd p, the difference basis of the prime,
  d_0 = 1, d_j = ζ_p^j − ζ_p^{j−1} (ζ_p = x^{p^{e−1}}), tensored with the pure
  powers x^i, i < p^{e−1}; on p = 2 the powerful basis (the convention
  `she/linear.py` of the port states);
- embed R_e → R_s (e | s): x_{p^b} = x_{p^a}^{p^{a−b}} on a prime both have,
  1 on a prime e lacks;
- twace R_m → R_{m'} (m' | m): Tw(x) = (m̂'/m̂)·Tr_{m/m'}((g_m/g_{m'})·x) with
  m̂ = m/2 for even m, else m, and g_m = Π_{odd p | m}(1 − ζ_p), per factor;
  the trace of a root of unity summed over the units (a Ramanujan sum);
- the coefficients of x ∈ R_r over R_e in the relative decoding basis: the
  decoding basis on the odd primes e lacks, pure powers elsewhere;
- an E-linear map R_r → R_s given by the images y_j ∈ R_s of the relative
  decoding basis: f(x) = Σ_j embed(x_j)·y_j.

`ring_round` is ringRound(s·a) in the clear: s·a in R_{zp_in} at the first
plaintext ring, the five maps, then the rescale tree of RescaleTree.hs:58-92
from Z_{2^k} to Z_2: y = x(1 + x), t_z = div2(z(1 − z) + y) for
z = 1 .. 2^(k−2), then the terms multiplied in pairs, each product halved,
until one is left. div2 halves the canonical residue (a floor; the tree
halves even values). `decrypt` is ALCHEMY's: c evaluated at the secret key
in R_{m'} over the ciphertext's moduli, the error term lifted in the
decoding basis (centered), reduced mod p, twaced R_{m'} → R_m, multiplied by
scale⁻¹.

Draws, from `inputs.py`'s streams: s, the secret ring element, is the
message of stream (seed, KEY, first plaintext ring); a_k, the public
element of pool slot k, the message of (seed, CIPHERTEXT, k); the secret key
of a ciphertext ring m', stream (seed, KEY, m'): a rounded Gaussian of
variance r/√φ(m') (ALCHEMY's KeysHints.hs:85-96), r the configuration's
`variance_param`.

One departure: the five maps' images are read from the configuration
(`maps`), which the system checks against the port's `decToCRT`
(Common.hs:65-75) at set-up; the reference does not recompute ALCHEMY's
`crtSet`.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from benchmark import inputs


def _factor(m: int) -> tuple[tuple[int, int], ...]:
    """The prime powers of m as (p, e), ascending in p."""
    out, p = [], 2
    while p * p <= m:
        e = 0
        while m % p == 0:
            m, e = m // p, e + 1
        if e:
            out.append((p, e))
        p += 1
    if m > 1:
        out.append((m, 1))
    return tuple(out)


def _phi(p: int, e: int) -> int:
    return (p - 1) * p ** (e - 1) if e else 1


class Ring:
    """R_m: its prime powers and the tensor shape of an element."""

    def __init__(self, m: int):
        if m < 2:
            raise ValueError(f"m = {m}: the reference's rings have m >= 2")
        self.m = m
        self.factors = _factor(m)
        self.shape = tuple(_phi(p, e) for p, e in self.factors)
        self.phi = math.prod(self.shape)

    def exponent(self, p: int) -> int:
        return dict(self.factors).get(p, 0)

    def unflat(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], *self.shape)

    def flat(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-len(self.shape)], self.phi)


@lru_cache(maxsize=None)
def _reduction(p: int, e: int, device: str) -> torch.Tensor:
    """[2φ − 1, φ]: row t holds the coefficients of x^t mod Φ_{p^e}(x)."""
    n, step = _phi(p, e), p ** (e - 1)
    rows, row = [], [1] + [0] * (n - 1)
    for _ in range(2 * n - 1):
        rows.append(list(row))
        top, row = row[-1], [0] + row[:-1]            # x · row
        for i in range(p - 1):                         # x^n = −Σ_{i<p−1} x^{i·step}
            row[i * step] -= top
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _reduce(full: torch.Tensor, p: int, e: int, dim: int) -> torch.Tensor:
    """[.., 2n − 1 (at dim), ..] polynomial coefficients → [.., n, ..] mod Φ_{p^e}."""
    n = _phi(p, e)
    rows = _reduction(p, e, str(full.device))
    out = full.narrow(dim, 0, n).clone()
    view = [1] * full.dim()
    view[dim] = n
    for t in range(n, 2 * n - 1):
        out += full.select(dim, t).unsqueeze(dim) * rows[t].view(view)
    return out


def _scatter(prod: torch.Tensor, n: int, j_dim: int) -> torch.Tensor:
    """prod [.., n (j), n (l), ..] → [.., 2n − 1 (j + l), ..] summed."""
    shape = list(prod.shape)
    shape[j_dim: j_dim + 2] = [2 * n - 1]
    full = prod.new_zeros(shape)
    for j in range(n):
        full.narrow(j_dim, j, n).add_(prod.select(j_dim, j))
    return full


def _pairs(a: torch.Tensor, b: torch.Tensor, axes, q: int) -> torch.Tensor:
    """The product over the last len(axes) dims of a and b (leading dims
    broadcast), every pair of coefficients at once."""
    if not axes:
        return a * b % q
    (p, e), rest = axes[0], axes[1:]
    k = len(rest)
    prod = _pairs(a.unsqueeze(-k - 1), b.unsqueeze(-k - 2), rest, q)   # [.., n, n, *rest]
    full = _scatter(prod, _phi(p, e), prod.dim() - k - 2)
    return _reduce(full, p, e, full.dim() - k - 1) % q


def mul(ring: Ring, a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """a·b in R_m over Z_q: [..., φ(m)] canonical residues each (leading dims
    broadcast). The first factor's coefficients of a are taken one at a
    time, so the work holds φ(m)²/φ(p_1^e_1) products at once."""
    (p, e), rest = ring.factors[0], ring.factors[1:]
    n, dim = _phi(p, e), -len(rest) - 1
    x, y = ring.unflat(a), ring.unflat(b)
    batch = torch.broadcast_shapes(x.shape[:dim], y.shape[:dim])
    full = x.new_zeros(*batch, 2 * n - 1, *ring.shape[1:])
    for j in range(n):
        full.narrow(dim, j, n).add_(_pairs(x.narrow(dim, j, 1), y, rest, q))   # [.., n, *rest]
    return ring.flat(_reduce(full, p, e, full.dim() + dim) % q)


def add_const(x: torch.Tensor, c: int, q: int) -> torch.Tensor:
    """x + c (the constant c, the first powerful coefficient) mod q."""
    out = x.clone()
    out[..., 0] = (out[..., 0] + c) % q
    return out


def _dec_axes(ring: Ring, skip) -> list[tuple[int, int, int]]:
    """(dim, p, p^(e−1)) of the odd-prime axes not in skip."""
    k = len(ring.factors)
    return [(i - k, p, p ** (e - 1)) for i, (p, e) in enumerate(ring.factors)
            if p != 2 and p not in skip]


def to_dec(ring: Ring, x: torch.Tensor, q: int, skip=()) -> torch.Tensor:
    """Powerful → decoding coordinates on the odd primes not in skip:
    c_j = Σ_{i >= j} b_i along the prime's own sub-axis (b = Σ_j c_j·d_j)."""
    t = ring.unflat(x)
    for dim, p, rest in _dec_axes(ring, skip):
        u = t.unflatten(dim, (p - 1, rest))
        u = u.flip(dim - 1).cumsum(dim - 1).flip(dim - 1)
        t = u.flatten(t.dim() + dim, t.dim() + dim + 1)
    return ring.flat(t % q)


def from_dec(ring: Ring, x: torch.Tensor, q: int, skip=()) -> torch.Tensor:
    """Decoding → powerful coordinates: b_j = c_j − c_{j+1}."""
    t = ring.unflat(x)
    for dim, p, rest in _dec_axes(ring, skip):
        u = t.unflatten(dim, (p - 1, rest))
        v = u.clone()
        v.narrow(dim - 1, 0, p - 2).sub_(u.narrow(dim - 1, 1, p - 2))
        t = v.flatten(t.dim() + dim, t.dim() + dim + 1)
    return ring.flat(t % q)


def embed(small: Ring, big: Ring, x: torch.Tensor) -> torch.Tensor:
    """R_e → R_s, e | s: [..., φ(e)] → [..., φ(s)]."""
    sub, idx = [], [Ellipsis]
    for p, a in big.factors:
        b = small.exponent(p)
        sub += [_phi(p, b), p ** (a - b) if b else _phi(p, a)]
        idx += [slice(None), 0]
    out = x.new_zeros(*x.shape[:-1], big.phi)
    out.view(*x.shape[:-1], *sub)[tuple(idx)] = x.reshape(*x.shape[:-1], *sub[0::2])
    return out


@lru_cache(maxsize=None)
def _trace_unit(n: int, t: int) -> int:
    """Tr_{Q(ζ_n)/Q}(ζ_n^t) = Σ_{u ∈ (Z/n)*} cos(2πtu/n), an integer."""
    v = sum(math.cos(2 * math.pi * t * u / n) for u in range(1, n + 1) if math.gcd(u, n) == 1)
    r = round(v)
    if abs(v - r) > 1e-6:
        raise ArithmeticError(f"trace of zeta_{n}^{t} = {v} is not an integer")
    return r


@lru_cache(maxsize=None)
def _twace_out(p: int, a: int) -> tuple[int, ...]:
    """Tw_{p^a → 1}(x^j), j < φ(p^a): Tr((1 − ζ_p)·ζ^j)/p^a on an odd
    p, Tr(ζ^j)/2^(a−1) on p = 2."""
    n = p ** a
    out = []
    for j in range(_phi(p, a)):
        num = _trace_unit(n, j) - (_trace_unit(n, j + p ** (a - 1)) if p != 2 else 0)
        den = n if p != 2 else n // 2
        if num % den:
            raise ArithmeticError(f"twace of zeta_{n}^{j} is not integral")
        out.append(num // den)
    return tuple(out)


def twace(big: Ring, small: Ring, x: torch.Tensor, q: int) -> torch.Tensor:
    """Tw: R_m → R_{m'}, m' | m: [..., φ(m)] → [..., φ(m')] mod q."""
    t = big.unflat(x)
    after = 0                            # ring axes left after the current one
    for p, a in reversed(big.factors):
        b, dim = small.exponent(p), -after - 1
        if b == 0:
            w = torch.tensor(_twace_out(p, a), dtype=torch.int64, device=t.device)
            t = (t * w.view(-1, *[1] * after)).sum(dim)
            continue
        if b < a:    # x^j ↦ x^(j/p^(a−b)) where p^(a−b) divides j, else 0
            t = t.unflatten(dim, (_phi(p, b), p ** (a - b))).select(dim, 0)
        after += 1
    return small.flat(t % q)


def rel_coeffs(big: Ring, small: Ring, x: torch.Tensor, q: int) -> torch.Tensor:
    """The coefficients of x ∈ R_r over R_e in the relative decoding basis:
    [..., φ(r)] → [..., φ(r)/φ(e), φ(e)], the relative index row-major over
    the factors of r."""
    t = big.unflat(to_dec(big, x, q, skip={p for p, _ in small.factors}))
    split = []
    for p, a in big.factors:
        n_sub = _phi(p, small.exponent(p))
        split += [n_sub, _phi(p, a) // n_sub]
    k = len(big.factors)
    lead = t.dim() - k
    t = t.reshape(*t.shape[:lead], *split)
    rel = [lead + 2 * i + 1 for i in range(k)]
    sub = [lead + 2 * i for i in range(k)]
    t = t.permute(*range(lead), *rel, *sub)
    return t.reshape(*t.shape[:lead], math.prod(split[1::2]), small.phi)


def linear(hop: dict, x: torch.Tensor, q: int) -> torch.Tensor:
    """The E-linear map R_r → R_s of a configuration's `maps` entry (e, r,
    s, images: coefficient lists mod q of R_s) applied to x [..., φ(r)]."""
    r, e, s = Ring(hop["r"]), Ring(hop["e"]), Ring(hop["s"])
    y = torch.tensor(hop["images"], dtype=torch.int64, device=x.device)
    if y.shape != (r.phi // e.phi, s.phi):
        raise ValueError(f"map {hop['r']} -> {hop['s']}: images {tuple(y.shape)}")
    coeffs = embed(e, s, rel_coeffs(r, e, x, q))                  # [..., dim, φ(s)]
    return mul(s, coeffs, y, q).sum(-2) % q


def div2(x: torch.Tensor) -> torch.Tensor:
    """Z_{2q} → Z_q: the canonical residue halved."""
    return x // 2


def rescale_tree(ring: Ring, x: torch.Tensor, k: int) -> torch.Tensor:
    """RescaleTree.hs:58-92 from Z_{2^k} to Z_2 at ring."""
    if k == 1:
        return x
    q = 1 << k
    y = mul(ring, x, add_const(x, 1, q), q)
    terms = [div2(add_const(y, z * (1 - z) % q, q)) for z in range(1, 2 ** (k - 2) + 1)]
    q //= 2
    while len(terms) > 1:
        terms = [div2(mul(ring, a, b, q)) for a, b in zip(terms[0::2], terms[1::2])]
        q //= 2
    return terms[0]


def clear(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """The maps and the rescale tree on x [..., φ(tower[0])] mod zp_in →
    [..., φ(tower[-1])] mod zp_out."""
    k = cfg["tree_depth"]
    if cfg["zp_in"] != 1 << k or cfg["zp_out"] != 2:
        raise ValueError("the rescale tree takes Z_{2^k} to Z_2")
    for hop in cfg["maps"]:
        x = linear(hop, x, cfg["zp_in"])
    return rescale_tree(Ring(cfg["tower"][-1]), x, k)


def ring_round(cfg: dict, s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """ringRound(s·a): s [φ(tower[0])], a [..., φ(tower[0])] mod zp_in →
    [..., φ(tower[-1])] over Z_2."""
    return clear(cfg, mul(Ring(cfg["tower"][0]), s, a, cfg["zp_in"]))


def secret(cfg: dict, seed: int) -> np.ndarray:
    """s, uniform mod zp_in at the first plaintext ring."""
    m = cfg["tower"][0]
    return inputs.message(inputs.stream(seed, inputs.KEY, m), cfg["zp_in"], Ring(m).phi)


def public(cfg: dict, seed: int, slot: int) -> np.ndarray:
    """a of pool slot `slot`, uniform mod zp_in at the first plaintext ring."""
    return inputs.message(inputs.stream(seed, inputs.CIPHERTEXT, slot), cfg["zp_in"],
                          Ring(cfg["tower"][0]).phi)


def key(cfg: dict, seed: int, m: int) -> np.ndarray:
    """The secret key of ciphertext ring m: rounded Gaussian coefficients of
    variance variance_param/√φ(m) (int64, signed)."""
    phi = Ring(m).phi
    rng = inputs.stream(seed, inputs.KEY, m)
    var = cfg["variance_param"] / math.sqrt(phi)
    return np.rint(rng.normal(0.0, math.sqrt(var), size=phi)).astype(np.int64)


def decrypt(big: Ring, small: Ring, ct: torch.Tensor, qs, key_coeffs: np.ndarray, p: int,
            scale: int) -> torch.Tensor:
    """ALCHEMY's BGV decryption of ct [deg + 1, L, φ(m')] (canonical
    residues mod qs, powerful basis) under the key: [φ(m)] over Z_p."""
    dev = ct.device
    digits = []
    for i, q in enumerate(qs):
        s = torch.from_numpy(key_coeffs % q).to(dev)
        acc, s_k = ct[0, i] % q, None
        for c in ct[1:, i]:
            s_k = s if s_k is None else mul(big, s_k, s, q)
            acc = (acc + mul(big, c % q, s_k, q)) % q
        digits.append(to_dec(big, acc, q).cpu().numpy())
    # the centered integer of each decoding coordinate, by CRT over qs
    Q = math.prod(qs)
    e = np.zeros(big.phi, dtype=object)
    for q, d in zip(qs, digits):
        Qi = Q // q
        e = (e + d.astype(object) * (Qi * pow(Qi % q, -1, q))) % Q
    e = np.where(e > Q // 2, e - Q, e)
    lifted = torch.from_numpy(np.array([int(v) % p for v in e], dtype=np.int64)).to(dev)
    mu = twace(big, small, from_dec(big, lifted, p), p)
    return mu * pow(scale % p, -1, p) % p
