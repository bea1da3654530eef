"""The plain reference that decides `correct`: BGV multiply + relinearize
with CRT-gadget (TrivGad) or hybrid key switching, written from the scheme's
definition in plain PyTorch int64 on any device, with its own negacyclic
NTT. It imports nothing of the port and takes nothing the port made: it
replays the seed's draws (`inputs.py`) and works the secret key, the hints
and every ciphertext out again, then judges the port's outputs against its
own, residue for residue, and by decrypting them.

Conventions it shares with the scheme as the port states it (each is part
of what the output is, not of how a kernel computes it):

- residues are canonical, 0 <= x < q, and the NTT domain is the "mxu" slot
  order: slot s holds x(psi^(2K+1)) with K = k1 + n1*k2 for s = k1*n2 + k2,
  n = n1*n2 with n1, n2 <= 256 and n1 the power of two nearest 128, and
  psi = g^((q-1)/2n) for the smallest primitive root g mod q;
- sampling: the key and every error are rint(normal(0, sqrt(variance))),
  a uniform element is one `integers(0, q)` row per limb, in NTT form after
  one forward transform; a hint draws its uniform element before its error,
  as does an encryption; the message lift is centered mod zp;
- TrivGad: gadget digit i of c2 is its canonical residue mod q_i, reduced
  mod every limb; hint i is B_i + A_i*s = g_i*s^2 + zp*e_i with
  g_i = Q_i*(Q_i^-1 mod q_i), Q_i = Q/q_i;
- hybrid: the chain splits into dnum groups of ceil(L/dnum) limbs; digit j
  is the value of c2 mod Q_j in [0, Q_j) (mixed radix), extended to the
  chain Q*P; hint j is B_j + A_j*s = P*g_j*s^2 + zp*e_j over Q*P with
  g_j = (Q/Q_j)*((Q/Q_j)^-1 mod Q_j); the sum is rescaled exactly by P:
  (x - delta)/P with delta = V_c + t*P, V_c the centered value of x mod P
  and t the centered residue of -V_c*P^-1 mod zp.

`float64_mul` is the control's arithmetic: the same reference with every
modular product rounded to float64's 53-bit significand first.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from benchmark import inputs

#: the largest factor of the "mxu" order's two-factor split
MAX_FACTOR = 256


def exact_mul(a, b, q):
    """a*b mod q for residues below 2^31: exact in int64."""
    return a * b % q


def float64_mul(a, b, q):
    """a*b mod q with the product rounded to float64 first (the control)."""
    def f(x):
        return x.to(torch.float64) if torch.is_tensor(x) else float(x)
    return torch.remainder(f(a) * f(b), f(q)).to(torch.int64)


def gaussian(rng: np.random.Generator, variance: float, n: int) -> np.ndarray:
    return np.rint(rng.normal(0.0, math.sqrt(variance), size=n)).astype(np.int64)


def uniform(rng: np.random.Generator, qs, n: int) -> np.ndarray:
    return np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in qs])


def _prime_factors(m: int) -> list[int]:
    fs, d = [], 2
    while d * d <= m:
        if m % d == 0:
            fs.append(d)
            while m % d == 0:
                m //= d
        d += 1
    return fs + ([m] if m > 1 else [])


@lru_cache(maxsize=None)
def root_2n(q: int, n: int) -> int:
    """psi, the primitive 2n-th root of unity mod q of the slot order."""
    fs = _prime_factors(q - 1)
    g = 2
    while any(pow(g, (q - 1) // f, q) == 1 for f in fs):
        g += 1
    return pow(g, (q - 1) // (2 * n), q)


def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    v = np.arange(n, dtype=np.int64)
    out = np.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def slot_exponents(n: int, order: str) -> np.ndarray:
    """K(s) of every slot s: slot s holds x(psi^(2K+1))."""
    if order != "mxu":
        raise ValueError(f"slot order {order!r}: the reference has 'mxu'")
    splits = [(abs(n1 - 128), n1) for n1 in (1 << k for k in range(n.bit_length()))
              if n1 <= MAX_FACTOR and n // n1 <= MAX_FACTOR]
    n1 = min(splits)[1]
    s = np.arange(n, dtype=np.int64)
    return s // (n // n1) + n1 * (s % (n // n1))


class Ring:
    """Negacyclic NTTs of int64 rows [..., L, n] mod each limb of qs, in a
    slot order, with the products of `mul`."""

    def __init__(self, n: int, qs, order: str, device, mul=exact_mul):
        self.n, self.qs, self.mul = n, tuple(qs), mul
        L = len(self.qs)
        pw = np.empty((L, 2 * n), dtype=np.int64)          # psi^e, e < 2n
        for i, q in enumerate(self.qs):
            pw[i, 0], pw[i, 1], k = 1, root_2n(q, n), 2
            while k < 2 * n:
                pw[i, k:2 * k] = pw[i, :k] * pow(int(pw[i, 1]), k, q) % q
                k *= 2
        qcol = np.array(self.qs, dtype=np.int64)[:, None]
        j = np.arange(n)
        n_inv = np.array([[pow(n, -1, q)] for q in self.qs], dtype=np.int64)
        br, K = _bitrev(n), slot_exponents(n, order)
        s_of_K = np.empty(n, dtype=np.int64)
        s_of_K[K] = np.arange(n)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self.q = dev(qcol)
        self.twist = dev(pw[:, j])
        self.untwist = dev(pw[:, (2 * n - j) % (2 * n)] * n_inv % qcol)
        self.fwd_slots, self.inv_slots, self.bitrev = dev(br[K]), dev(s_of_K), dev(br)
        # stage with half-width h: omega^(j*n/(2h)) = psi^(j*n/h), omega = psi^2
        halves = [1 << k for k in range(n.bit_length() - 1)]
        self.fwd_tw = {h: dev(pw[:, np.arange(h) * (n // h)]) for h in halves}
        self.inv_tw = {h: dev(pw[:, (2 * n - np.arange(h) * (n // h)) % (2 * n)])
                       for h in halves}

    def _dft(self, x: torch.Tensor, tws: dict) -> torch.Tensor:
        """Cyclic DFT of each row by decimation in frequency: X[k] lands at
        index bitrev(k)."""
        lead, (L, n) = x.shape[:-2], x.shape[-2:]
        q = self.q.view(L, 1, 1)
        h = n // 2
        while h >= 1:
            x = x.reshape(*lead, L, n // (2 * h), 2, h)
            u, v = x[..., 0, :], x[..., 1, :]
            s = u + v
            x = torch.stack((torch.where(s >= q, s - q, s),
                             self.mul(u - v + q, tws[h].view(L, 1, h), q)), dim=-2)
            h //= 2
        return x.reshape(*lead, L, n)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficients [..., L, n] (canonical) → slot order."""
        return self._dft(self.mul(x, self.twist, self.q), self.fwd_tw)[..., self.fwd_slots]

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Slot order → canonical coefficients."""
        y = self._dft(x[..., self.inv_slots], self.inv_tw)[..., self.bitrev]
        return self.mul(y, self.untwist, self.q)

    def residues(self, x: np.ndarray) -> torch.Tensor:
        """Signed integer coefficients [..., n] → canonical [..., L, n]."""
        q = np.array(self.qs, dtype=np.int64)[:, None]
        return torch.from_numpy(np.asarray(x, dtype=np.int64)[..., None, :] % q).to(self.q.device)


def mixed_radix(res: list, chain, mul) -> list:
    """Mixed-radix digits x_k of the value V in [0, prod(chain)) with the
    given residues: V = sum_k x_k * prod(chain[:k]), 0 <= x_k < chain[k]."""
    xs = [res[0]]
    for k in range(1, len(chain)):
        g = chain[k]
        acc = xs[0] % g
        for j in range(1, k):
            acc = (acc + mul(xs[j], math.prod(chain[:j]) % g, g)) % g
        xs.append(mul((res[k] - acc) % g, pow(math.prod(chain[:k]) % g, -1, g), g))
    return xs


def _above_half(xs: list, chain) -> torch.Tensor:
    """Whether V (its mixed-radix digits xs) exceeds prod(chain)//2."""
    h, hd = math.prod(chain) // 2, []
    for g in chain:
        hd.append(h % g)
        h //= g
    gt = torch.zeros_like(xs[0], dtype=torch.bool)
    eq = torch.ones_like(xs[0], dtype=torch.bool)
    for k in range(len(chain) - 1, -1, -1):
        gt = gt | (eq & (xs[k] > hd[k]))
        eq = eq & (xs[k] == hd[k])
    return gt


def _extend(xs: list, chain, ring: Ring) -> torch.Tensor:
    """V mod every limb of ring from V's mixed-radix digits: [..., L, n]."""
    out = None
    for k, x in enumerate(xs):
        pik = torch.tensor([math.prod(chain[:k]) % q for q in ring.qs],
                           dtype=torch.int64, device=x.device)[:, None]
        term = ring.mul(x[..., None, :] % ring.q, pik, ring.q)
        out = term if out is None else (out + term) % ring.q
    return out


def tensor_product(ring: Ring, ct_a: torch.Tensor, ct_b: torch.Tensor):
    """(c0, c1, c2) of [B, 2, L, n] x [B, 2, L, n] in the NTT domain."""
    mul, q = ring.mul, ring.q
    a0, a1, b0, b1 = ct_a[:, 0], ct_a[:, 1], ct_b[:, 0], ct_b[:, 1]
    return mul(a0, b0, q), (mul(a0, b1, q) + mul(a1, b0, q)) % q, mul(a1, b1, q)


def mul_relin_trivgad(ring: Ring, ct_a, ct_b, hb, ha) -> torch.Tensor:
    """[B, 2, L, n] x [B, 2, L, n] → [B, 2, L, n]; hints [L, L, n]."""
    mul, q = ring.mul, ring.q
    out0, out1, c2 = tensor_product(ring, ct_a, ct_b)
    c2c = ring.intt(c2)
    for i in range(len(ring.qs)):
        d = ring.ntt(c2c[:, i:i + 1] % q)
        out0 = (out0 + mul(d, hb[i], q)) % q
        out1 = (out1 + mul(d, ha[i], q)) % q
    return torch.stack((out0, out1), dim=1)


def groups_of(qs, dnum: int) -> list:
    alpha = -(-len(qs) // dnum)
    return [tuple(qs[i:i + alpha]) for i in range(0, len(qs), alpha)]


def rescale_exact(ring_ext: Ring, ring: Ring, x: torch.Tensor, zp: int) -> torch.Tensor:
    """Exact BGV rescale of [..., T, n] (NTT domain over ring_ext) by P, the
    product of ring_ext's limbs beyond ring's: → [..., L, n] over ring."""
    mul, L = ring.mul, len(ring.qs)
    drop = ring_ext.qs[L:]
    P = math.prod(drop)
    coeff = ring_ext.intt(x)
    ys = mixed_radix([coeff[..., L + k, :] for k in range(len(drop))], drop, mul)
    neg = _above_half(ys, drop)
    vz = sum(ys[k] % zp * (math.prod(drop[:k]) % zp) for k in range(len(drop))) % zp
    vz = torch.where(neg, (vz - P % zp) % zp, vz)
    t = (-vz) * pow(P % zp, -1, zp) % zp
    tc = torch.where(t > zp // 2, t - zp, t)[..., None, :]
    q = ring.q
    p_mod = torch.tensor([P % qj for qj in ring.qs], dtype=torch.int64, device=q.device)[:, None]
    p_inv = torch.tensor([pow(P % qj, -1, qj) for qj in ring.qs], dtype=torch.int64,
                         device=q.device)[:, None]
    v = _extend(ys, drop, ring)
    v = torch.where(neg[..., None, :], (v - p_mod) % q, v)
    delta = (v + mul(tc % q, p_mod, q)) % q
    return ring.ntt(mul((coeff[..., :L, :] - delta) % q, p_inv, q))


def mul_relin_hybrid(ring: Ring, ring_ext: Ring, dnum: int, zp: int, ct_a, ct_b, hb,
                     ha) -> torch.Tensor:
    """[B, 2, L, n] x [B, 2, L, n] → [B, 2, L, n]; hints [dnum, T, n]."""
    mul, qe = ring.mul, ring_ext.q
    c0, c1, c2 = tensor_product(ring, ct_a, ct_b)
    c2c = ring.intt(c2)
    t0 = t1 = 0
    off = 0
    for j, grp in enumerate(groups_of(ring.qs, dnum)):
        xs = mixed_radix([c2c[:, off + k] for k in range(len(grp))], grp, mul)
        off += len(grp)
        d = ring_ext.ntt(_extend(xs, grp, ring_ext))
        t0 = (t0 + mul(d, hb[j], qe)) % qe
        t1 = (t1 + mul(d, ha[j], qe)) % qe
    r = rescale_exact(ring_ext, ring, torch.stack((t0, t1), dim=1), zp)
    return torch.stack(((c0 + r[:, 0]) % ring.q, (c1 + r[:, 1]) % ring.q), dim=1)


# ---------------------------------------------------------------------------
# keys, hints and ciphertexts from the seed
# ---------------------------------------------------------------------------


class Keys:
    """The secret key and the relinearization hint of a configuration, worked
    out from the seed: s (NTT domain over the base chain), hb and ha."""

    def __init__(self, cfg: dict, seed: int, device, mul=exact_mul):
        n, zp, var = cfg["n"], cfg["zp"], cfg["variance"]
        self.ring = Ring(n, cfg["qs"], cfg["order"], device, mul)
        rng = inputs.stream(seed, inputs.KEY)
        s = gaussian(rng, var, n)
        self.s = self.ring.ntt(self.ring.residues(s))
        if cfg["key_switching"] == "trivgad":
            self.ring_ext = None
            self.hb, self.ha = self._trivgad(cfg, inputs.stream(seed, inputs.HINT))
        else:
            self.ring_ext = Ring(n, cfg["qs"] + cfg["special_primes"], cfg["order"], device, mul)
            self.hb, self.ha = self._hybrid(cfg, s, rng)

    def _hint(self, ring: Ring, s: torch.Tensor, g: int, rng, zp: int, var: float):
        a = ring.ntt(torch.from_numpy(uniform(rng, ring.qs, ring.n)).to(s.device))
        e = ring.ntt(ring.residues(gaussian(rng, var, ring.n) * zp))
        g_col = torch.tensor([g % q for q in ring.qs], dtype=torch.int64, device=s.device)
        b = (ring.mul(ring.mul(s, s, ring.q), g_col[:, None], ring.q) + e
             - ring.mul(a, s, ring.q)) % ring.q
        return b, a

    def _trivgad(self, cfg, rng):
        qs, Q = cfg["qs"], math.prod(cfg["qs"])
        bs, as_ = zip(*(self._hint(self.ring, self.s, (Q // qi) * pow(Q // qi % qi, -1, qi) % Q,
                                   rng, cfg["zp"], cfg["variance"]) for qi in qs))
        return torch.stack(bs), torch.stack(as_)

    def _hybrid(self, cfg, s_coeffs, rng):
        ring = self.ring_ext
        s = ring.ntt(ring.residues(s_coeffs))
        Q, P = math.prod(cfg["qs"]), math.prod(cfg["special_primes"])
        bs, as_ = [], []
        for grp in groups_of(cfg["qs"], cfg["dnum"]):
            Qj = math.prod(grp)
            Qi = Q // Qj
            g = P * (Qi * pow(Qi % Qj, -1, Qj) % Q) % (Q * P)
            b, a = self._hint(ring, s, g, rng, cfg["zp"], cfg["variance"])
            bs.append(b)
            as_.append(a)
        return torch.stack(bs), torch.stack(as_)

    def encrypt(self, cfg: dict, seed: int, indices) -> tuple[torch.Tensor, np.ndarray]:
        """The pool's ciphertexts `indices` [k, 2, L, n] and their centered
        message lifts [k, n]."""
        ring, zp, var, n = self.ring, cfg["zp"], cfg["variance"], cfg["n"]
        lifts, us, es = [], [], []
        for i in indices:
            rng = inputs.stream(seed, inputs.CIPHERTEXT, i)
            m = inputs.message(rng, zp, n) % zp
            lifts.append(np.where(m > zp // 2, m - zp, m))
            us.append(uniform(rng, ring.qs, n))
            es.append(gaussian(rng, var, n))
        lifts = np.stack(lifts)
        a = ring.ntt(torch.from_numpy(np.stack(us)).to(self.s.device))
        mu_e = ring.ntt(ring.residues(lifts + zp * np.stack(es)))
        c0 = (mu_e - ring.mul(a, self.s, ring.q)) % ring.q
        return torch.stack((c0, a), dim=1), lifts

    def mul_relin(self, cfg: dict, ct_a, ct_b) -> torch.Tensor:
        if self.ring_ext is None:
            return mul_relin_trivgad(self.ring, ct_a, ct_b, self.hb, self.ha)
        return mul_relin_hybrid(self.ring, self.ring_ext, cfg["dnum"], cfg["zp"], ct_a, ct_b,
                                self.hb, self.ha)

    def decrypt(self, ct: torch.Tensor, zp: int) -> torch.Tensor:
        """[B, 2, L, n] → the messages [B, n] mod zp (centered CRT lift)."""
        ring = self.ring
        coeff = ring.intt((ct[:, 0] + ring.mul(ct[:, 1], self.s, ring.q)) % ring.q)
        xs = mixed_radix([coeff[:, k] for k in range(len(ring.qs))], ring.qs, ring.mul)
        v = sum(xs[k] % zp * (math.prod(ring.qs[:k]) % zp) for k in range(len(ring.qs))) % zp
        return torch.where(_above_half(xs, ring.qs), (v - math.prod(ring.qs) % zp) % zp, v)


def negacyclic_mod(m_a: np.ndarray, m_b: np.ndarray, q: int, zp: int, device) -> torch.Tensor:
    """m_a*m_b in Z_zp[X]/(X^n + 1), rows [B, n] of small centered integers,
    through one NTT prime q > 2*n*(zp/2)^2."""
    ring = Ring(m_a.shape[-1], (q,), "mxu", device)
    prod = ring.intt(ring.mul(ring.ntt(ring.residues(m_a)), ring.ntt(ring.residues(m_b)),
                              ring.q))[:, 0]
    return torch.where(prod > q // 2, prod - q, prod) % zp


def judge(cfg: dict, traffic: dict, seed: int, kept: dict, device) -> dict:
    """Compare the outputs the window kept ({call index: [batch, 2, L, n]
    int32}) with the reference's: residues that differ (`mismatch`),
    decrypted coefficients that are not m_a*m_b mod zp (`bad_slots`), and
    the count of calls compared."""
    keys = Keys(cfg, seed, device)
    batch, slots = traffic["batch"], inputs.pool_slots(cfg, traffic)
    by_slot: dict[int, list] = {}
    for k, out in kept.items():
        by_slot.setdefault(k % slots, []).append(out)
    mismatch = bad = 0
    for slot, outs in sorted(by_slot.items()):
        ct_a, lift_a = keys.encrypt(cfg, seed, [inputs.ciphertext_index(slot, 0, r, batch)
                                                for r in range(batch)])
        ct_b, lift_b = keys.encrypt(cfg, seed, [inputs.ciphertext_index(slot, 1, r, batch)
                                                for r in range(batch)])
        want = keys.mul_relin(cfg, ct_a, ct_b)
        want_msg = negacyclic_mod(lift_a, lift_b, cfg["qs"][0], cfg["zp"], device)
        for out in outs:
            got = (out.to(device=want.device, dtype=torch.int64) & 0xFFFFFFFF).reshape(want.shape)
            mismatch += int((got != want).sum())
            bad += int((keys.decrypt(got, cfg["zp"]) != want_msg).sum())
        del want
    return {"mismatch": mismatch, "bad_slots": bad, "compared_calls": len(kept)}
