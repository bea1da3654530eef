"""Cyclotomic ring elements (`Cyc`) over an RNS residue system.

Counterpart of Lol's `Cyc t m r` (SURVEY.md §2.3): a lazy multi-basis
representation of an element of the m-th cyclotomic ring, over either an RNS
chain of NTT-friendly primes (ciphertext side) or a single small modulus
(plaintext side, e.g. Z_{2^k} or Z_7).

Data: backend array [nlimb, φ(m)] of residues; `basis` is "POW" (powerful /
tensor coefficients) or "CRT" (slot values). Transforms, embeddings, traces
and relative-coefficient extraction are all per-axis operations of the tensor
decomposition (see core/ring.py).

A copy of `alchemy_tpu/core/cyc.py` whose data may be a numpy array (the
golden backend), a torch tensor (`backend/torch_backend.py`) or a checked
pair: axis permutations go through `_permute`, since torch's `transpose`
swaps two dims.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from alchemy_tpu_torch.core.ring import (
    CycRing,
    crt_factor_matrix,
    get_ring,
    icrt_factor_matrix,
    twace_factor_matrix,
)
from alchemy_tpu_torch.nt.factor import is_prime
from alchemy_tpu_torch.nt.primes import find_ntt_prime

POW = "POW"
CRT = "CRT"


@lru_cache(maxsize=None)
def _ntt_friendly(m: int, q: int) -> bool:
    return m == 1 or ((q - 1) % m == 0 and is_prime(q))


@lru_cache(maxsize=None)
def _embed_axis_matrix(p: int, a: int, b: int, basis: str) -> np.ndarray:
    """Embedding matrix for one prime axis: source exponent b → target a
    (b = 0 when the prime is absent from the source; source axis length 1)."""
    from alchemy_tpu_torch.nt.factor import totient

    phi_a = totient(p**a)
    phi_b = totient(p**b) if b >= 1 else 1
    E = np.zeros((phi_a, phi_b), dtype=np.int64)
    if basis == POW:
        if b == 0:
            E[0, 0] = 1
        else:
            step = p ** (a - b)
            for i in range(phi_b):
                E[i * step, i] = 1
    else:  # CRT: slot u' takes the value of slot (u' mod p^b)
        from alchemy_tpu_torch.nt.factor import factor_unit_order

        if b == 0:
            E[:, 0] = 1
        else:
            order_a = factor_unit_order(p**a)
            order_b = {u: i for i, u in enumerate(factor_unit_order(p**b))}
            for ia, u in enumerate(order_a):
                E[ia, order_b[u % (p**b)]] = 1
    return E


class Cyc:
    """An element of the m-th cyclotomic ring over per-limb moduli `qs`."""

    __slots__ = ("ring", "qs", "basis", "data", "bk")

    def __init__(self, ring: CycRing, qs: tuple[int, ...], basis: str, data, bk):
        self.ring = ring
        self.qs = tuple(int(q) for q in qs)
        self.basis = basis
        self.data = data
        self.bk = bk

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_coeffs(m: int, qs, coeffs, bk, basis: str = POW) -> "Cyc":
        ring = get_ring(m)
        qs = tuple(int(q) for q in qs)
        arr = np.asarray(coeffs, dtype=np.int64)
        if arr.ndim == 1:
            assert arr.shape[0] == ring.phi, (arr.shape, ring.phi)
        else:
            assert arr.shape == (len(qs), ring.phi)
        return Cyc(ring, qs, basis, bk.asarray(arr, qs), bk)

    @staticmethod
    def constant(m: int, qs, value: int, bk) -> "Cyc":
        ring = get_ring(m)
        coeffs = np.zeros(ring.phi, dtype=np.int64)
        coeffs[0] = value
        return Cyc.from_coeffs(m, qs, coeffs, bk)

    @staticmethod
    def zero(m: int, qs, bk) -> "Cyc":
        ring = get_ring(m)
        qs = tuple(int(q) for q in qs)
        return Cyc(ring, qs, POW, bk.zeros(len(qs), ring.phi), bk)

    def like(self, data, basis=None, ring=None, qs=None) -> "Cyc":
        return Cyc(ring or self.ring, qs or self.qs, basis or self.basis, data, self.bk)

    @property
    def m(self) -> int:
        return self.ring.m

    @property
    def nlimb(self) -> int:
        return len(self.qs)

    def __repr__(self):
        return f"Cyc(m={self.m}, qs={self.qs}, basis={self.basis})"

    # -- basis conversion ---------------------------------------------------

    def _check_ntt(self):
        for q in self.qs:
            if not _ntt_friendly(self.m, q):
                raise ValueError(
                    f"modulus {q} does not support the CRT basis for m={self.m}"
                )

    def to_pow(self) -> "Cyc":
        if self.basis == POW:
            return self
        mats = [
            [icrt_factor_matrix(f.pe, q) for q in self.qs] for f in self.ring.factors
        ] or [None]
        data = self.bk.axis_matmul(self.data, mats, self.ring.shape, self.qs)
        return self.like(data, basis=POW)

    def to_crt(self) -> "Cyc":
        if self.basis == CRT:
            return self
        self._check_ntt()
        mats = [
            [crt_factor_matrix(f.pe, q) for q in self.qs] for f in self.ring.factors
        ] or [None]
        data = self.bk.axis_matmul(self.data, mats, self.ring.shape, self.qs)
        return self.like(data, basis=CRT)

    def to_basis(self, basis: str) -> "Cyc":
        return self.to_pow() if basis == POW else self.to_crt()

    @staticmethod
    def batched_embed_crt(cycs: list["Cyc"], m_target: int) -> list["Cyc"]:
        """Embed many same-ring POW elements into R_{m_target} AND convert to
        the CRT basis in one fused per-axis matmul pass (per-axis matrices
        CRT∘embed precomputed mod each limb). The workhorse of tunnel digit
        fan-out."""
        if not cycs:
            return []
        first = cycs[0]
        src_ring, qs, bk = first.ring, first.qs, first.bk
        tgt = get_ring(m_target)
        tgt.check_subring(src_ring)
        assert all(c.ring is src_ring and c.qs == qs and c.basis == POW for c in cycs)
        mats, src_shape = _fused_embed_crt_mats(src_ring.m, m_target, qs)
        B = len(cycs)
        stacked = _permute(bk.stack_rows([c.data for c in cycs]), (1, 0, 2))
        flat = stacked.reshape(len(qs), -1)
        out = bk.axis_matmul(flat, [None] + mats, (B, *src_shape), qs)
        out = out.reshape(len(qs), B, -1)
        return [Cyc(tgt, qs, CRT, out[:, j, :], bk) for j in range(B)]

    @staticmethod
    def batched_to_basis(cycs: list["Cyc"], basis: str) -> list["Cyc"]:
        """Convert many same-ring elements in ONE per-axis transform pass
        (the batch rides along as an extra untransformed axis) — used by
        key-switch/tunnel digit fan-out to avoid per-digit transforms."""
        if not cycs:
            return []
        first = cycs[0]
        if all(c.basis == basis for c in cycs):
            return list(cycs)
        ring, qs, bk = first.ring, first.qs, first.bk
        src_basis = cycs[0].basis
        assert all(c.ring is ring and c.qs == qs and c.basis == src_basis for c in cycs)
        if basis == CRT:
            first._check_ntt()
            mats = [[crt_factor_matrix(f.pe, q) for q in qs] for f in ring.factors]
        else:
            mats = [[icrt_factor_matrix(f.pe, q) for q in qs] for f in ring.factors]
        B = len(cycs)
        stacked = _permute(bk.stack_rows([c.data for c in cycs]), (1, 0, 2))
        flat = stacked.reshape(len(qs), -1)  # [L, B*n]
        out = bk.axis_matmul(flat, [None] + mats, (B, *ring.shape), qs)
        out = out.reshape(len(qs), B, -1)
        return [Cyc(ring, qs, basis, out[:, j, :], bk) for j in range(B)]

    # -- arithmetic ---------------------------------------------------------

    def _align(self, other: "Cyc") -> tuple["Cyc", "Cyc"]:
        assert self.m == other.m and self.qs == other.qs, (self, other)
        if self.basis == other.basis:
            return self, other
        return self, other.to_basis(self.basis)

    def __add__(self, other: "Cyc") -> "Cyc":
        a, b = self._align(other)
        return a.like(a.bk.add(a.data, b.data, a.qs))

    def __sub__(self, other: "Cyc") -> "Cyc":
        a, b = self._align(other)
        return a.like(a.bk.sub(a.data, b.data, a.qs))

    def __neg__(self) -> "Cyc":
        return self.like(self.bk.neg(self.data, self.qs))

    def __mul__(self, other: "Cyc") -> "Cyc":
        assert self.m == other.m and self.qs == other.qs
        if all(_ntt_friendly(self.m, q) for q in self.qs):
            a, b = self.to_crt(), other.to_crt()
            return a.like(a.bk.mul(a.data, b.data, a.qs))
        return self._plaintext_mul(other)

    def scalar_mul(self, c: int) -> "Cyc":
        consts = [c % q for q in self.qs]
        return self.like(self.bk.mul_const(self.data, consts, self.qs))

    def _plaintext_mul(self, other: "Cyc") -> "Cyc":
        """Ring multiplication over a non-NTT modulus (plaintext side): lift
        centered to Z, multiply exactly via scratch NTT primes, reduce back.
        Large plaintext moduli use as many ~31-bit scratch primes as the
        exact integer product bound φ·(p/2+1)²·4 needs (CRT-reconstructed
        host-side with python ints — compile-time only, never on the hot
        path)."""
        assert self.nlimb == 1 and other.nlimb == 1
        p = self.qs[0]
        bound = self.ring.phi * (p // 2 + 1) ** 2 * 4
        a = _lift_centered_host(self.to_pow(), signed=True)[0]
        b = _lift_centered_host(other.to_pow(), signed=True)[0]
        primes: list[int] = []
        P = 1
        while P <= 2 * bound:
            Q = _scratch_prime(self.m, 31, avoid=tuple(primes))
            primes.append(Q)
            P *= Q
        residues = []
        for Q in primes:
            ca = Cyc.from_coeffs(self.m, (Q,), a % Q, self.bk)
            cb = Cyc.from_coeffs(self.m, (Q,), b % Q, self.bk)
            residues.append(self.bk.to_numpy((ca * cb).to_pow().data)[0])
        if len(primes) == 1:
            res = np.where(residues[0] > primes[0] // 2,
                           residues[0] - primes[0], residues[0])
        else:
            # exact CRT reconstruction over python ints (object dtype)
            acc = np.zeros(self.ring.phi, dtype=object)
            for Q, r in zip(primes, residues):
                Pi = P // Q
                c = Pi * pow(Pi % Q, -1, Q)
                acc = (acc + c * r.astype(object)) % P
            res = np.where(acc > P // 2, acc - P, acc)
        return Cyc.from_coeffs(
            self.m, self.qs, np.array(res % p, dtype=np.int64), self.bk, POW)

    # -- ring maps ----------------------------------------------------------

    def embed(self, m_target: int) -> "Cyc":
        """Ring embedding R_m → R_{m'}, m | m' (Lol `embed`)."""
        tgt = get_ring(m_target)
        tgt.check_subring(self.ring)
        if tgt.m == self.m:
            return self
        basis = self.basis
        if basis == CRT:
            self._check_ntt()
            for q in self.qs:
                if not _ntt_friendly(m_target, q):
                    basis = POW
                    break
        x = self.to_basis(basis)
        # align source data to target axis structure (insert singleton axes)
        src_shape = []
        mats = []
        for f in tgt.factors:
            b = self.ring.factor_exponent(f.p)
            src_len = 1 if b == 0 else [g.phi for g in self.ring.factors if g.p == f.p][0]
            src_shape.append(src_len)
            mats.append(_embed_axis_matrix(f.p, f.e, b, basis))
        data = x.data.reshape(x.nlimb, -1)
        out = self.bk.axis_matmul(data, mats, tuple(src_shape), self.qs)
        out_cyc = Cyc(tgt, self.qs, basis, out, self.bk)
        return out_cyc

    def twace(self, m_target: int) -> "Cyc":
        """Tweaked trace R_m → R_{m_t}, m_t | m (Lol `twace`): the integral
        left-inverse of `embed` (see core/ring.py docstring)."""
        tgt = get_ring(m_target)
        self.ring.check_subring(tgt)
        if tgt.m == self.m:
            return self
        x = self.to_pow()
        mats = [twace_factor_matrix(f.p, f.e, tgt.factor_exponent(f.p)) for f in self.ring.factors]
        out = self.bk.axis_matmul(x.data, mats, self.ring.shape, self.qs)
        return Cyc(tgt, self.qs, POW, out, self.bk)

    # -- decoding basis (Lol `l`/`lInv`; LPR toolkit §6) ----------------------
    #
    # For odd prime p the decoding basis of the p-th cyclotomic is the
    # difference basis d_0 = 1, d_j = ζ^j − ζ^{j−1} (powerful = L·decoding
    # with L the lower-triangular all-ones matrix); for prime powers p^e the
    # toolkit's recursive definition tensors d_p with the pure powers
    # (1, ζ_{p^e}, …, ζ^{p^{e−1}−1}), so the conversion acts on the slow j_p
    # sub-axis only: coords transform c = (Uᵀ_ones ⊗ I_{p^{e−1}})·b
    # (suffix sums over j_p). For p = 2 decoding = powerful.

    def _dec_axis_mats(self, skip_primes: frozenset, invert: bool):
        """Per-factor matrices converting POW coords → DEC coords (or back
        with invert=True); None where the factor is untouched (p = 2 or
        p ∈ skip_primes)."""
        mats = []
        for f in self.ring.factors:
            if f.p == 2 or f.p in skip_primes:
                mats.append(None)
            else:
                mats.append(_dec_factor_matrix(f.p, f.e, invert))
        return mats

    def _pow_dec_convert(self, skip_primes: frozenset, invert: bool):
        """Apply the POW↔DEC coordinate change (on POW-basis data)."""
        mats = self._dec_axis_mats(skip_primes, invert)
        if all(m is None for m in mats):
            return self.data
        return self.bk.axis_matmul(self.data, mats, self.ring.shape, self.qs)

    # -- relative coefficients (for linear maps / tunneling) -----------------

    def rel_split_shape(self, m_sub: int) -> tuple[list[int], list[int]]:
        """Per-axis (sub_len, rel_len) pairs for the powerful-basis splitting
        of R_m as a free module over R_{m_sub}."""
        sub = get_ring(m_sub)
        self.ring.check_subring(sub)
        subs, rels = [], []
        for f in self.ring.factors:
            b = sub.factor_exponent(f.p)
            sub_len = 1 if b == 0 else (f.p ** (b - 1)) * (f.p - 1)
            rels.append(f.phi // sub_len)
            subs.append(sub_len)
        return subs, rels

    def rel_coeffs(self, m_sub: int, basis: str = "pow") -> list["Cyc"]:
        """Coefficients of this element w.r.t. the relative powerful
        (basis="pow") or relative decoding (basis="dec") basis of R_m over
        R_{m_sub}: a list of φ(m)/φ(m_sub) subring elements.

        basis="dec" is Lol's `linearDec` basis (toolkit §6): the relative
        decoding basis differs from the relative powerful basis exactly on
        the odd primes absent from m_sub (there the factor carries the
        difference-basis structure d_j = ζ^j − ζ^{j−1}); on primes shared
        with m_sub the relative part is pure powers in both.
        """
        sub = get_ring(m_sub)
        subs, rels = self.rel_split_shape(m_sub)
        x = self.to_pow()
        if basis == "dec":
            skip = frozenset(f.p for f in sub.factors)
            data = x._pow_dec_convert(skip, invert=False)
            x = x.like(data, basis=POW)
        L = x.nlimb
        # split each axis into (i_sub slow, j_rel fast)
        split_shape = []
        for s, r in zip(subs, rels):
            split_shape.extend([s, r])
        arr = x.data.reshape(L, *split_shape)
        # move all rel axes (odd positions) before sub axes
        k = len(subs)
        perm = [0] + [2 + 2 * i for i in range(k)] + [1 + 2 * i for i in range(k)]
        arr = _permute(arr, perm)
        rel_dim = int(np.prod(rels))
        arr = arr.reshape(L, rel_dim, -1)
        out = []
        for j in range(rel_dim):
            out.append(Cyc(sub, self.qs, POW, arr[:, j, :], self.bk))
        return out

    @staticmethod
    def from_rel_coeffs(m: int, m_sub: int, coeffs: list["Cyc"], qs, bk,
                        basis: str = "pow") -> "Cyc":
        """Inverse of `rel_coeffs` (same `basis` convention)."""
        ring = get_ring(m)
        sub = get_ring(m_sub)
        probe = Cyc.zero(m, qs, bk)
        subs, rels = probe.rel_split_shape(m_sub)
        rel_dim = int(np.prod(rels))
        assert len(coeffs) == rel_dim
        L = len(qs)
        arr = bk.stack_rows([c.to_pow().data for c in coeffs])
        arr = _permute(arr, (1, 0, 2))  # [L, rel, phi_sub]
        arr = arr.reshape(L, *rels, *subs)
        k = len(subs)
        # current order: [rel axes..., sub axes...] -> interleave (sub, rel)
        perm = [0] + [x for i in range(k) for x in (1 + k + i, 1 + i)]
        arr = _permute(arr, perm)
        arr = arr.reshape(L, ring.phi)
        if isinstance(arr, np.ndarray):
            arr = bk.asarray(arr, tuple(qs))
        out = Cyc(ring, tuple(qs), POW, arr, bk)
        if basis == "dec":
            skip = frozenset(f.p for f in sub.factors)
            out = out.like(out._pow_dec_convert(skip, invert=True), basis=POW)
        return out

    # -- host-side exact access ---------------------------------------------

    def equals(self, other: "Cyc") -> bool:
        a = self.to_pow()
        b = other.to_pow()
        return (
            self.m == other.m
            and self.qs == other.qs
            and bool(np.array_equal(a.bk.to_numpy(a.data), b.bk.to_numpy(b.data)))
        )


def _permute(arr, perm):
    """Permute the axes of a numpy array (`transpose`), a torch tensor or a
    checked pair (`permute`)."""
    perm = tuple(perm)
    return arr.transpose(perm) if isinstance(arr, np.ndarray) else arr.permute(perm)


@lru_cache(maxsize=None)
def _fused_embed_crt_mats(m_src: int, m_tgt: int, qs: tuple[int, ...]):
    """Per-target-axis per-limb matrices (CRT_axis mod q) @ (POW-embed_axis),
    plus the aligned source shape for the reshape."""
    src = get_ring(m_src)
    tgt = get_ring(m_tgt)
    mats = []
    src_shape = []
    for f in tgt.factors:
        b = src.factor_exponent(f.p)
        src_len = 1 if b == 0 else [g.phi for g in src.factors if g.p == f.p][0]
        src_shape.append(src_len)
        E = _embed_axis_matrix(f.p, f.e, b, POW)
        per_limb = []
        for q in qs:
            C = crt_factor_matrix(f.pe, q)
            per_limb.append((C.astype(object) @ E.astype(object) % q).astype(np.int64))
        mats.append(per_limb)
    return mats, tuple(src_shape)


@lru_cache(maxsize=None)
def _dec_factor_matrix(p: int, e: int, invert: bool) -> np.ndarray:
    """POW→DEC coordinate change on the p^e factor axis (invert=False):
    suffix sums over the slow j_p sub-axis, c = (Uᵀ_ones ⊗ I_{p^{e−1}})·b;
    invert=True gives the difference-matrix inverse (entries 0/±1)."""
    d = p - 1
    rest = p ** (e - 1)
    if invert:
        U = np.zeros((d, d), dtype=np.int64)
        for i in range(d):
            U[i, i] = 1
            if i + 1 < d:
                U[i, i + 1] = -1
    else:
        U = np.triu(np.ones((d, d), dtype=np.int64))
    return np.kron(U, np.eye(rest, dtype=np.int64))


@lru_cache(maxsize=None)
def _scratch_prime(m: int, bits: int, avoid: tuple[int, ...] = ()) -> int:
    return find_ntt_prime(m, bits, avoid=avoid)


def _lift_centered_host(c: Cyc, signed: bool = True) -> np.ndarray:
    """[L, n] centered (or plain) integer lift of residues, on host."""
    arr = c.bk.to_numpy(c.data).astype(np.int64)
    if not signed:
        return arr
    q = np.asarray(c.qs, dtype=np.int64)[:, None]
    return np.where(arr > q // 2, arr - q, arr)


def crt_lift_host(c: Cyc) -> list[int]:
    """Exact CRT reconstruction of the [nlimb] residues into centered Python
    ints mod ∏q — host only (decrypt / error probe; DESIGN.md RNS
    discipline). Vectorized: int64 Garner digits, then one object-array
    combine per limb (no per-coefficient Python loop — VERDICT r3 weak #9)."""
    from alchemy_tpu_torch.she.fast import garner_host

    x = c.to_pow()
    arr = x.bk.to_numpy(x.data).astype(np.int64)
    qs = x.qs
    xs = garner_host(np.moveaxis(arr, 0, -2), qs)
    pi = [1]
    for g in qs[:-1]:
        pi.append(pi[-1] * g)
    Q = pi[-1] * qs[-1]
    v = xs[0].astype(object)
    for k in range(1, len(qs)):
        v = v + xs[k].astype(object) * pi[k]
    v = np.where(v > Q // 2, v - Q, v)
    return [int(t) for t in v]
