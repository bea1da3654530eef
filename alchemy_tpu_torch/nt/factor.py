"""Integer factorization and totients (exact, host-side).

Counterpart of Lol's type-level `Factored`/`Fact`/`Divides`/`FGCD`/`totientFact`
(usage sites: reference SHE.hs:22-26, examples/Common.hs:38-54). Cyclotomic
indices in this framework are plain ints validated by these helpers.
"""

from __future__ import annotations

import math
from functools import lru_cache


@lru_cache(maxsize=None)
def factorize(n: int) -> tuple[tuple[int, int], ...]:
    """Prime factorization of n >= 1 as a sorted tuple of (p, e) pairs."""
    if n < 1:
        raise ValueError(f"factorize: n must be >= 1, got {n}")
    out = []
    m = n
    d = 2
    while d * d <= m:
        if m % d == 0:
            e = 0
            while m % d == 0:
                m //= d
                e += 1
            out.append((d, e))
        d += 1 if d == 2 else 2
    if m > 1:
        out.append((m, 1))
    return tuple(out)


def prime_power_factors(n: int) -> tuple[int, ...]:
    """The prime-power factors p^e of n, sorted by prime."""
    return tuple(p**e for p, e in factorize(n))


@lru_cache(maxsize=None)
def totient(n: int) -> int:
    """Euler totient φ(n)."""
    phi = 1
    for p, e in factorize(n):
        phi *= (p - 1) * p ** (e - 1)
    return phi


def radical(n: int) -> int:
    """Product of the distinct primes dividing n."""
    r = 1
    for p, _ in factorize(n):
        r *= p
    return r


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def divides(m: int, n: int) -> bool:
    """Does m divide n? (Lol's `Divides` proof, as a runtime check.)"""
    return n % m == 0


def check_divides(m: int, n: int) -> None:
    if not divides(m, n):
        raise ValueError(f"index {m} does not divide {n}")


def fgcd(a: int, b: int) -> int:
    """gcd of two cyclotomic indices (Lol's FGCD, Common.hs:66)."""
    return math.gcd(a, b)


def multiplicative_order(a: int, n: int) -> int:
    """Order of a in (Z/n)^*; requires gcd(a, n) == 1."""
    if math.gcd(a, n) != 1:
        raise ValueError(f"{a} is not a unit mod {n}")
    order = 1
    x = a % n
    while x != 1:
        x = x * a % n
        order += 1
    return order


def units(n: int) -> list[int]:
    """The unit group (Z/n)^* as a sorted list."""
    return [i for i in range(1, n + 1) if math.gcd(i, n) == 1] if n > 1 else [0]


def crt_index_set(m: int) -> list[int]:
    """Canonical ordering of (Z/m)^*: the exponents indexing CRT slots of the
    m-th cyclotomic ring, ordered compatibly with the tensor decomposition.

    For m = ∏ p_i^e_i (primes ascending), the k-th element is the CRT
    recombination of the per-factor unit groups enumerated in per-factor
    canonical order (see `factor_unit_order`), with the FIRST factor's index
    varying slowest. This makes the global CRT transform the tensor product of
    per-factor transforms, which is what the backend implements as per-axis
    matmuls.
    """
    if m == 1:
        return [0]
    factors = prime_power_factors(m)
    out = [1]
    mod_so_far = 1
    for pe in factors:
        new = []
        for x in out:
            for u in factor_unit_order(pe):
                # CRT combine: y ≡ x (mod mod_so_far), y ≡ u (mod pe)
                y = _crt_pair(x, mod_so_far, u, pe)
                new.append(y)
        out = new
        mod_so_far *= pe
    return out


def _crt_pair(a: int, m1: int, b: int, m2: int) -> int:
    """y ≡ a (mod m1), y ≡ b (mod m2) for coprime m1,m2."""
    if m1 == 1:
        return b % m2
    inv = pow(m1, -1, m2)
    return (a + m1 * ((b - a) * inv % m2)) % (m1 * m2)


@lru_cache(maxsize=None)
def factor_unit_order(pe: int) -> tuple[int, ...]:
    """Canonical enumeration of (Z/p^e)^* used for CRT slot ordering.

    For odd p: powers g^0, g^1, ... of the smallest primitive root g.
    For 2 and 4: trivial / [1, 3]. For 2^k (k>=3): (Z/2^k)^* ≅ <-1> × <5>;
    enumerate (-1)^s * 5^j with j varying fastest.
    """
    fac = factorize(pe)
    assert len(fac) == 1
    p, e = fac[0]
    n = pe
    if p == 2:
        if e == 1:
            return (1,)
        if e == 2:
            return (1, 3)
        half = 2 ** (e - 2)
        out = []
        for s in (0, 1):
            for j in range(half):
                v = pow(5, j, n)
                if s:
                    v = (n - v) % n
                out.append(v)
        return tuple(out)
    g = _primitive_root_prime_power(p, e)
    cnt = totient(pe)
    return tuple(pow(g, j, n) for j in range(cnt))


@lru_cache(maxsize=None)
def _primitive_root_prime_power(p: int, e: int) -> int:
    """Smallest primitive root mod p^e for odd prime p."""
    assert p % 2 == 1
    phi = (p - 1) * p ** (e - 1)
    fac = [q for q, _ in factorize(phi)]
    n = p**e
    for g in range(2, n):
        if math.gcd(g, n) != 1:
            continue
        if all(pow(g, phi // q, n) != 1 for q in fac):
            return g
    raise ArithmeticError(f"no primitive root mod {p}^{e}")
