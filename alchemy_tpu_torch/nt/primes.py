"""NTT-friendly primes, roots of unity and noise units (framework-free).

A copy of `alchemy_tpu/nt/primes.py` (with the two helpers it takes from
`alchemy_tpu/nt/factor.py`: `factorize` and `is_prime`), so that both
packages build the same RNS chains and the same transform roots.
"""

from __future__ import annotations

import math
from functools import lru_cache

#: "Bits" per noise unit (reference Noise.hs:153-155).
PNOISE_UNIT = 6.1


@lru_cache(maxsize=None)
def factorize(n: int) -> tuple[tuple[int, int], ...]:
    """Prime factorization of n >= 1 as a sorted tuple of (p, e) pairs
    (alchemy_tpu/nt/factor.py:15)."""
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


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (alchemy_tpu/nt/factor.py:57)."""
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


def units_of_modulus(q: int) -> int:
    """Noise units a modulus q can hold: ⌊log2(q) / 6.1⌋ (Noise.hs:166-170)."""
    return math.floor(math.log2(q) / PNOISE_UNIT)


def find_ntt_prime(m: int, bits: int, *, lo: bool = False, avoid: tuple[int, ...] = ()) -> int:
    """Find a prime q ≡ 1 (mod m) near 2^bits (searching downward, or upward
    from 2^(bits-1) when lo=True), excluding `avoid`."""
    if lo:
        q = ((1 << (bits - 1)) // m) * m + 1
        step = m
    else:
        q = ((1 << bits) // m) * m + 1
        step = -m
    while 2 < q < (1 << 32):
        if q not in avoid and is_prime(q):
            return q
        q += step
    raise ValueError(f"no NTT prime ≡ 1 mod {m} near 2^{bits}")


@lru_cache(maxsize=None)
def primitive_root(q: int) -> int:
    """Smallest primitive root mod prime q."""
    if not is_prime(q):
        raise ValueError(f"{q} is not prime")
    phi = q - 1
    fac = [p for p, _ in factorize(phi)]
    for g in range(2, q):
        if all(pow(g, phi // p, q) != 1 for p in fac):
            return g
    raise ArithmeticError(f"no primitive root mod {q}")


@lru_cache(maxsize=None)
def root_of_unity(m: int, q: int) -> int:
    """A fixed primitive m-th root of unity mod prime q (requires m | q-1),
    derived from the smallest primitive root so that every backend builds
    identical transform tables."""
    if m == 1:
        return 1
    if (q - 1) % m != 0:
        raise ValueError(f"q={q} is not ≡ 1 mod m={m}; no m-th root of unity")
    g = primitive_root(q)
    w = pow(g, (q - 1) // m, q)
    assert pow(w, m, q) == 1 and pow(w, m // factorize(m)[0][0], q) != 1
    return w
