"""Shared example infrastructure (`alchemy_tpu/examples/common.py`, reference
examples/Common.hs): the plaintext ring tower H0..H5 and ciphertext tower
H0'..H5' (Common.hs:41-54), the `decToCRT` linear function mapping the
relative basis (rel. the largest common subring) to CRT slots
(Common.hs:65-75), the chained switches switch1..switch5 (Common.hs:77-95),
and the wall-clock timing harness (Common.hs:99-127).

`dec_to_crt` and `switch` take a backend object or its name
(`backend.get_backend`), so that a caller can pass `TorchBackend("cpu")`.
"""

from __future__ import annotations

from functools import lru_cache

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.lang import dsl
from alchemy_tpu_torch.lang.dsl import compose, lam
from alchemy_tpu_torch.lang.ir import App, Node
from alchemy_tpu_torch.nt.crtset import crt_set_relative
from alchemy_tpu_torch.nt.factor import fgcd, totient
from alchemy_tpu_torch.she.linear import LinearMap
from alchemy_tpu_torch.utils.profiling import timed  # noqa: F401  (the timing harness)

# plaintext ring indices (Common.hs:41-46)
H0, H1, H2, H3, H4, H5 = 128, 448, 2912, 3640, 5460, 4095
# corresponding ciphertext ring indices (Common.hs:49-54)
H0p, H1p, H2p, H3p, H4p, H5p = 11648, 29120, 43680, 54600, 27300, 20475

TOWER = [H0, H1, H2, H3, H4, H5]
TOWER_P = [H0p, H1p, H2p, H3p, H4p, H5p]

#: the M'Map of HomomRLWR.hs:29-35 / Tunnel.hs:26-32
M_MAP = dict(zip(TOWER, TOWER_P))


def as_backend(bk):
    """A backend object, or the one `get_backend` names."""
    from alchemy_tpu_torch.backend import get_backend

    return get_backend(bk) if isinstance(bk, str) else bk


@lru_cache(maxsize=None)
def dec_to_crt(r: int, s: int, pk: int, bk="golden") -> LinearMap:
    """Linear function mapping the relative basis (rel. e = FGCD r s) to the
    relative CRT set of R_s (Common.hs:65-75): takes only as many CRT-set
    elements as the relative dimension. Cached by the backend object or
    name."""
    bk = as_backend(bk)
    e = fgcd(r, s)
    dim = totient(r) // totient(e)
    crts = crt_set_relative(e, s, pk)
    assert len(crts) >= dim, "not enough relative CRT elements (linearDec would fail)"
    images = tuple(Cyc.from_coeffs(s, (pk,), c, bk) for c in crts[:dim])
    return LinearMap(e=e, r=r, s=s, images=images)


def switch(n: int, pk: int, bk="golden") -> Node:
    """switch_n : H0 → Hn via n chained tunnels (Common.hs:77-95)."""
    assert 1 <= n <= 5
    expr = lam(lambda x: App(dsl.linear_cyc(dec_to_crt(H0, H1, pk, bk)), x))
    for i in range(1, n):
        f = dec_to_crt(TOWER[i], TOWER[i + 1], pk, bk)
        expr = compose(lam(lambda x, f=f: App(dsl.linear_cyc(f), x)), expr)
    return expr

