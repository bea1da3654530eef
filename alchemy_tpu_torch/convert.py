"""State across packages.

The power-of-two path: the JAX package's keys, hints (raw, or (values,
companions) Shoup pairs) and ciphertexts become numpy uint32 arrays with
`np.asarray`; `to_torch` carries them into the port (the same bits, stored
as int32) and `to_numpy` carries the port's tensors back. Pairs stay pairs.

The general SHE layer: `cyc_from`, `ct_from`, `sk_from`, `ks_hint_from` and
`tunnel_hint_from` rebuild the port's `Cyc`, `CT`, `SK`, `KSQuadCircHint`
and `TunnelHint` on a backend of the port from the JAX package's objects
(their numpy arrays and metadata), so a hint or ciphertext made there runs
through the port; `bk.to_numpy(c.data)` reads a port element back.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(x, device="cuda"):
    """uint32 array (or a tuple of them) → int32 tensor(s) on device."""
    if isinstance(x, (tuple, list)):
        return tuple(to_torch(v, device) for v in x)
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint32))
    return torch.tensor(a.view(np.int32), device=device)


def to_numpy(t):
    """int32 tensor (or a tuple of them) → uint32 numpy array(s)."""
    if isinstance(t, (tuple, list)):
        return tuple(to_numpy(v) for v in t)
    return t.detach().cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# the general SHE layer: the JAX package's Cyc, CT, SK, hints → the port's
# ---------------------------------------------------------------------------
#
# Each function reads its argument's fields by name (m or ring.m, qs, basis,
# data; a gadget by its class name and fields) and its arrays through
# `np.asarray`, so it takes the JAX package's objects, or any objects with
# the same fields holding numpy arrays, without importing that package.


def cyc_from(c, bk):
    """A ring element (fields m, qs, basis, data [L, φ(m)]) → the port's Cyc on bk."""
    from alchemy_tpu_torch.core.cyc import Cyc
    from alchemy_tpu_torch.core.ring import get_ring

    qs = tuple(int(q) for q in c.qs)
    data = np.asarray(c.data, dtype=np.int64)
    return Cyc(get_ring(int(c.m)), qs, c.basis, bk.asarray(data, qs), bk)


def gadget_from(g):
    """TrivGad, BaseBGad(base) or HybridGad(dnum, sp_bits) → the port's."""
    from alchemy_tpu_torch.she.gadget import BaseBGad, HybridGad, TrivGad

    name = type(g).__name__
    if name == "TrivGad":
        return TrivGad()
    if name == "BaseBGad":
        return BaseBGad(g.base)
    if name == "HybridGad":
        return HybridGad(g.dnum, g.sp_bits)
    raise TypeError(f"gadget_from: unknown gadget {name}")


def sk_from(sk):
    """A secret key (fields m, variance, coeffs) → the port's SK."""
    from alchemy_tpu_torch.she.keys import SK

    return SK(int(sk.m), float(sk.variance), np.asarray(sk.coeffs, dtype=np.int64).copy())


def ct_from(ct, bk):
    """A ciphertext (fields m, zp, scale, comps) → the port's CT on bk."""
    from alchemy_tpu_torch.she.ct import CT

    return CT(int(ct.m), int(ct.zp), int(ct.scale), tuple(cyc_from(c, bk) for c in ct.comps))


def ks_hint_from(h, bk):
    """A KSQuadCircHint (fields m_prime, qs, gadget, zp, rows, ext_qs) →
    the port's on bk."""
    from alchemy_tpu_torch.she.bgv import KSQuadCircHint

    ext = None if h.ext_qs is None else tuple(int(q) for q in h.ext_qs)
    rows = tuple((cyc_from(b, bk), cyc_from(a, bk)) for b, a in h.rows)
    return KSQuadCircHint(int(h.m_prime), tuple(int(q) for q in h.qs),
                          gadget_from(h.gadget), int(h.zp), rows, ext_qs=ext)


def linear_map_from(f, bk):
    """A LinearMap (fields e, r, s, images, basis) → the port's on bk."""
    from alchemy_tpu_torch.she.linear import LinearMap

    return LinearMap(int(f.e), int(f.r), int(f.s),
                     tuple(cyc_from(y, bk) for y in f.images), f.basis)


def tunnel_hint_from(h, bk):
    """A TunnelHint → the port's on bk (its linear map's images too)."""
    from alchemy_tpu_torch.she.tunnel import TunnelHint

    rows = tuple(tuple((cyc_from(b, bk), cyc_from(a, bk)) for b, a in row) for row in h.rows)
    return TunnelHint(linear_map_from(h.f, bk), int(h.e_p), int(h.r_p), int(h.s_p),
                      tuple(int(q) for q in h.qs), gadget_from(h.gadget), int(h.zp),
                      [cyc_from(y, bk) for y in h.images_sp], rows)
