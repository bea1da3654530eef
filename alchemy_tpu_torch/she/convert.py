"""Backend conversion for key/hint structures (`alchemy_tpu/she/convert.py`).

Hint generation is compile-time work full of small eager ops, each of which
costs a launch on the card. Keys/hints can therefore be generated on the
golden (numpy) backend and converted wholesale — every Cyc's residue array
re-homed with one `asarray` — before entering the target backend's
pipeline. Exactness is preserved (residues are plain integers)."""

from __future__ import annotations

import dataclasses

import numpy as np

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.ring import get_ring


def to_backend(obj, bk):
    """Deep-convert any structure containing Cycs to the target backend.

    All Cycs in the structure are gathered first, grouped by (m, qs, basis,
    shape), stacked host-side and re-homed with ONE asarray per group, then
    sliced back. One gadget hint holds hundreds of same-shaped Cyc rows, and
    one host→device copy per group replaces one per row. Slices of one
    device array are cheap views."""
    cycs: list[Cyc] = []

    def collect(o):
        if isinstance(o, Cyc):
            cycs.append(o)
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            for f in dataclasses.fields(o):
                collect(getattr(o, f.name))
        elif isinstance(o, (tuple, list)):
            for x in o:
                collect(x)

    collect(obj)
    groups: dict = {}
    for c in cycs:
        # materialize once through the element's own backend: device-resident
        # inputs pay one readback, reused for the shape key and the stack below
        arr = c.bk.to_numpy(c.data)
        groups.setdefault((c.m, c.qs, c.basis, arr.shape), []).append((c, arr))
    converted: dict[int, Cyc] = {}
    for (m, qs, basis, shape), members in groups.items():
        stacked = np.stack(
            [arr.astype(np.int64).reshape(len(qs), -1)
             for _, arr in members])
        rows = stacked.shape[1]
        # one device put for the whole group, then per-member slices
        dev_all = bk.asarray(stacked.reshape(-1, stacked.shape[-1]),
                             qs * len(members))
        ring = get_ring(m)
        for i, (c, _) in enumerate(members):
            d = dev_all[i * rows:(i + 1) * rows].reshape(shape)
            converted[id(c)] = Cyc(ring, qs, basis, d, bk)

    def rebuild(o):
        if isinstance(o, Cyc):
            return converted[id(o)]
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return type(o)(**{
                f.name: rebuild(getattr(o, f.name))
                for f in dataclasses.fields(o)
            })
        if isinstance(o, tuple):
            return tuple(rebuild(x) for x in o)
        if isinstance(o, list):
            return [rebuild(x) for x in o]
        return o

    return rebuild(obj)
