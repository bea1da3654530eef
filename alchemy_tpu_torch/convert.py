"""State across packages: uint32 numpy arrays ↔ the port's int32 tensors.

The JAX package's keys, hints (raw, or (values, companions) Shoup pairs)
and ciphertexts become numpy uint32 arrays with `np.asarray`; `to_torch`
carries them into the port (the same bits, stored as int32) and
`to_numpy` carries the port's tensors back. Pairs stay pairs.
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
