"""Device meshes for the FHE workload — port of `alchemy_tpu/parallel/mesh.py`
on `torch.distributed`.

Axes:
- 'batch': independent ciphertexts (pure data parallel, no cross-ct comms);
- 'limb':  RNS limbs (tensor parallel; cross-limb traffic only at gadget
           digit fan-out and rescale);
- 'coeff': ring coefficients (sequence parallel; the distributed NTT's
           all_to_all transpose is the only cross-rank step).

A JAX mesh holds devices; a torch mesh holds ranks, one process per mesh
position, each in the initialised default process group
(`parallel/multihost.init_multihost`).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("batch", "limb", "coeff")


def pick_mesh_shape(n_devices: int, nlimb: int | None = None) -> tuple[int, int, int]:
    """Factor n_devices into (batch, limb, coeff), preferring limb×coeff
    parallelism that divides the problem axes (mesh.py:20)."""
    def small_pow2(n):
        p = 1
        while n % 2 == 0:
            n //= 2
            p *= 2
        return p

    pow2 = small_pow2(n_devices)
    # put up to 2 on limb, up to 2 on coeff, the rest (incl. odd part) on batch
    limb = 2 if pow2 >= 2 and (nlimb is None or nlimb % 2 == 0) else 1
    coeff = 2 if pow2 // limb >= 2 else 1
    batch = n_devices // (limb * coeff)
    assert batch * limb * coeff == n_devices
    return batch, limb, coeff


def check_device_type(device_type: str) -> None:
    """Raise unless `device_type` is "cuda" with a card or "cpu"."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type='cuda' but torch sees no CUDA device")
    elif device_type != "cpu":
        raise ValueError(f"device_type={device_type!r}: want 'cuda' or 'cpu'")


def make_mesh(shape: tuple[int, int, int], device_type: str = "cuda") -> DeviceMesh:
    """The ('batch', 'limb', 'coeff') mesh of `shape` over the ranks of the
    initialised world, rank r at the r-th position in row-major order
    (mesh.py:39). On the card unless the caller asks for "cpu"."""
    check_device_type(device_type)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=AXES)
