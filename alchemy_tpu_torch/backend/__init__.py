"""Array backends for the ring layer (`alchemy_tpu/backend/__init__.py`).

- `golden`: exact numpy int64 arithmetic — the oracle every other backend
  must match limb for limb;
- `torch`: `TorchBackend`, int64 tensors on the card (the port of the JAX
  package's `xla` backend); `TorchBackend(device="cpu")` runs it on the CPU;
- `checked`: every op on both, with bit-identity asserted op by op.

`torch` and `checked` live on the card and raise without one. The accessors
are named so as not to collide with the submodules' names on the package.
"""

_GOLDEN = None
_TORCH = None
_CHECKED = None


def golden_backend():
    global _GOLDEN
    if _GOLDEN is None:
        from alchemy_tpu_torch.backend.golden import GoldenBackend

        _GOLDEN = GoldenBackend()
    return _GOLDEN


def torch_card_backend():
    global _TORCH
    if _TORCH is None:
        from alchemy_tpu_torch.backend.torch_backend import TorchBackend

        _TORCH = TorchBackend()
    return _TORCH


def checked_backend():
    global _CHECKED
    if _CHECKED is None:
        from alchemy_tpu_torch.backend.checked import CheckedBackend

        _CHECKED = CheckedBackend()
    return _CHECKED


def get_backend(name: str):
    if name == "golden":
        return golden_backend()
    if name == "torch":
        return torch_card_backend()
    if name == "checked":
        return checked_backend()
    raise ValueError(f"unknown backend {name!r}")
