from alchemy_tpu_torch.core.params import Modulus, RnsChain
from alchemy_tpu_torch.core.ring import CycRing, get_ring

__all__ = ["Modulus", "RnsChain", "CycRing", "get_ring"]
