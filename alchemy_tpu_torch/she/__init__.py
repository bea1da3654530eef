from alchemy_tpu_torch.she.gadget import TrivGad, BaseBGad, Gadget
from alchemy_tpu_torch.she.keys import SK
from alchemy_tpu_torch.she.ct import CT
from alchemy_tpu_torch.she import bgv
from alchemy_tpu_torch.she.linear import LinearMap

__all__ = ["TrivGad", "BaseBGad", "Gadget", "SK", "CT", "bgv", "LinearMap"]
