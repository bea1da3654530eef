from alchemy_tpu_torch.interp.eval import eval_ir as eval  # noqa: A001 - mirrors reference name
from alchemy_tpu_torch.interp.pprint import pprint
from alchemy_tpu_torch.interp.size import size
from alchemy_tpu_torch.interp.dup import dup

__all__ = ["eval", "pprint", "size", "dup"]
