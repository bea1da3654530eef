from alchemy_tpu_torch.lang.ir import Node, Var, Lam, App, Prim
from alchemy_tpu_torch.lang import dsl
from alchemy_tpu_torch.lang.dsl import lam, lam2, let_, compose

__all__ = ["Node", "Var", "Lam", "App", "Prim", "dsl", "lam", "lam2", "let_", "compose"]
