"""PyTorch/CUDA port of alchemy_tpu.

The JAX package `alchemy_tpu` is the reference: every op here returns the
same uint32 residues as its counterpart there (the same NTT slot orders,
chosen by `FastParams.impl`, whose default in both packages is "mxu", the
2-factor order; the same seeded host sampling). This package imports torch
and never jax. Residues are stored as int32 tensors (canonical values are
< 2^31) and computed on in int64 by the plain versions; the CUDA kernels
read the same buffers as uint32.

This module re-exports the everyday surface of `alchemy_tpu/__init__.py`:
the DSL, the interpreters and the plumbing in one import.
"""

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.params import Modulus, RnsChain
from alchemy_tpu_torch.interp import dup, eval, pprint, size  # noqa: A004
from alchemy_tpu_torch.interp.error_writer import eval_with_error_rates
from alchemy_tpu_torch.interp.keys_hints import KeysHints
from alchemy_tpu_torch.interp.noise import PtTy
from alchemy_tpu_torch.interp.params_print import params
from alchemy_tpu_torch.interp.pt2ct import CompiledExpr, pt2ct
from alchemy_tpu_torch.lang.dsl import compose, lam, lam2, let_
from alchemy_tpu_torch.lang.rescale_tree import rescale_tree_pow2
from alchemy_tpu_torch.she.gadget import BaseBGad, TrivGad
from alchemy_tpu_torch.she.linear import LinearMap

__all__ = [
    "Cyc", "Modulus", "RnsChain",
    "dup", "eval", "pprint", "size", "params",
    "eval_with_error_rates", "KeysHints", "PtTy", "CompiledExpr", "pt2ct",
    "compose", "lam", "lam2", "let_", "rescale_tree_pow2",
    "BaseBGad", "TrivGad", "LinearMap",
]

__version__ = "0.1.0"
