"""The rescaling tree (reference Language/RescaleTree.hs:58-92).

`rescale_tree_pow2(k)` is the depth-log tree computing homomorphic rounding
Z_{2^k} → Z_2 (the tag k is the reference's Pos K; input modulus 2^k):

    λx. let y = x·(1 + x) in
        treeMul [ div2 (z·(−z+1) + y) | z ← [1 .. 2^(k−2)] ]

where treeMul pairwise-reduces with div2 ∘ mul (RescaleTree.hs:66-92).
SIMD over CRT slots: correct when every slot holds a Z_{2^k} scalar
(RescaleTree.hs:52-57).

A copy of `alchemy_tpu/lang/rescale_tree.py`.
"""

from __future__ import annotations

from alchemy_tpu_torch.lang.dsl import add_lit_n, div2, lam, let_
from alchemy_tpu_torch.lang.ir import Node


def rescale_tree_pow2(k: int) -> Node:
    """k >= 1; input Z_{2^k}, output Z_2. k = 1 is the identity
    (RescaleTree.hs:60-62)."""
    assert k >= 1
    if k == 1:
        return lam(lambda x: x)
    kval = k - 1  # the reference's inner k (RescaleTree.hs:64-70)

    def tree_mul(terms):
        while len(terms) > 1:
            assert len(terms) % 2 == 0
            terms = [div2(a * b) for a, b in zip(terms[0::2], terms[1::2])]
        return terms[0]

    def body(x):
        return let_(
            x * add_lit_n(1, x),
            lambda y: tree_mul(
                [
                    div2(add_lit_n(z * (-z + 1), y))
                    for z in range(1, 2 ** (kval - 1) + 1)
                ]
            ),
        )

    return lam(body)
