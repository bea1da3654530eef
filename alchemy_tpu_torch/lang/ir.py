"""The expression IR: the reification of ALCHEMY's tagless-final object
language (reference Language/* classes, SURVEY.md §2.1).

The reference encodes terms as polymorphic Haskell values interpreted by
typeclass instances; GHC's instance resolution *is* its compiler (SURVEY.md
§3.2). Here terms are explicit de Bruijn trees and the interpreters/compiler
are IR walkers — Python has no type-level computation, so PT2CT runs an
explicit inference pass instead (interp/noise.py, interp/pt2ct.py).

Nodes:
- `Var(idx)`/`Lam(body)`/`App(f, a)` — Lambda_ (Language/Lambda.hs:13-25)
- `Prim(name, payload)` — every primitive op, *function-valued* and curried,
  exactly like the reference's `add_ :: expr e (a -> a -> a)`:
  arithmetic (add_/neg_/addLit_/mulLit_/mul_/div2_, Language/Arithmetic.hs),
  SHE ops (modSwitchPT_/modSwitch_/addPublic_/mulPublic_/keySwitchQuad_/
  tunnel_/errorRate_, Language/SHE.hs), linearCyc_ (Language/LinearCyc.hs),
  and list/pair/string helpers (Language/{List,Pair,String}.hs).

A copy of `alchemy_tpu/lang/ir.py`.
"""

from __future__ import annotations

import itertools
from typing import Any

_uid = itertools.count()


class Node:
    __slots__ = ("uid",)

    def __init__(self):
        self.uid = next(_uid)

    # operator sugar (metalanguage versions of add_/mul_, Arithmetic.hs:16-48)
    def __add__(self, other: "Node") -> "Node":
        return App(App(Prim("add_"), self), other)

    def __sub__(self, other: "Node") -> "Node":
        return App(App(Prim("add_"), self), App(Prim("neg_"), other))

    def __neg__(self) -> "Node":
        return App(Prim("neg_"), self)

    def __mul__(self, other: "Node") -> "Node":
        return App(App(Prim("mul_"), self), other)


class Var(Node):
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        super().__init__()
        self.idx = idx

    def __repr__(self):
        return f"Var({self.idx})"


class Lam(Node):
    __slots__ = ("body",)

    def __init__(self, body: Node):
        super().__init__()
        self.body = body

    def __repr__(self):
        return f"Lam({self.body!r})"


class App(Node):
    __slots__ = ("f", "a")

    def __init__(self, f: Node, a: Node):
        super().__init__()
        self.f = f
        self.a = a

    def __repr__(self):
        return f"App({self.f!r}, {self.a!r})"


class Prim(Node):
    __slots__ = ("name", "payload", "ann")

    def __init__(self, name: str, payload: Any = None, ann: Any = None):
        super().__init__()
        self.name = name
        self.payload = payload
        #: optional compile-time annotation (modulus/pnoise, for Params)
        self.ann = ann

    def __repr__(self):
        return f"Prim({self.name})" if self.payload is None else f"Prim({self.name}, …)"


class FreeVar(Node):
    """HOAS placeholder used only during construction (lang/dsl.py)."""

    __slots__ = ("level",)

    def __init__(self, level: int):
        super().__init__()
        self.level = level

    def __repr__(self):
        return f"FreeVar({self.level})"


def map_children(node: Node, f) -> Node:
    if isinstance(node, Lam):
        return Lam(f(node.body))
    if isinstance(node, App):
        return App(f(node.f), f(node.a))
    return node
