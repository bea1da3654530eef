"""HOAS surface over the IR: `lam`, `lam2`, `let_`, composition, and the
primitive constructors (Language/Lambda.hs:27-55 surface).

`lam(f)` takes a Python function over expression values and produces a
de Bruijn `Lam` — the analog of the reference's HOAS `lam` over `lamDB`/`v0`/
`weaken` (Lambda.hs:27-40), using level-tagged placeholders instead of
typed-environment weakening.

A copy of `alchemy_tpu/lang/dsl.py`.
"""

from __future__ import annotations

from alchemy_tpu_torch.lang.ir import App, FreeVar, Lam, Node, Prim, Var

_level = 0


def _bind(body: Node, level: int, depth: int = 0) -> Node:
    """Replace FreeVar(level) by Var(depth-distance)."""
    if isinstance(body, FreeVar):
        return Var(depth) if body.level == level else body
    if isinstance(body, Lam):
        return Lam(_bind(body.body, level, depth + 1))
    if isinstance(body, App):
        return App(_bind(body.f, level, depth), _bind(body.a, level, depth))
    return body


def lam(f) -> Node:
    """Lambda abstraction from a metalanguage function."""
    global _level
    lvl = _level
    _level += 1
    try:
        body = f(FreeVar(lvl))
    finally:
        _level -= 1
    return Lam(_bind(body, lvl))


def lam2(f) -> Node:
    return lam(lambda x: lam(lambda y: f(x, y)))


def let_(a: Node, f) -> Node:
    """Let-sharing (Lambda.hs:43-47): `let_ a f = lam f $: a`."""
    return App(lam(f), a)


def app(f: Node, *args: Node) -> Node:
    for a in args:
        f = App(f, a)
    return f


def compose(f: Node, g: Node) -> Node:
    """Object-language composition (.:) (Lambda.hs:50-55)."""
    return lam(lambda x: App(f, App(g, x)))


# -- primitive constructors (function-valued, curried) -----------------------

def add_() -> Node:
    return Prim("add_")


def neg_() -> Node:
    return Prim("neg_")


def add_lit(lit) -> Node:
    """addLit_ — payload is an int (polymorphic literal) or a plaintext Cyc."""
    return Prim("addLit_", lit)


def mul_lit(lit) -> Node:
    return Prim("mulLit_", lit)


def mul_() -> Node:
    return Prim("mul_")


def div2_() -> Node:
    return Prim("div2_")


def linear_cyc(f) -> Node:
    """linearCyc_ — payload is a she.linear.LinearMap."""
    return Prim("linearCyc_", f)


def add_lit_n(lit, x: Node) -> Node:
    """Metalanguage `>+:` (Arithmetic.hs:31-33)."""
    return App(add_lit(lit), x)


def mul_lit_n(lit, x: Node) -> Node:
    return App(mul_lit(lit), x)


def div2(x: Node) -> Node:
    return App(div2_(), x)


# SHE-level prims (appear in compiled ciphertext expressions)

def mod_switch_pt_() -> Node:
    return Prim("modSwitchPT_")


def mod_switch_(new_qs) -> Node:
    return Prim("modSwitch_", {"new_qs": tuple(new_qs)})


def add_public(pt) -> Node:
    return Prim("addPublic_", pt)


def mul_public(pt) -> Node:
    return Prim("mulPublic_", pt)


def key_switch_quad(hint) -> Node:
    return Prim("keySwitchQuad_", hint)


def tunnel_(hint) -> Node:
    return Prim("tunnel_", hint)


def error_rate_(sk) -> Node:
    return Prim("errorRate_", sk)


# list/pair/string (Language/{List,Pair,String}.hs)

def nil_() -> Node:
    return Prim("nil_")


def cons_() -> Node:
    return Prim("cons_")


def pair_() -> Node:
    return Prim("pair_")


def fst_() -> Node:
    return Prim("fst_")


def snd_() -> Node:
    return Prim("snd_")


def string_(s: str) -> Node:
    return Prim("string_", s)


# object-language functor/applicative/monad hierarchy (Language/Monad.hs).
# The reference needs these so ErrorRateWriter can emit Kleisli object
# programs; in this rebuild ERW is an instrumented evaluation mode
# (interp/error_writer.py, per SURVEY.md §3.5), and these primitives exist
# for API surface parity. The payload names the concrete monad
# ('writer' | 'reader' | 'list') since Python has no type-directed
# instance resolution.

def fmap_(monad: str = "writer") -> Node:
    return Prim("fmap_", monad)


def pure_(monad: str = "writer") -> Node:
    return Prim("pure_", monad)


def ap_(monad: str = "writer") -> Node:
    return Prim("ap_", monad)


def bind_(monad: str = "writer") -> Node:
    return Prim("bind_", monad)


def tell_() -> Node:
    return Prim("tell_", "writer")


def listen_() -> Node:
    return Prim("listen_", "writer")


def ask_() -> Node:
    return Prim("ask_", "reader")


def local_() -> Node:
    return Prim("local_", "reader")


# target-language combinators (Lambda.hs:67-74)

def const_() -> Node:
    return lam(lambda x: lam(lambda _y: x))


def flip_() -> Node:
    return lam(lambda f: lam(lambda x: lam(lambda y: App(App(f, y), x))))


def id_() -> Node:
    return lam(lambda x: x)
