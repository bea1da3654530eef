"""Checkpoints of keys, hints and the compiled schedule — port of
`alchemy_tpu/she/serialize.py`, in the same file format.

A checkpoint holds the KeysHints context (secret keys and the memoized
quad-circ hints), the compiled ciphertext IR with its op payloads (public
plaintexts, key-switch and tunnel hints, modSwitch targets), the typing of
the encryption boundary (argument and result PtTys, the m′ map, the RNS
chain, the gadget) and optionally named ciphertexts. Everything lands in one
`.npz`: residue arrays as int64 plus one JSON metadata blob (version 1),
with the JAX package's keys and names, so a file written by either package
loads in the other. `load_checkpoint` rebuilds a working `CompiledExpr` on
any backend of the port, the card (`get_backend("torch")`) by default.

Three departures from the reference, none of them in the format: files are
read with `allow_pickle=False`; `npz_path` gives a path without the suffix
".npz" one on save and on load alike (`np.savez_compressed` appends it, and
the reference then loads the raw path); and, as in the reference, a loaded
context always reseeds its RNG from OS entropy.
"""

from __future__ import annotations

import json
import secrets

import numpy as np

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.ring import get_ring
from alchemy_tpu_torch.interp.keys_hints import KeysHints
from alchemy_tpu_torch.lang.ir import App, Lam, Node, Prim, Var
from alchemy_tpu_torch.she.gadget import BaseBGad, HybridGad, TrivGad
from alchemy_tpu_torch.she.keys import SK

FORMAT_VERSION = 1


def npz_path(path) -> str:
    """`path` with the suffix ".npz" added if it lacks one: where
    `np.savez` writes, and where every loader of the port reads."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _load(path):
    data = np.load(npz_path(path), allow_pickle=False)
    return data, json.loads(bytes(data["__meta__"]).decode())


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _rng_state(ctx: KeysHints) -> dict:
    """The context's RNG stream position, recorded for the record only (see
    `_restore_rng`)."""
    return ctx.rng.bit_generator.state


def _restore_rng(ctx: KeysHints, state: dict | None) -> None:
    """Reseed a resumed context from OS entropy (serialize.py:45). Restoring
    the saved position would make two processes resuming one checkpoint
    draw the same (a, e) encryption randomness under the same key, and the
    difference of their ciphertexts would cancel the a·s mask."""
    del state
    ctx.rng = np.random.default_rng(secrets.randbits(128))


def _default_backend(bk):
    if bk is None:
        from alchemy_tpu_torch.backend import get_backend

        bk = get_backend("torch")
    return bk


def save_keys(ctx: KeysHints, path) -> None:
    """Persist the secret keys only (serialize.py:60)."""
    arrays = {f"sk_{m}": sk.coeffs for m, sk in ctx.keys.items()}
    meta = [{"m": m, "variance": sk.variance} for m, sk in ctx.keys.items()]
    arrays["__meta__"] = _meta_array({"r": ctx.r, "keys": meta, "rng": _rng_state(ctx)})
    np.savez_compressed(npz_path(path), **arrays)


def load_keys(path, bk=None) -> KeysHints:
    """A context holding the saved keys, on bk (the card by default)."""
    data, meta = _load(path)
    ctx = KeysHints(meta["r"], bk=_default_backend(bk))
    _restore_rng(ctx, meta.get("rng"))
    for entry in meta["keys"]:
        m = entry["m"]
        ctx.keys[m] = SK(m, entry["variance"], data[f"sk_{m}"].astype(np.int64))
    return ctx


# ---------------------------------------------------------------------------
# full checkpoint: keys + hints + compiled schedule (+ named ciphertexts)
# ---------------------------------------------------------------------------


def _gadget_meta(g) -> dict:
    if isinstance(g, TrivGad):
        return {"t": "triv"}
    if isinstance(g, BaseBGad):
        return {"t": "baseb", "base": g.base}
    if isinstance(g, HybridGad):
        return {"t": "hybrid", "dnum": g.dnum, "sp_bits": g.sp_bits}
    raise TypeError(f"unserializable gadget {g!r}")


def _gadget(d):
    if d["t"] == "triv":
        return TrivGad()
    if d["t"] == "baseb":
        return BaseBGad(d["base"])
    if d["t"] == "hybrid":
        return HybridGad(d["dnum"], d["sp_bits"])
    raise ValueError(d)


class _Saver:
    def __init__(self):
        self.arrays: dict[str, np.ndarray] = {}
        self._hint_ids: dict[int, int] = {}
        self.hint_table: list[dict] = []

    def arr(self, a) -> str:
        name = f"a{len(self.arrays)}"
        self.arrays[name] = np.asarray(a, dtype=np.int64)
        return name

    def cyc(self, c: Cyc) -> dict:
        return {"m": c.m, "qs": list(c.qs), "basis": c.basis,
                "ref": self.arr(c.bk.to_numpy(c.data))}

    def hint(self, h) -> int:
        """Serialize a hint once: the IR and the context's hint cache share
        its table slot."""
        if id(h) in self._hint_ids:
            return self._hint_ids[id(h)]
        from alchemy_tpu_torch.she.bgv import KSQuadCircHint
        from alchemy_tpu_torch.she.tunnel import TunnelHint

        if isinstance(h, KSQuadCircHint):
            entry = {
                "t": "quad", "m_prime": h.m_prime, "qs": list(h.qs),
                "gad": _gadget_meta(h.gadget), "zp": h.zp,
                "ext_qs": list(h.ext_qs) if h.ext_qs is not None else None,
                "rows": [[self.cyc(b), self.cyc(a)] for b, a in h.rows],
            }
        elif isinstance(h, TunnelHint):
            f = h.f
            entry = {
                "t": "tunnel",
                "f": {"e": f.e, "r": f.r, "s": f.s, "basis": f.basis,
                      "images": [self.cyc(c) for c in f.images]},
                "e_p": h.e_p, "r_p": h.r_p, "s_p": h.s_p,
                "qs": list(h.qs), "gad": _gadget_meta(h.gadget), "zp": h.zp,
                "images_sp": [self.cyc(c) for c in h.images_sp],
                "rows": [[[self.cyc(b), self.cyc(a)] for b, a in dim] for dim in h.rows],
            }
        else:
            raise TypeError(f"unserializable hint {type(h).__name__}")
        self.hint_table.append(entry)
        self._hint_ids[id(h)] = len(self.hint_table) - 1
        return len(self.hint_table) - 1

    def ir(self, node: Node) -> dict:
        if isinstance(node, Var):
            return {"t": "var", "i": node.idx}
        if isinstance(node, Lam):
            return {"t": "lam", "b": self.ir(node.body)}
        if isinstance(node, App):
            return {"t": "app", "f": self.ir(node.f), "a": self.ir(node.a)}
        if isinstance(node, Prim):
            out = {"t": "prim", "name": node.name, "ann": node.ann}
            p = node.payload
            if p is None:
                out["p"] = None
            elif isinstance(p, Cyc):
                out["p"] = {"k": "cyc", **self.cyc(p)}
            elif isinstance(p, dict) and set(p) == {"new_qs"}:
                out["p"] = {"k": "modswitch", "new_qs": list(p["new_qs"])}
            elif isinstance(p, (int, np.integer)):
                out["p"] = {"k": "int", "v": int(p)}
            else:
                out["p"] = {"k": "hint", "i": self.hint(p)}
            return out
        raise TypeError(f"unserializable IR node {node!r}")

    def ct(self, ct) -> dict:
        return {"m": ct.m, "zp": ct.zp, "scale": ct.scale,
                "comps": [self.cyc(c) for c in ct.comps]}


def save_checkpoint(compiled, path, cts: dict | None = None) -> None:
    """Persist a CompiledExpr (interp/pt2ct.py): keys, hints and the
    compiled ciphertext program, plus optional named ciphertexts
    (serialize.py:182)."""
    s = _Saver()
    ctx = compiled.ctx
    keys_meta = [{"m": m, "variance": sk.variance, "ref": s.arr(sk.coeffs)}
                 for m, sk in ctx.keys.items()]
    hints_meta = []
    for (kind, m_prime, qs, gad, zp), h in ctx.hints.items():
        hints_meta.append({"kind": kind, "m_prime": m_prime, "qs": list(qs),
                           "gad": _gadget_meta(gad), "zp": zp, "i": s.hint(h)})
    meta = {
        "version": FORMAT_VERSION,
        "r": ctx.r,
        "rng": _rng_state(ctx),
        "keys": keys_meta,
        "hints": hints_meta,
        "ir": s.ir(compiled.ir),
        "hint_table": s.hint_table,
        "arg_tys": [{"pnoise": t.pnoise, "m": t.m, "zp": t.zp} for t in compiled.arg_tys],
        "res_ty": {"pnoise": compiled.res_ty.pnoise, "m": compiled.res_ty.m,
                   "zp": compiled.res_ty.zp},
        "m_map": [[k, v] for k, v in compiled.m_map.items()],
        "zqs": list(compiled.ledger.chain.qs),
        "gad": _gadget_meta(compiled.gad),
        "cts": {name: s.ct(c) for name, c in (cts or {}).items()},
    }
    s.arrays["__meta__"] = _meta_array(meta)
    np.savez_compressed(npz_path(path), **s.arrays)


class _Loader:
    def __init__(self, data, meta, bk):
        self.data = data
        self.meta = meta
        self.bk = bk
        self._hints: dict[int, object] = {}

    def cyc(self, d) -> Cyc:
        qs = tuple(d["qs"])
        arr = self.data[d["ref"]].astype(np.int64)
        return Cyc(get_ring(d["m"]), qs, d["basis"], self.bk.asarray(arr, qs), self.bk)

    def hint(self, i: int):
        if i in self._hints:
            return self._hints[i]
        d = self.meta["hint_table"][i]
        if d["t"] == "quad":
            from alchemy_tpu_torch.she.bgv import KSQuadCircHint

            h = KSQuadCircHint(
                d["m_prime"], tuple(d["qs"]), _gadget(d["gad"]), d["zp"],
                tuple((self.cyc(b), self.cyc(a)) for b, a in d["rows"]),
                ext_qs=tuple(d["ext_qs"]) if d["ext_qs"] is not None else None,
            )
        elif d["t"] == "tunnel":
            from alchemy_tpu_torch.she.linear import LinearMap
            from alchemy_tpu_torch.she.tunnel import TunnelHint

            fd = d["f"]
            f = LinearMap(fd["e"], fd["r"], fd["s"],
                          tuple(self.cyc(c) for c in fd["images"]), fd["basis"])
            h = TunnelHint(
                f, d["e_p"], d["r_p"], d["s_p"], tuple(d["qs"]), _gadget(d["gad"]), d["zp"],
                [self.cyc(c) for c in d["images_sp"]],
                tuple(tuple((self.cyc(b), self.cyc(a)) for b, a in dim) for dim in d["rows"]),
            )
        else:
            raise ValueError(d)
        self._hints[i] = h
        return h

    def ir(self, d) -> Node:
        t = d["t"]
        if t == "var":
            return Var(d["i"])
        if t == "lam":
            return Lam(self.ir(d["b"]))
        if t == "app":
            return App(self.ir(d["f"]), self.ir(d["a"]))
        if t == "prim":
            p = d["p"]
            if p is None:
                payload = None
            elif p["k"] == "cyc":
                payload = self.cyc(p)
            elif p["k"] == "modswitch":
                payload = {"new_qs": tuple(p["new_qs"])}
            elif p["k"] == "int":
                payload = p["v"]
            else:
                payload = self.hint(p["i"])
            return Prim(d["name"], payload, ann=d["ann"])
        raise ValueError(d)

    def ct(self, d):
        from alchemy_tpu_torch.she.ct import CT

        return CT(d["m"], d["zp"], d["scale"], tuple(self.cyc(c) for c in d["comps"]))


def load_checkpoint(path, bk=None):
    """Rebuild (CompiledExpr, {name: CT}) from `save_checkpoint`'s file, or
    the JAX package's, on bk (the card by default; serialize.py:299)."""
    from alchemy_tpu_torch.core.params import RnsChain
    from alchemy_tpu_torch.interp.noise import NoiseLedger, PtTy
    from alchemy_tpu_torch.interp.pt2ct import CompiledExpr

    bk = _default_backend(bk)
    data, meta = _load(path)
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta.get('version')!r}: want {FORMAT_VERSION}")
    ld = _Loader(data, meta, bk)
    ctx = KeysHints(meta["r"], bk=bk)
    _restore_rng(ctx, meta.get("rng"))
    for entry in meta["keys"]:
        ctx.keys[entry["m"]] = SK(entry["m"], entry["variance"],
                                  data[entry["ref"]].astype(np.int64))
    for entry in meta["hints"]:
        key = (entry["kind"], entry["m_prime"], tuple(entry["qs"]), _gadget(entry["gad"]),
               entry["zp"])
        ctx.hints[key] = ld.hint(entry["i"])
    compiled = CompiledExpr(
        ir=ld.ir(meta["ir"]),
        arg_tys=tuple(PtTy(**t) for t in meta["arg_tys"]),
        res_ty=PtTy(**meta["res_ty"]),
        m_map={k: v for k, v in meta["m_map"]},
        ledger=NoiseLedger(RnsChain(meta["zqs"])),
        gad=_gadget(meta["gad"]),
        ctx=ctx,
    )
    cts = {name: ld.ct(d) for name, d in meta["cts"].items()}
    return compiled, cts
