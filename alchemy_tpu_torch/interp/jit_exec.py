"""Compiled ciphertext programs as CUDA graphs — port of
`alchemy_tpu/interp/jit_exec.py`.

The JAX package traces the evaluation of a compiled program into one XLA
executable, so that no op is dispatched from Python on a call (jit_exec.py:1).
The port keeps the eager evaluator and captures one run of it in a
`torch.cuda.CUDAGraph`: a call copies its ciphertexts into the graph's
static input buffers and replays every launch of the program at once.

What the JAX version settles at trace time is settled here at build time:
- ciphertext metadata (rings, chains, scales, bases) is static: a call whose
  arguments differ from the build's `arg_meta` raises ValueError;
- key-switch and tunnel hints (`_HOISTED`, which the JAX version passes as
  traced arguments) stay device tensors that the graph reads in place; the
  build checks that they lie on the arguments' device;
- public plaintexts (addPublic_/mulPublic_, which the JAX version embeds at
  trace time) become `bgv.PublicPT`s, embedded once in the warm-up run;
- every cache that uploads on first use (`TorchBackend` transform matrices,
  `modarith.qcol`, `SK.as_cyc`, the hybrid base-extension constants) is
  filled by the warm-up run, and the build checks that the captured run
  moved nothing between host and device (`TorchBackend.counts`).

With `noise_probe` the program is kleislified in its lenient form
(`write_error_rates(..., strict=False)`): every probed op's [L] error-digit
vector (she/noise_probe.py) is an output of the graph, and after each
replay `resolve_log` reads them back in one copy and, with strict=True,
raises NoiseOverflowError before the call returns its ciphertext (the
reference checks after handing the ciphertext out, jit_exec.py:484).

On a CPU backend (`TorchBackend("cpu")`, which the caller asks for) the same
prepared program runs eagerly on each call, with no graph. On the card a
failed capture raises; the call never falls back to eager evaluation.

With `mesh` (a DeviceMesh of the initialised world with 'limb' and 'coeff'
axes, `parallel/mesh.py`) the program runs SPMD on the mesh's ranks, each
calling the same `JitCompiled` on the same ciphertexts
(`parallel/spmd.py`, the port of the JAX version's GSPMD partition): every
rank keeps only its block of each argument and of each hoisted hint, laid
out by `_auto_sharding` (limb-TP over 'limb', coefficient-SP over 'coeff',
replicated with a ShardingFallbackWarning where an axis does not split;
`limb_pad` pads an odd chain to the 'limb' axis instead), and runs the
program on a `ShardedTorchBackend`, which does the collectives the ops
need. A call returns a CT whose components hold this rank's blocks
(`ShardArray`s); `gather` makes the whole ciphertext. The group's backend
chooses, at build time, how calls run: over NCCL on the card each rank
captures its program, collectives included, in one CUDA graph; over gloo
(the CPU, or ranks sharing a card) the prepared program runs eagerly on
each call. It is never a reaction to a failure. `collectives` counts one
call's collectives by (op, mesh axis); `arg_bytes` gives the bytes of
arguments and hints a rank holds.

Spans (`utils/profiling.py`): each call is one root span `jit_call`
(attributes `prims`, the prims of the prepared program; `m`, the ring index
m′ of the output's components; `L`, the first argument's limbs; `graph`)
with one child, `jit.replay` around the graph's replay or `jit.eager`
around the eager run, inside which the evaluator opens an `ir.<prim>` span
a prim (`interp/eval.py`); a replay runs no Python, so it has no `ir.*`
span. The argument checks, the copies into the graph's inputs and the
output clones are the root's own time. `prims` counts the prepared
program's prims by name, fixed at build.

Not carried over: the JAX version's AOT artifact cache (a CUDA graph cannot
be written to disk; the build is one eager run and one capture) and its
`.lowered`/`.executable` attributes (no XLA lowering; the collective counts
and `arg_bytes` are the port's partition proof).
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch
import torch.distributed as dist

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.ring import get_ring
from alchemy_tpu_torch.interp.error_writer import resolve_log, write_error_rates
from alchemy_tpu_torch.interp.eval import eval_ir
from alchemy_tpu_torch.interp.pt2ct import CompiledExpr
from alchemy_tpu_torch.lang.ir import App, Lam, Node, Prim
from alchemy_tpu_torch.parallel.spmd import (
    ShardedTorchBackend,
    ShardingFallbackWarning,  # noqa: F401  (jit_exec.py:83)
    layout_for,
    placements,
)
from alchemy_tpu_torch.she.bgv import PublicPT
from alchemy_tpu_torch.she.ct import CT
from alchemy_tpu_torch.she.noise_probe import DeferredRate
from alchemy_tpu_torch.utils.profiling import span

#: prims whose payloads hold the program's large device data (jit_exec.py:80)
_HOISTED = {"keySwitchQuad_", "tunnel_"}
#: prims whose payloads are public plaintexts, embedded once at build time
_PUBLIC = {"addPublic_", "mulPublic_"}
#: `TorchBackend.counts` keys of copies between host and device
_COPIES = ("to_host", "to_device", "mat_upload")


def _cyc_meta(c: Cyc) -> tuple:
    return (c.m, c.qs, c.basis)


def _ct_meta(ct: CT) -> tuple:
    return (ct.m, ct.zp, ct.scale, [_cyc_meta(c) for c in ct.comps])


def _device(d) -> torch.device:
    """A device with its index: "cuda" is the current card."""
    d = torch.device(d)
    return torch.device("cuda", torch.cuda.current_device()) if d == torch.device("cuda") else d


def _auto_sharding(arr, mesh, warn: bool = True) -> tuple:
    """The placements, one per mesh dimension, of a [L, n_flat] residue
    array on `mesh` (jit_exec.py:90): Shard(0) on 'limb' when L divides it,
    Shard(1) on 'coeff' when n_flat divides it, Replicate otherwise, with a
    ShardingFallbackWarning, never silently."""
    return placements(mesh, *layout_for(tuple(arr.shape), mesh, warn=warn))


def _map_payload(payload, fn):
    """The payload with every Cyc c replaced by fn(c) (hints are dataclasses
    of tuples and lists of Cycs)."""
    if isinstance(payload, Cyc):
        return fn(payload)
    if dataclasses.is_dataclass(payload) and not isinstance(payload, type):
        return dataclasses.replace(payload, **{
            f.name: _map_payload(getattr(payload, f.name), fn)
            for f in dataclasses.fields(payload) if f.init})
    if isinstance(payload, (tuple, list)):
        return type(payload)(_map_payload(x, fn) for x in payload)
    return payload


def _payload_cycs(payload):
    """Every Cyc inside a prim payload (hints are dataclasses of tuples and
    lists of Cycs)."""
    if isinstance(payload, Cyc):
        yield payload
    elif dataclasses.is_dataclass(payload) and not isinstance(payload, type):
        for f in dataclasses.fields(payload):
            yield from _payload_cycs(getattr(payload, f.name))
    elif isinstance(payload, (tuple, list)):
        for x in payload:
            yield from _payload_cycs(x)


class JitCompiled:
    """A compiled program prepared for repeated calls on ciphertexts with the
    metadata of `example_cts`: a CUDA graph on the card, the prepared eager
    program on the CPU; with `mesh`, this rank's part of the program over
    the mesh (a graph over NCCL, eager over gloo). Call it with the
    ciphertexts; it returns a CT, or (CT, [(label, rate)]) with a noise
    probe."""

    def __init__(self, compiled: CompiledExpr, example_cts: list[CT], mesh=None,
                 limb_pad: bool = True, noise_probe=None, strict: bool = False):
        self.compiled = compiled
        self.mesh = mesh
        self.probe_ctx = noise_probe
        self.probe_strict = strict
        self.arg_meta = [_ct_meta(ct) for ct in example_cts]
        self.bk = example_cts[0].bk
        if self.bk.name != "torch":
            raise ValueError(f"jit_compile wants ciphertexts on a TorchBackend, not {self.bk.name}")
        self.sbk = None if mesh is None else ShardedTorchBackend(mesh, limb_pad)
        self.device = _device(self.bk.device) if mesh is None else self.sbk.device
        self._backends = {id(self.bk): self.bk}
        if mesh is not None:
            self._backends[id(self.sbk.tb)] = self.sbk.tb
        if noise_probe is not None and noise_probe.bk.name == "torch":
            self._backends[id(noise_probe.bk)] = noise_probe.bk
        #: the hoisted hint arrays the program reads (this rank's blocks with a mesh)
        self._hints: dict = {}
        comps = [c for ct in example_cts for c in ct.comps]
        self._layouts = None if mesh is None else [self.sbk.layout(tuple(c.data.shape))
                                                    for c in comps]
        self.ir = self._prepare(compiled.ir)
        self.program = (self.ir if noise_probe is None
                        else write_error_rates(self.ir, noise_probe, strict=False))
        #: the prepared program's prims by name: what one call evaluates
        self.prims: Counter = _prim_counts(self.program)
        flat = self._flat(example_cts)
        self._arg_bytes = sum(_nbytes(t) for t in flat)
        #: one call's collectives by (op, mesh axis) (a graph's: its capture's)
        self.collectives: Counter = Counter()
        self.graph = None
        if self.device.type == "cuda" and (mesh is None or all(
                dist.get_backend(mesh.get_group(i)) == "nccl" for i in range(mesh.ndim))):
            self._capture(flat)

    # -- build --------------------------------------------------------------

    def _shard_cyc(self, c: Cyc) -> Cyc:
        """A hoisted Cyc on this rank: its block on the sharded backend (one
        per tensor, however many prims share it)."""
        key = id(c.data)
        if key not in self._hints:
            self._hints[key] = self.sbk.shard(c.data, *self.sbk.layout(tuple(c.data.shape)))
        return Cyc(c.ring, c.qs, c.basis, self._hints[key], self.sbk)

    def _prepare(self, node: Node) -> Node:
        """The program with public plaintexts as `PublicPT`s, after checking
        that every hoisted payload lies on a torch backend (on the arguments'
        device without a mesh; with one, replaced by this rank's blocks)."""
        if isinstance(node, Lam):
            return Lam(self._prepare(node.body))
        if isinstance(node, App):
            return App(self._prepare(node.f), self._prepare(node.a))
        if isinstance(node, Prim) and node.name in _PUBLIC:
            return Prim(node.name, PublicPT(node.payload), ann=node.ann)
        if isinstance(node, Prim) and node.name in _HOISTED:
            for c in _payload_cycs(node.payload):
                dev = getattr(c.data, "device", None)
                if c.bk.name != "torch" or (self.mesh is None and dev != self.device):
                    raise ValueError(f"{node.name}: a payload lies on {c.bk.name} "
                                     f"{dev}, the arguments on {self.device}")
                self._backends[id(c.bk)] = c.bk
                if self.mesh is None:
                    self._hints[id(c.data)] = c.data
            if self.mesh is not None:
                return Prim(node.name, _map_payload(node.payload, self._shard_cyc), ann=node.ann)
        return node

    def _flat(self, cts) -> list:
        """The arguments' component arrays as the program reads them (this
        rank's blocks, on its device, with a mesh)."""
        comps = [c.data for ct in cts for c in ct.comps]
        if self.mesh is None:
            return comps
        return [self.sbk.shard(t, *lay) for t, lay in zip(comps, self._layouts)]

    def _cts(self, flat) -> list[CT]:
        bk = self.bk if self.mesh is None else self.sbk
        cts, i = [], 0
        for (m, zp, scale, comps_meta) in self.arg_meta:
            comps = tuple(Cyc(get_ring(cm), qs, basis, flat[i + k], bk)
                          for k, (cm, qs, basis) in enumerate(comps_meta))
            i += len(comps)
            cts.append(CT(m=m, zp=zp, scale=scale, comps=comps))
        return cts

    def _run(self, flat):
        """One eager run of the prepared program on the component arrays
        `flat`: (result CT, log of (label, rate or DeferredRate)); with a
        mesh, the result's blocks in the `_auto_sharding` layout and the
        run's collectives in `collectives`."""
        cts = self._cts(flat)
        if self.sbk is not None:
            self.sbk.reset_collectives()
        if self.probe_ctx is None:
            out, log = eval_ir(self.program, *cts), []
        else:
            out, log = eval_ir(self.program)
            for ct in cts:
                out, more = out(ct)
                log = log + more
        if self.sbk is not None:
            out = out.with_comps(tuple(c.like(self.sbk.canonical(c.data)) for c in out.comps))
            self.collectives = Counter(self.sbk.collectives)
        return out, list(log)

    def _copies(self) -> Counter:
        return Counter({(i, k): bk.counts[k] for i, bk in self._backends.items()
                        for k in _COPIES})

    def _capture(self, example_flat) -> None:
        """Warm-up on a side stream (fills every upload cache), then one
        capture into a CUDA graph with static input buffers."""
        self._inputs = [_clone(t) for t in example_flat]
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._run(self._inputs)
        cur.wait_stream(side)
        torch.cuda.synchronize(self.device)
        before = self._copies()
        self.graph = torch.cuda.CUDAGraph()
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.graph(self.graph):
            # a sync or a host copy inside an op raises here, at the op,
            # instead of invalidating the capture
            torch.cuda.set_sync_debug_mode("error")
            try:
                out, log = self._run(self._inputs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        moved = self._copies() - before
        if moved:
            raise RuntimeError(f"jit_compile: the captured run copied between host and "
                               f"device: {dict(moved)}")
        if not all(isinstance(r, DeferredRate) for _, r in log):
            raise RuntimeError("jit_compile: a probe ran on the host; the noise probe's "
                               "context must be on a torch backend on the card")
        self.out_meta = _ct_meta(out)
        self._outputs = [c.data for c in out.comps]
        self.log_meta = [(label, r.qs) for label, r in log]
        self._digits = [r.digits for _, r in log]

    # -- calls --------------------------------------------------------------

    def _check_args(self, cts) -> None:
        if len(cts) != len(self.arg_meta):
            raise ValueError(f"{len(cts)} ciphertexts: the program was built for "
                             f"{len(self.arg_meta)}")
        for i, (ct, meta) in enumerate(zip(cts, self.arg_meta)):
            if _ct_meta(ct) != meta:
                raise ValueError(f"argument {i}: metadata {_ct_meta(ct)} != the build's {meta}")
            for c in ct.comps:
                if self.mesh is None and getattr(c.data, "device", None) != self.device:
                    raise ValueError(f"argument {i} lies on {getattr(c.data, 'device', None)}, "
                                     f"the program on {self.device}")

    def __call__(self, *cts: CT):
        with span("jit_call") as root:
            self._check_args(cts)
            if self.graph is None:
                with span("jit.eager"):
                    out, log = self._run(self._flat(cts))
            else:
                for buf, t in zip(self._inputs, self._flat(cts)):
                    _local(buf).copy_(_local(t))
                with span("jit.replay"):
                    self.graph.replay()
                m, zp, scale, comps_meta = self.out_meta
                bk = self.bk if self.mesh is None else self.sbk
                # fresh tensors: the next replay overwrites the graph's own outputs
                out = CT(m=m, zp=zp, scale=scale, comps=tuple(
                    Cyc(get_ring(cm), qs, basis, _clone(t), bk)
                    for (cm, qs, basis), t in zip(comps_meta, self._outputs)))
                log = [(label, DeferredRate(d, qs))
                       for (label, qs), d in zip(self.log_meta, self._digits)]
            if root is not None:
                root.attrs.update(prims=sum(self.prims.values()), m=out.m_prime,
                                  L=len(cts[0].qs), graph=self.graph is not None)
            if self.probe_ctx is None:
                return out
            # strict: an overflow raises here, before the ciphertext is returned
            return out, resolve_log(log, strict=self.probe_strict)

    # -- the mesh's results -------------------------------------------------

    def gather(self, ct: CT) -> CT:
        """The whole ciphertext of a result's blocks, on the arguments'
        backend (collectives over the mesh: every rank calls it); `ct`
        itself without a mesh. `compiled.decrypt` takes it."""
        if self.mesh is None:
            return ct
        return ct.with_comps(tuple(
            Cyc(c.ring, c.qs, c.basis, self.sbk.full(c.data).to(self.bk.device), self.bk)
            for c in ct.comps))

    def arg_bytes(self) -> dict:
        """The bytes of arguments and of hoisted hints the program holds on
        this rank (the port's counterpart of the JAX partition proof's
        `argument_size_in_bytes`)."""
        return {"args": self._arg_bytes,
                "hints": sum(_nbytes(t) for t in self._hints.values())}


def _prim_counts(node: Node) -> Counter:
    """The prims of a program by name."""
    if isinstance(node, Lam):
        return _prim_counts(node.body)
    if isinstance(node, App):
        return _prim_counts(node.f) + _prim_counts(node.a)
    return Counter([node.name]) if isinstance(node, Prim) else Counter()


def _local(t):
    """The tensor of a component array (a ShardArray's block)."""
    return getattr(t, "local", t)


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _clone(t):
    if isinstance(t, torch.Tensor):
        return t.clone()
    return type(t)(t.bk, t.local.clone(), t.shape, t.la, t.lsh, t.csh)


def jit_compile(compiled: CompiledExpr, example_cts: list[CT], mesh=None,
                limb_pad: bool = True, noise_probe=None, strict: bool = False) -> JitCompiled:
    """Prepare the whole ciphertext program for repeated calls: one CUDA
    graph on the card (`JitCompiled`). `example_cts` fix the static
    argument metadata; they lie on a `TorchBackend`.

    With `mesh` (a DeviceMesh with 'limb' and 'coeff' axes; every rank of it
    calls this and then each call with the same ciphertexts) the program
    runs sharded over the mesh: arguments and hoisted hints laid out by
    `_auto_sharding` (odd chain lengths zero-padded to the 'limb' axis with
    `limb_pad`), results as this rank's blocks (`JitCompiled.gather` for the
    whole ciphertext); a CUDA graph per rank over NCCL, eager over gloo.

    With `noise_probe` (a KeysHints context holding the secret keys, on a
    torch backend) each call also returns the reference's error-rate log
    [(op ++ modulus, rate)], read back in one copy; with strict=True a rate
    past the decryption-failure threshold raises NoiseOverflowError and the
    call returns no ciphertext. Eager strict evaluation stops at the first
    overflowing op; a replay runs the whole program and raises after it."""
    return JitCompiled(compiled, example_cts, mesh=mesh, limb_pad=limb_pad,
                       noise_probe=noise_probe, strict=strict)
