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
failed capture raises; the call never falls back to eager evaluation. Not
carried over: the JAX version's AOT artifact cache (a CUDA graph cannot be
written to disk; the build is one eager run and one capture) and its mesh
arguments (`mesh`, `limb_pad`: the parallel layer).
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.ring import get_ring
from alchemy_tpu_torch.interp.error_writer import resolve_log, write_error_rates
from alchemy_tpu_torch.interp.eval import eval_ir
from alchemy_tpu_torch.interp.pt2ct import CompiledExpr
from alchemy_tpu_torch.lang.ir import App, Lam, Node, Prim
from alchemy_tpu_torch.she.bgv import PublicPT
from alchemy_tpu_torch.she.ct import CT
from alchemy_tpu_torch.she.noise_probe import DeferredRate

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
    program on the CPU. Call it with the ciphertexts; it returns a CT, or
    (CT, [(label, rate)]) with a noise probe."""

    def __init__(self, compiled: CompiledExpr, example_cts: list[CT], noise_probe=None,
                 strict: bool = False):
        self.compiled = compiled
        self.probe_ctx = noise_probe
        self.probe_strict = strict
        self.arg_meta = [_ct_meta(ct) for ct in example_cts]
        self.bk = example_cts[0].bk
        if self.bk.name != "torch":
            raise ValueError(f"jit_compile wants ciphertexts on a TorchBackend, not {self.bk.name}")
        self.device = _device(self.bk.device)
        self._backends = {id(self.bk): self.bk}
        if noise_probe is not None and noise_probe.bk.name == "torch":
            self._backends[id(noise_probe.bk)] = noise_probe.bk
        self.ir = self._prepare(compiled.ir)
        self.program = (self.ir if noise_probe is None
                        else write_error_rates(self.ir, noise_probe, strict=False))
        self.graph = None
        if self.device.type == "cuda":
            self._capture([c.data for ct in example_cts for c in ct.comps])

    # -- build --------------------------------------------------------------

    def _prepare(self, node: Node) -> Node:
        """The program with public plaintexts as `PublicPT`s, after checking
        that every hoisted payload lies on the arguments' device."""
        if isinstance(node, Lam):
            return Lam(self._prepare(node.body))
        if isinstance(node, App):
            return App(self._prepare(node.f), self._prepare(node.a))
        if isinstance(node, Prim) and node.name in _PUBLIC:
            return Prim(node.name, PublicPT(node.payload), ann=node.ann)
        if isinstance(node, Prim) and node.name in _HOISTED:
            for c in _payload_cycs(node.payload):
                dev = getattr(c.data, "device", None)
                if c.bk.name != "torch" or dev != self.device:
                    raise ValueError(f"{node.name}: a payload lies on {c.bk.name} "
                                     f"{dev}, the arguments on {self.device}")
                self._backends[id(c.bk)] = c.bk
        return node

    def _cts(self, flat) -> list[CT]:
        cts, i = [], 0
        for (m, zp, scale, comps_meta) in self.arg_meta:
            comps = tuple(Cyc(get_ring(cm), qs, basis, flat[i + k], self.bk)
                          for k, (cm, qs, basis) in enumerate(comps_meta))
            i += len(comps)
            cts.append(CT(m=m, zp=zp, scale=scale, comps=comps))
        return cts

    def _run(self, flat):
        """One eager run of the prepared program on the component tensors
        `flat`: (result CT, log of (label, rate or DeferredRate))."""
        cts = self._cts(flat)
        if self.probe_ctx is None:
            return eval_ir(self.program, *cts), []
        out, log = eval_ir(self.program)
        for ct in cts:
            out, more = out(ct)
            log = log + more
        return out, list(log)

    def _copies(self) -> Counter:
        return Counter({(i, k): bk.counts[k] for i, bk in self._backends.items()
                        for k in _COPIES})

    def _capture(self, example_flat) -> None:
        """Warm-up on a side stream (fills every upload cache), then one
        capture into a CUDA graph with static input buffers."""
        self._inputs = [t.clone() for t in example_flat]
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
                if getattr(c.data, "device", None) != self.device:
                    raise ValueError(f"argument {i} lies on {getattr(c.data, 'device', None)}, "
                                     f"the program on {self.device}")

    def __call__(self, *cts: CT):
        self._check_args(cts)
        if self.graph is None:
            out, log = self._run([c.data for ct in cts for c in ct.comps])
        else:
            for buf, c in zip(self._inputs, (c for ct in cts for c in ct.comps)):
                buf.copy_(c.data)
            self.graph.replay()
            m, zp, scale, comps_meta = self.out_meta
            # fresh tensors: the next replay overwrites the graph's own outputs
            out = CT(m=m, zp=zp, scale=scale, comps=tuple(
                Cyc(get_ring(cm), qs, basis, t.clone(), self.bk)
                for (cm, qs, basis), t in zip(comps_meta, self._outputs)))
            log = [(label, DeferredRate(d, qs))
                   for (label, qs), d in zip(self.log_meta, self._digits)]
        if self.probe_ctx is None:
            return out
        # strict: an overflow raises here, before the ciphertext is returned
        return out, resolve_log(log, strict=self.probe_strict)


def jit_compile(compiled: CompiledExpr, example_cts: list[CT], noise_probe=None,
                strict: bool = False) -> JitCompiled:
    """Prepare the whole ciphertext program for repeated calls: one CUDA
    graph on the card (`JitCompiled`). `example_cts` fix the static
    argument metadata; they lie on a `TorchBackend`.

    With `noise_probe` (a KeysHints context holding the secret keys, on a
    torch backend) each call also returns the reference's error-rate log
    [(op ++ modulus, rate)], read back in one copy; with strict=True a rate
    past the decryption-failure threshold raises NoiseOverflowError and the
    call returns no ciphertext. Eager strict evaluation stops at the first
    overflowing op; a replay runs the whole program and raises after it."""
    return JitCompiled(compiled, example_cts, noise_probe=noise_probe, strict=strict)
