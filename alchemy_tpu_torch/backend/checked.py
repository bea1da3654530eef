"""Checked backend: every array op runs on BOTH the torch backend and the
golden numpy oracle and asserts bit-identity (port of
`alchemy_tpu/backend/checked.py`) — the runtime sanitizer of SURVEY.md §5
("optional checked interpreter comparing every kernel against the exact CPU
model"). Use `get_backend("checked")` anywhere a backend goes; it raises at
the first op whose results differ."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from alchemy_tpu_torch.backend.golden import GoldenBackend


class _Pair(NamedTuple):
    dev: object   # torch tensor
    ref: object   # numpy int64 array

    @property
    def shape(self):
        return self.ref.shape

    def reshape(self, *s):
        return _Pair(self.dev.reshape(*s), self.ref.reshape(*s))

    def permute(self, perm):
        perm = tuple(perm)
        return _Pair(self.dev.permute(perm), self.ref.transpose(perm))

    def __getitem__(self, idx):
        return _Pair(self.dev[idx], self.ref[idx])

    @property
    def ndim(self):
        return self.ref.ndim


class CheckedBackend:
    name = "checked"

    def __init__(self, device="cuda"):
        from alchemy_tpu_torch.backend import golden_backend
        from alchemy_tpu_torch.backend.torch_backend import TorchBackend

        self.fast = TorchBackend(device)
        self.slow: GoldenBackend = golden_backend()

    def _check(self, op: str, d, r):
        if isinstance(d, _Pair):
            return d
        dv = self.fast.to_numpy(d)
        rv = np.asarray(r).astype(np.int64)
        if dv.shape != rv.shape or not np.array_equal(dv, rv):
            bad = np.argwhere(dv != rv) if dv.shape == rv.shape else None
            where = "in shape" if bad is None else f"at {bad[:3].tolist()}"
            got = dv.shape if bad is None else dv[tuple(bad[0])]
            want = rv.shape if bad is None else rv[tuple(bad[0])]
            raise AssertionError(
                f"checked backend: '{op}' diverged {where} (torch={got}, golden={want})")
        return _Pair(d, r)

    def _both(self, op: str, *args, **kw):
        def split(x, which):
            if isinstance(x, _Pair):
                return x.dev if which == 0 else x.ref
            if isinstance(x, (list, tuple)) and x and isinstance(x[0], _Pair):
                return type(x)(split(v, which) for v in x)
            return x

        d = getattr(self.fast, op)(*[split(a, 0) for a in args], **kw)
        r = getattr(self.slow, op)(*[split(a, 1) for a in args], **kw)
        return self._check(op, d, r)

    # -- protocol -----------------------------------------------------------

    def asarray(self, arr, qs):
        return _Pair(self.fast.asarray(arr, qs), self.slow.asarray(arr, qs))

    def to_numpy(self, a):
        return self.slow.to_numpy(a.ref if isinstance(a, _Pair) else a)

    def zeros(self, nlimb, n):
        return _Pair(self.fast.zeros(nlimb, n), self.slow.zeros(nlimb, n))

    def stack_rows(self, rows):
        return _Pair(
            self.fast.stack_rows([r.dev for r in rows]),
            self.slow.stack_rows([r.ref for r in rows]),
        )

    def add(self, a, b, qs):
        return self._both("add", a, b, qs)

    def sub(self, a, b, qs):
        return self._both("sub", a, b, qs)

    def neg(self, a, qs):
        return self._both("neg", a, qs)

    def mul(self, a, b, qs):
        return self._both("mul", a, b, qs)

    def mul_const(self, a, consts, qs):
        return self._both("mul_const", a, consts, qs)

    def sum_terms(self, terms, qs):
        return self._both("sum_terms", terms, qs)

    def axis_matmul(self, a, mats, shape, qs):
        return self._both("axis_matmul", a, mats, shape, qs)

    def rescale_step(self, data, qs, zp):
        return self._both("rescale_step", data, qs, zp)

    def modswitch_up(self, data, old_qs, new_qs):
        return self._both("modswitch_up", data, old_qs, new_qs)

    def gadget_digit_rows(self, data, qs, base):
        return self._both("gadget_digit_rows", data, qs, base)

    def hybrid_digit_rows(self, data, qs, groups, ext_qs):
        return self._both("hybrid_digit_rows", data, qs, groups, ext_qs)

    def broadcast_row(self, row, nlimb, qs):
        return _Pair(
            self.fast.broadcast_row(row, nlimb, qs),
            self.slow.broadcast_row(row, nlimb, qs),
        )

    def reduce_signed(self, a_signed, qs):
        return _Pair(
            self.fast.reduce_signed(a_signed, qs),
            self.slow.reduce_signed(a_signed, qs),
        )

    def lift_centered(self, a, qs):
        return self.slow.lift_centered(a.ref if isinstance(a, _Pair) else a, qs)
