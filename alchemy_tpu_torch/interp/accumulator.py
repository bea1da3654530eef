"""Append-only accumulation (reference Crypto/Alchemy/MonadAccumulator.hs).

The reference's `MonadAccumulator w m` is an append-only state class with
`append` / `accumulate` (MonadAccumulator.hs:19-26) lifted through eight mtl
transformers, plus runners `runAccumulatorT`/`evalAccumulatorT` (:68-77) and
`readerToAccumulator` (:80-82), which embeds a read-only computation. The
KeysHints compile-time context is its only in-tree consumer (KeysHints.hs:42
stacks two accumulators under a Reader).

Python has no monad-transformer stack to lift through; the reification is an
explicit `Accumulator` object with the same three-operation surface plus the
runners. `DictAccumulator` is the monoid used by keys/hints (union of typed
key→value maps; the reference's `[Dynamic]` store with typed lookup,
KeysHints.hs:36-39): appends are first-write-wins-checked so the append-only
law `w <> w' ⊒ w` is enforced, not just conventional. interp/keys_hints.py
builds its Keys and Hints stores on this class.

A copy of `alchemy_tpu/interp/accumulator.py`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Iterator


class Accumulator:
    """Append-only state cell over a user-supplied monoid.

    merge(old, delta) must return old ⊕ delta without mutating either
    (mappend); `empty` is the monoid identity (mempty)."""

    def __init__(self, empty: Any, merge: Callable[[Any, Any], Any]):
        self._value = empty
        self._merge = merge

    @property
    def value(self) -> Any:
        return self._value

    def append(self, delta: Any) -> None:
        """append w (MonadAccumulator.hs:21-22)."""
        self._value = self._merge(self._value, delta)

    def accumulate(self, f: Callable[[Any], tuple[Any, Any]]):
        """accumulate f: f sees the current state and returns (result,
        state-to-append) (MonadAccumulator.hs:24-26)."""
        result, delta = f(self._value)
        self._value = self._merge(self._value, delta)
        return result

    def reader(self, f: Callable[[Any], Any]):
        """readerToAccumulator (MonadAccumulator.hs:80-82): run a read-only
        computation against the accumulated state (appends nothing — in
        particular the user merge is NOT called, so plain monoid merges like
        `lambda a, b: a + b` need no None special case)."""
        return f(self._value)


def run_accumulator(action: Callable[[Accumulator], Any], empty: Any,
                    merge: Callable[[Any, Any], Any]):
    """runAccumulatorT (MonadAccumulator.hs:68-71): run `action` with a
    fresh accumulator, return (result, accumulated state)."""
    acc = Accumulator(empty, merge)
    result = action(acc)
    return result, acc.value


def eval_accumulator(action: Callable[[Accumulator], Any], empty: Any,
                     merge: Callable[[Any, Any], Any]):
    """evalAccumulatorT (MonadAccumulator.hs:73-77)."""
    return run_accumulator(action, empty, merge)[0]


class DictAccumulator(Accumulator, Mapping):
    """Accumulator over the union-of-typed-maps monoid — the reification of
    the reference's `Keys`/`Hints` wrappers of `[Dynamic]` with typed lookup
    (KeysHints.hs:36-39, :55-69). Mapping reads give the typed-lookup
    surface; writes must go through append (first write per key wins;
    conflicting re-appends raise, enforcing append-only)."""

    def __init__(self):
        super().__init__({}, self._union)

    @staticmethod
    def _union(old: dict, delta) -> dict:
        if delta is None:
            return old
        out = dict(old)
        for k, v in delta.items():
            if k in out and out[k] is not v:
                raise ValueError(f"append-only store: key {k!r} rebound")
            out[k] = v
        return out

    # -- Mapping (typed lookup) surface ------------------------------------

    def __getitem__(self, k):
        return self._value[k]

    def __iter__(self) -> Iterator:
        return iter(self._value)

    def __len__(self) -> int:
        return len(self._value)

    # dict-style sugar used by the KeysHints call sites

    def __setitem__(self, k, v) -> None:
        self.append({k: v})

    def get(self, k, default=None):
        return self._value.get(k, default)
