"""Multi-process initialization on torch.distributed — port of
`alchemy_tpu/parallel/multihost.py`.

The collective transport is torch.distributed's: NCCL between cards, gloo
where the caller asks for it (the counterpart of the JAX package's
`cpu_collectives="gloo"`, how the tests run the same programs across CPU
processes). Every rank is one process; the mesh helpers of
`parallel/mesh.py` lay the ranks of the initialised world out on the mesh,
so the same programs run unchanged across hosts.

`LocalWorld` starts the ranks of one world as processes on this host and
runs functions on all of them: how the tests run 8 gloo ranks on the CPU and
how `chip_smoke.py` runs two ranks on the card.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str = "nccl") -> int:
    """Join (or start) the default process group and return its world size
    (multihost.py:14). coordinator_address is "host:port" of rank 0 (or a
    full init method, "tcp://..." or "file://..."); without one a single
    process starts a world of one on a free localhost port. backend is
    "nccl" (the default: NCCL between cards; this rank then uses card
    process_id mod the host's card count) or "gloo" when the caller asks
    for it; an unknown or unavailable backend raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: want one of {BACKENDS}")
    if backend == "nccl" and not (torch.cuda.is_available() and dist.is_nccl_available()):
        raise RuntimeError("backend='nccl' needs a CUDA device and torch built with NCCL")
    if backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("backend='gloo' but torch was built without gloo")
    world, rank = num_processes or 1, process_id or 0
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError(f"already rank {dist.get_rank()} of {dist.get_world_size()}")
        return world
    if coordinator_address is None:
        if world > 1:
            raise ValueError("num_processes > 1 needs a coordinator_address")
        coordinator_address = f"localhost:{free_port()}"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank)
    return dist.get_world_size()


def local_batch_slice(global_batch: int) -> slice:
    """The batch rows this rank owns under pure data-parallel input feeding
    (multihost.py:36, contiguous slicing by rank)."""
    n = dist.get_world_size()
    i = dist.get_rank()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def _rank_main(address: str, n: int, rank: int, backend: str, tasks, results) -> None:
    """A rank's process: join the world, then run each (fn, args) from
    tasks until None, putting (rank, ok, result or traceback) on results.
    After a failure the rank leaves: the world's collectives are out of
    step."""
    try:
        init_multihost(address, n, rank, backend=backend)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    while (item := tasks.get()) is not None:
        fn, args = item
        try:
            results.put((rank, True, fn(*args)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
            break
    dist.destroy_process_group()


class LocalWorld:
    """n rank processes on this host in one world (started with the spawn
    method, each joining through `init_multihost` on a free localhost port).
    `run(fn, *args)` calls fn(*args) on every rank and returns the results
    in rank order; fn and args are pickled (fn a top-level function of an
    importable module). A rank that raises, dies or outlasts `timeout`
    seconds closes the world and `run` raises. Use as a context manager, or
    call `close`."""

    def __init__(self, n: int, backend: str = "nccl", timeout: float = 300.0):
        if backend not in BACKENDS:
            raise ValueError(f"backend={backend!r}: want one of {BACKENDS}")
        ctx = mp.get_context("spawn")
        self.n, self.backend, self.timeout = n, backend, timeout
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        address = f"localhost:{free_port()}"
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(address, n, r, backend, self._tasks[r], self._results))
                       for r in range(n)]
        for p in self._procs:
            p.start()
        self.run(dist.get_world_size)

    def run(self, fn, *args, timeout: float | None = None) -> list:
        for q in self._tasks:
            q.put((fn, args))
        out, left = [None] * self.n, set(range(self.n))
        deadline = time.monotonic() + (timeout or self.timeout)
        while left:
            try:
                rank, ok, val = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in left if not self._procs[r].is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close()
                    why = (f"rank {dead[0]} died (exit code {self._procs[dead[0]].exitcode})"
                           if dead else f"ranks {sorted(left)} outlasted {timeout or self.timeout} s")
                    raise RuntimeError(f"{getattr(fn, '__name__', fn)}: {why}") from None
                continue
            if not ok:
                self.close()
                raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed on rank {rank}:\n{val}")
            out[rank] = val
            left.discard(rank)
        return out

    def close(self) -> None:
        """Stop every rank: ask, then kill what is still alive after 10 s."""
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        deadline = time.monotonic() + 10
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
