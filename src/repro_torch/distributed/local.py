"""Run a function in ``world`` local processes that form one process group
— the multi-process tests on the CPU (gloo), and several ranks sharing one
card.  Every process gets ``fn(rank, world, *args)``; the results come back
to the caller in rank order, and a failed or hung rank fails the call
instead of hanging it."""

from __future__ import annotations

import multiprocessing
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Sequence


def free_port() -> int:
    """A TCP port on ``localhost`` that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(fn, rank, world, port, backend, threads, timeout, args,
            results) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local(fn: Callable[..., Any], world: int, args: Sequence[Any] = (),
              backend: str = "gloo", timeout: float = 120.0,
              threads: int = 1) -> List[Any]:
    """``[fn(rank, world, *args) for rank in range(world)]``, each call in a
    spawned process of a ``backend`` process group on ``localhost`` (a
    free port).  ``fn`` must be importable by name and its results
    picklable.  Raises ``RuntimeError`` with a rank's traceback if one
    fails, ``TimeoutError`` if they are not all done within ``timeout``
    seconds (a collective waits at most that long too); the processes are
    ended either way."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(fn, rank, world, port, backend, threads,
                               timeout, tuple(args), results))
             for rank in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(got)} of {world} ranks not "
                                   f"done after {timeout:.0f}s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]

