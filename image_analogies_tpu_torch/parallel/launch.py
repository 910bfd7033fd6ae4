"""Starting a local world of ranks in one call (``spawn_local``), for tests
and scripts on one host; users start a world with ``torchrun`` or the
CLI's ``--coordinator/--num-processes/--process-id`` instead.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from image_analogies_tpu_torch.parallel import distributed
from image_analogies_tpu_torch.parallel.mesh import reset_mesh_cache


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, nprocs: int, port: int,
               backend: Optional[str], device, args, results) -> None:
    if torch.device(device or "cuda").type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    distributed.initialize_distributed(
        f"127.0.0.1:{port}", nprocs, rank, backend=backend, device=device)
    try:
        out = fn(rank, *args)
        dist.barrier()
    finally:
        reset_mesh_cache()
        dist.destroy_process_group()
    results.put((rank, out))


def spawn_local(fn: Callable, nprocs: int, *, backend: Optional[str] = None,
                device=None, args: tuple = ()) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes joined into
    one world (``torch.multiprocessing.spawn``; a free localhost port as
    the coordinator; ``initialize_distributed`` with ``backend`` and
    ``device``, whose rule applies: ``device="cpu"`` for gloo worlds on
    the CPU, or one named card and ``backend="gloo"`` for ranks that share
    it; CPU ranks split the host's cores between them).  ``fn`` must be importable (a module-level function) and its
    return value picklable.  Returns every rank's return value, in rank
    order; a rank that raises makes this raise, and every process has
    ended when it returns."""
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank_main, args=(fn, nprocs, _free_port(), backend, device, args,
                          results), nprocs=nprocs, join=False,
        start_method="spawn")
    out = {}
    done = False
    while not done:
        # drain while waiting: a rank blocks in put() until its result
        # (larger than a pipe's buffer) is read
        done = ctx.join(timeout=0.05)
        while not results.empty():
            rank, value = results.get()
            out[rank] = value
    return [out[r] for r in range(nprocs)]
