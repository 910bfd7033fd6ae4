"""Starting a multi-process run (counterpart of the JAX package's
``parallel/distributed.py``).

One process per rank.  ``initialize_distributed`` joins this process to
the world before any device work:

    # torchrun sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK
    torchrun --nproc-per-node 2 -m image_analogies_tpu_torch.cli run \\
        --db-shards 2 ...
    # or by hand, one command a rank
    python -m image_analogies_tpu_torch.cli run ... \\
        --coordinator h0:1234 --num-processes 2 --process-id 0

Devices and backends, with no fallback: each rank runs on
``cuda:LOCAL_RANK`` unless the caller names a device, and the backend
follows the device (``nccl`` for CUDA, ``gloo`` for the CPU) unless the
caller names one.  Two ranks share a card only when the caller names both
the device and ``gloo``; otherwise a rank without a card of its own
raises.  An NCCL error raises; nothing switches to gloo.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

# this process's rank device and backend, once initialize_distributed ran
_STATE: Dict[str, object] = {"device": None, "backend": None}


def _rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: the caller's, or ``cuda:LOCAL_RANK``."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local_rank)
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a rank runs on the card by default and CUDA is not available "
            "here; pass device='cpu' (and the gloo backend follows)")
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise ValueError(
            f"local rank {local_rank} has no card of its own: this host has "
            f"{n}; two ranks share a card only when the caller names the "
            "device and backend='gloo'")
    return torch.device("cuda", local_rank)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join this process to a multi-process run when one is configured;
    no-op otherwise.  Returns True if it initialised the process group.

    Order of precedence: explicit arguments > torchrun's environment
    (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) > nothing
    (a single-process run, or a process group that already exists).  A
    partial configuration raises ``ValueError``: the other ranks would
    wait for this one forever.  ``init_method`` is
    ``tcp://<coordinator>``; the device and backend follow the module
    docstring's rule, and a CUDA rank's device becomes the current one."""
    if dist.is_initialized():
        return False
    env = os.environ
    if (coordinator_address is None and "MASTER_ADDR" in env
            and "MASTER_PORT" in env):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        if process_id is not None:
            raise ValueError(
                "process_id given without coordinator_address/num_processes "
                "— a partially-configured multi-process run would silently "
                "start standalone and hang the other ranks")
        return False  # single-process: nothing to do
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "a multi-process run needs coordinator_address, num_processes "
            f"and process_id together; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r} — the other ranks would "
            "hang waiting for this one")
    local_rank = int(env.get("LOCAL_RANK", process_id))
    dev = _rank_device(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _STATE.update(device=dev, backend=backend)
    return True


def rank_device() -> Optional[torch.device]:
    """The device ``initialize_distributed`` gave this rank (None when it
    did not run)."""
    return _STATE["device"]


def is_writer() -> bool:
    """True on the one process that writes a run's files: rank 0, or the
    only process of a run that is not distributed."""
    return not dist.is_initialized() or dist.get_rank() == 0
