"""The (data, db) process mesh and its collectives (counterpart of the JAX
package's ``parallel/mesh.py``).

The framework's two parallel axes:

- ``db``: the A/A' patch database sharded across ranks (exemplar size
  scales with the number of cards);
- ``data``: video frames, or the queries of one image's anti-diagonals,
  sharded across ranks.

A torch rank is a process, not a device, so the mesh is laid over the
world's processes: rank r sits at (data = r // db_shards, db = r %
db_shards), the JAX package's ``reshape(data_shards, db_shards)`` order,
and each axis has one process group per row or column of the mesh.  The
world must hold exactly ``data_shards * db_shards`` ranks: the JAX
``make_mesh`` leaves surplus devices unused, but a surplus process would
run the whole synthesis beside the mesh.  ``shard_map`` has no
counterpart: every function of ``sharded_match.py`` and ``step.py`` runs
on each rank and takes the group it reduces over.

The collectives here are the only ones the mesh path issues.  A gloo
group takes CPU tensors, so a CUDA tensor on a gloo group (two ranks
sharing one card) is copied to the host and back; ``STAGED`` tallies
those bytes.  Nothing falls back: a collective that fails raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from image_analogies_tpu_torch.parallel import distributed

# bytes copied between the card and the host for collectives on gloo
# groups since the last reset (both directions)
STAGED = {"bytes": 0}


def reset_staged() -> None:
    STAGED["bytes"] = 0


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the (data, db) mesh: ``shape`` {"data": d,
    "db": b}, the process group of each axis that holds this rank (None
    for an axis of size 1: nothing to reduce), this rank's index along
    each axis, and its device."""

    shape: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    ranks: Dict[str, int]
    device: Optional[torch.device]

    def rank_in(self, axis: str) -> int:
        return self.ranks[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]


def make_mesh(db_shards: int = 1, data_shards: int = 1) -> Mesh:
    """The (data, db) mesh over the world's processes, cached per shape:
    every level build of a run shares one Mesh and its groups.  A 1 x 1
    mesh needs no process group; any other needs a world of exactly
    ``db_shards * data_shards`` ranks (``initialize_distributed`` or
    ``launch.spawn_local`` first)."""
    return _mesh(int(db_shards), int(data_shards))


@functools.lru_cache(maxsize=16)
def _mesh(db_shards: int, data_shards: int) -> Mesh:
    need = db_shards * data_shards
    world = dist.get_world_size() if dist.is_initialized() else 1
    if need != world and (need > 1 or dist.is_initialized()):
        raise ValueError(
            f"mesh needs {need} processes (data={data_shards} x "
            f"db={db_shards}) but {world} are running: a torch rank is a "
            "process, so the world must be exactly data x db (start it "
            "with torchrun --nproc-per-node "
            f"{need}, or parallel.launch.spawn_local)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    me_data, me_db = divmod(rank, db_shards)
    groups: Dict[str, Optional[dist.ProcessGroup]] = {"data": None,
                                                      "db": None}
    # every rank creates every group, in the same order (new_group's rule)
    for axis, rows in (
            ("db", [[d * db_shards + j for j in range(db_shards)]
                    for d in range(data_shards)]),
            ("data", [[d * db_shards + j for d in range(data_shards)]
                      for j in range(db_shards)])):
        if len(rows[0]) == 1:
            continue
        for ranks in rows:
            g = (dist.group.WORLD if len(ranks) == world
                 else dist.new_group(ranks))
            if rank in ranks:
                groups[axis] = g
    return Mesh(shape={"data": data_shards, "db": db_shards}, groups=groups,
                ranks={"data": me_data, "db": me_db},
                device=distributed.rank_device())


def reset_mesh_cache() -> None:
    """Forget the cached meshes (their groups die with the process
    group)."""
    _mesh.cache_clear()


def pad_to_shards(n: int, shards: int) -> int:
    """Rows the DB must be padded to so every shard gets an equal slice."""
    return (n + shards - 1) // shards * shards


# ----------------------------------------------------------- collectives


def _on_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """(D, *t.shape): every rank's ``t`` in the group's rank order."""
    d = dist.get_world_size(group)
    staged = _on_host(t, group)
    src = t.cpu() if staged else t.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((d,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        parts = [torch.empty_like(src) for _ in range(d)]
        dist.all_gather(parts, src, group=group)
        out = torch.stack(parts)
    if staged:
        STAGED["bytes"] += src.numel() * src.element_size() * (1 + d)
        out = out.to(t.device)
    return out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of every rank's ``t`` over the group (``t`` is
    overwritten on the card or the CPU alike; the sum is returned)."""
    if _on_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        STAGED["bytes"] += 2 * host.numel() * host.element_size()
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t
