"""The sharded patch-DB argmin over the ``db`` axis (counterpart of the JAX
package's ``parallel/sharded_match.py``).

The A/A' feature DB is sharded row-wise across the ranks of a group; each
rank finds its shard's best row with the same hand-written kernel as the
single card (``ops/match.py``), and the global winner is resolved by one
``all_gather`` of the per-shard (score, global index) pairs — one pair a
query — and the first minimum (maximum for the packed scan) over shards.
``torch.argmin``/``argmax`` return the first occurrence, and each shard's
kernel its lowest in-shard index on ties, so ties go to the lowest GLOBAL
index: the single card's order.  The pairs compare by the kernels' own
scores, which are each row's single-card score, so the picks are the
single card's bit for bit; the distance returned beside them is
``max(score + ||q||^2, 0)``, as the JAX functions return it.

Every function takes the group it reduces over; ``group=None`` is the
single-card call (a world of one needs no collective).  Indices are in
the PADDED global row space of ``sharded_pad_geometry``; real rows come
first.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from image_analogies_tpu_torch.backends.cuda import packed2k_scan
from image_analogies_tpu_torch.ops.match import (
    _pad_lanes,
    _round_up,
    argmin_l2,
    argmin_l2_bf16,
)
from image_analogies_tpu_torch.parallel.mesh import (
    STAGED,
    _on_host,
    all_gather_stack,
    all_reduce_sum,
)
from image_analogies_tpu_torch.tune.geometry import (
    DEFAULT_CHUNKS_PER_SM,
    DEFAULT_RING_STAGES,
)

PRECISIONS = ("highest", "default")


def _group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def shard_scores(queries: torch.Tensor, db_shard: torch.Tensor,
                 dbn_shard: torch.Tensor, precision: str,
                 chunks_per_sm: int = DEFAULT_CHUNKS_PER_SM
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's (local idx (M,) int64, score (M,) fp32) for raw (M, F)
    queries: "highest" is the fp32 kernel ``argmin_l2`` over an fp32
    ``db_shard`` (R, Fp); "default" the bf16 kernel ``argmin_l2_bf16``
    over a bf16 ``db_shard`` (the lanes past F zero), the JAX package's
    DEFAULT precision.  ``dbn_shard`` (R,) holds the fp32 row norms, +inf
    on padding rows."""
    if precision == "highest":
        idx, score = argmin_l2(queries, db_shard, dbn_shard,
                               chunks_per_sm=chunks_per_sm)
    elif precision == "default":
        idx, score = argmin_l2_bf16(
            _pad_lanes(queries, db_shard.shape[1]), db_shard, dbn_shard,
            _round_up(queries.shape[1], 16))
    else:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    return idx.long(), score


def _reduce_best(score: torch.Tensor, gidx: torch.Tensor, group,
                 largest: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first best (score, global index) over the group's shards: one
    all_gather of the (2, M) pairs as float64 (exact for fp32 scores and
    indices below 2^53)."""
    if group is None:
        return gidx, score
    both = all_gather_stack(torch.stack([score.double(), gidx.double()]),
                            group)  # (D, 2, M)
    pick = (torch.argmax if largest else torch.argmin)(both[:, 0], dim=0)
    best = both.gather(0, pick.view(1, 1, -1).expand(1, 2, -1))[0]
    return best[1].long(), best[0].float()


def local_argmin_allreduce(queries: torch.Tensor, db_shard: torch.Tensor,
                           dbn_shard: torch.Tensor, group, *,
                           precision: str = "highest",
                           chunks_per_sm: int = DEFAULT_CHUNKS_PER_SM
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard argmin kernel, then the min+argmin all-reduce over
    ``group`` (the JAX ``local_argmin_allreduce`` over a
    ``shard_level_db`` layout: ``db_shard`` lane-padded, +inf norms on
    padding rows).  Returns (global idx (M,) int32, d (M,) fp32)."""
    idx, score = shard_scores(queries, db_shard, dbn_shard, precision,
                              chunks_per_sm)
    gidx, score = _reduce_best(
        score, idx + _group_rank(group) * db_shard.shape[0], group,
        largest=False)
    qn = (queries * queries).sum(dim=1)
    return gidx.to(torch.int32), torch.clamp(score + qn, min=0.0)


def packed_champion_allreduce(q1: torch.Tensor, q2: torch.Tensor,
                              wk_shard: torch.Tensor, group, *,
                              chunks_per_sm: int = DEFAULT_CHUNKS_PER_SM,
                              ring_stages: int = DEFAULT_RING_STAGES
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded twin of the single card's exact_hi2_2p anchor scan: the
    packed2k kernel (``packed_best``, routed past 512 lanes by
    ``_packed2k_route``) over this rank's K-wide weight shard, then a
    max+argmax all-reduce over ``group``.  ``q1``/``q2`` (M, L) bf16 are
    the bit-mask split of the centered live query dims.  Scan scores are
    globally comparable: the centering shift reduces over every shard
    (``backends/cuda.py build_sharded_db``), so equal rows pack into
    equal lanes and the first maximum over shards is the lowest global
    index.  Returns (global idx (M,) int32, scan value (M,) fp32); callers
    re-score the pick in exact fp32 through their sharded row gather."""
    idx, val = packed2k_scan(q1, q2, wk_shard, chunks_per_sm=chunks_per_sm,
                             ring_stages=ring_stages)
    gidx, val = _reduce_best(
        val, idx.long() + _group_rank(group) * wk_shard.shape[0], group,
        largest=True)
    return gidx.to(torch.int32), val


def _owned_rows(table: torch.Tensor, idx: torch.Tensor, offset: int):
    """Rows ``idx`` (global) of this rank's shard ``table`` (R, C) at
    global row ``offset``: the rows it owns, and -0.0 elsewhere (the one
    value that leaves every x as it is in a sum, signed zeros
    included)."""
    rows = table.shape[0]
    loc = idx - offset
    inb = (loc >= 0) & (loc < rows)
    vals = table[loc.clamp(0, rows - 1)]
    return torch.where(inb.view(inb.shape + (1,) * (vals.dim() - inb.dim())),
                       vals, torch.full_like(vals, -0.0))


def psum_gather(table: torch.Tensor, idx: torch.Tensor, offset: int,
                group) -> torch.Tensor:
    """Rows ``idx`` (global) of a DB sharded over ``group``, this rank's
    shard being ``table`` at global row ``offset``: each rank contributes
    the rows it owns (-0.0 elsewhere) and one all_reduce(SUM) combines
    them, so every rank gets the rows' exact bits and none holds the
    whole DB (the JAX package's psum-gather)."""
    vals = _owned_rows(table, idx, offset)
    return vals if group is None else all_reduce_sum(vals, group)


def pick_and_gather(table: torch.Tensor, cand: torch.Tensor,
                    p_local: torch.Tensor, score: torch.Tensor,
                    offset: int, group):
    """A mesh wavefront step's ONE collective: the psum-gather of the
    (M, nc) candidate rows and, in one slot per rank, this rank's anchor
    winner (global index ``p_local``, its shard's ``score``, lower is
    better) with its row, which this rank owns.  The first minimum score
    over the slots wins (ties: the lowest shard, so the lowest global
    index), then its row joins the candidates'.  Scores and indices ride
    the fp32 sum exactly (indices below 2^24: the wavefront caps A rows
    there).  Returns (rows (M, nc+1, C), the winner's global index (M,)
    int64): what ``_batched_coherence`` gathers on one card, bit for
    bit."""
    m, nc = cand.shape
    c = table.shape[1]
    vals = _owned_rows(table, cand, offset)
    slot = torch.cat([table[p_local - offset], score[:, None],
                      p_local.to(score.dtype)[:, None]], dim=1)  # (M, C+2)
    if group is not None:
        d = dist.get_world_size(group)
        slots = torch.full((d, m, c + 2), -0.0, dtype=slot.dtype,
                           device=slot.device)
        slots[_group_rank(group)] = slot
        buf = all_reduce_sum(torch.cat([vals.reshape(-1),
                                        slots.reshape(-1)]), group)
        vals = buf[:m * nc * c].view(m, nc, c)
        slots = buf[m * nc * c:].view(d, m, c + 2)
        k = torch.argmin(slots[:, :, c], dim=0)
        slot = slots.gather(0, k.view(1, m, 1).expand(1, m, c + 2))[0]
    return (torch.cat([vals, slot[:, None, :c]], dim=1),
            slot[:, c + 1].long())


def sharded_pad_geometry(n: int, f: int, shards: int, tile: int = 1):
    """(npad, fp) of a sharded level DB: per-shard rows a multiple of
    ``tile`` capped at the 128-aligned per-shard need, features padded to
    the 128-lane boundary (the JAX function, as it is)."""
    fp = max(_round_up(f, 128), 128)
    per_shard = -(-n // shards)
    tile = min(max(tile, 1), max(_round_up(per_shard, 128), 128))
    return shards * _round_up(per_shard, tile), fp


def shard_level_db(score_db: torch.Tensor, score_dbn: torch.Tensor,
                   a_filt_flat: torch.Tensor, group, tile: int = 1):
    """This rank's slice of a level's scoring DB in the sharded layout
    (the JAX ``shard_level_db`` for a DB that already exists whole, the
    standalone entry; the level build never makes the whole DB,
    ``backends/cuda.py build_sharded_db``): rows a multiple of ``tile``,
    features lane-padded, padding rows with +inf norms.  Returns (dbp
    (R, Fp), dbnp (R,), afiltp (R,))."""
    shards = 1 if group is None else dist.get_world_size(group)
    n, f = score_db.shape
    npad, fp = sharded_pad_geometry(n, f, shards, tile)
    r = npad // shards
    lo = _group_rank(group) * r
    hi = min(lo + r, n)
    dev = score_db.device
    dbp = torch.zeros((r, fp), dtype=score_db.dtype, device=dev)
    dbnp = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    afp = torch.zeros((r,), dtype=torch.float32, device=dev)
    if hi > lo:
        dbp[:hi - lo, :f] = score_db[lo:hi]
        dbnp[:hi - lo] = score_dbn[lo:hi]
        afp[:hi - lo] = a_filt_flat[lo:hi]
    return dbp, dbnp, afp


def make_sharded_argmin(group, precision: str = "highest") -> Callable:
    """argmin_fn(queries (M, F), db_shard, dbn_shard) -> (idx, d): the
    standalone sharded nearest-row search over a ``shard_level_db``
    layout, the queries replicated on every rank of ``group``."""

    def fn(queries, db_shard, dbn_shard):
        return local_argmin_allreduce(queries, db_shard, dbn_shard, group,
                                      precision=precision)

    return fn


def make_ring_argmin(group, precision: str = "highest") -> Callable:
    """Ring-parallel sharded search: BOTH queries and DB shard over
    ``group`` (the JAX ``make_ring_argmin``).

    Each rank starts with its own query tile; over D hops the tiles rotate
    one rank around the ring (``dist.batch_isend_irecv``), each scored
    against the RESIDENT shard, carrying the running lexicographic (score,
    global index) minimum with them, so ties go to the lowest global
    index: the all-reduce's picks.  After D hops every tile has visited
    every shard and is back home.  One message a hop: the tile and its
    carry as one float64 tensor.

    Returns argmin_fn(q_tile (M/D, F), db_shard, dbn_shard) -> (idx int32,
    d) for this rank's own tile."""

    def fn(q_tile, db_shard, dbn_shard):
        d = 1 if group is None else dist.get_world_size(group)
        me = _group_rank(group)
        rows = db_shard.shape[0]
        m, f = q_tile.shape
        qn = (q_tile * q_tile).sum(dim=1)
        q = q_tile
        best_s = torch.full((m,), float("inf"), dtype=torch.float32,
                            device=q_tile.device)
        best_i = torch.full((m,), torch.iinfo(torch.int64).max,
                            dtype=torch.int64, device=q_tile.device)
        for k in range(d):
            # after k hops this rank holds the tile of rank (me - k)
            idx, score = shard_scores(q, db_shard, dbn_shard, precision)
            gidx = idx + me * rows
            better = (score < best_s) | ((score == best_s) & (gidx < best_i))
            best_s = torch.where(better, score, best_s)
            best_i = torch.where(better, gidx, best_i)
            if d == 1:
                break
            msg = torch.cat([q.double(), best_s.double()[:, None],
                             best_i.double()[:, None]], dim=1)
            msg = _ring_hop(msg, group, me, d)
            q = msg[:, :f].float()
            best_s = msg[:, f].float()
            best_i = msg[:, f + 1].long()
        return best_i.to(torch.int32), torch.clamp(best_s + qn, min=0.0)

    return fn


def _ring_hop(msg: torch.Tensor, group, me: int, d: int) -> torch.Tensor:
    """Send ``msg`` to the next rank of the ring, receive the previous
    rank's (through the host on a gloo group, as ``mesh.py``'s
    collectives)."""
    staged = _on_host(msg, group)
    src = msg.cpu() if staged else msg.contiguous()
    buf = torch.empty_like(src)
    nxt = dist.get_global_rank(group, (me + 1) % d)
    prv = dist.get_global_rank(group, (me - 1) % d)
    ops = [dist.P2POp(dist.isend, src, nxt, group),
           dist.P2POp(dist.irecv, buf, prv, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        STAGED["bytes"] += 2 * src.numel() * src.element_size()
        return buf.to(msg.device)
    return buf
