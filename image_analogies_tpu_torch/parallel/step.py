"""The mesh level step: frames x sharded patch DB (counterpart of the JAX
package's ``parallel/step.py``).

``multichip_level_step`` runs the REAL level scans of
``backends/cuda.py`` (``wavefront_scan_core`` / ``batched_scan_core``) on
every rank of the (data, db) mesh:

- frames shard over ``data``: each data rank takes its T / D frames, one
  after another (each frame's scan is the single card's, op for op; the
  JAX package's ``vmap`` over a rank's frames has no bit-safe counterpart
  with per-frame hooks), and one all_gather over ``data`` returns every
  frame to every rank; one frame on a data axis > 1 is the QUERY-PARALLEL
  wavefront instead (each data rank scores its slice of every
  anti-diagonal);
- the A/A' patch DB shards row-wise over ``db``: the anchor runs this
  rank's shard through the single card's kernel (the fp32 argmin, or the
  packed2k scan where ``packed_scan_eligible`` allows it; batched's
  approximate match the bf16 kernel at DEFAULT precision on the card)
  and the global winner is the first best over the shards, the lowest
  global index on ties (``sharded_match.py``);
- every DB row and A' value the scan reads comes through a psum-gather
  (``sharded_match.psum_gather``): each rank gathers the rows it owns, the
  others add -0.0, and one all_reduce(SUM) over ``db`` combines them, so
  no rank holds the whole DB and the values are the single card's bits.
  On the wavefront the anchor scans this rank's shard only and defers
  its winner to the step's coherence gather, which carries every rank's
  (score, index, row) of its winner in one slot a rank beside the
  candidates' rows (``sharded_match.pick_and_gather``): ONE collective a
  step (a data axis adds its all_gather), the packed levels moving the
  L+2 [live | dead norm | A'] columns, the others full rows and their A'
  value.  Batched issues its approximate match's all_gather and a
  psum-gather for coherence, each refinement pass and the A' values.

Every rank of a ``db`` group runs the whole scan loop on the full query
set against its own shard, so every rank ends with the same bits.  The
chaos site ``mesh.step`` opens each step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from image_analogies_tpu_torch import chaos
from image_analogies_tpu_torch.backends.cuda import (
    LevelDB,
    batched_scan_core,
    exact_scan_fn,
    level_tune,
    wavefront_scan_core,
)
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.parallel.mesh import Mesh, all_gather_stack
from image_analogies_tpu_torch.parallel.sharded_match import (
    local_argmin_allreduce,
    pick_and_gather,
    psum_gather,
)


def _frame_scan(mesh: Mesh, dbt: LevelDB, kappa_mult: float, db_shard,
                dbn_shard, afilt_shard, scan_shard, wk_shard, table,
                live_rows: bool, precision: str, query_parallel: bool):
    """One frame's level scan on this rank: (bp (Nb,), s (Nb,), counts
    (2,) = [coherence picks, refinement switches (batched; else 0)]).
    ``table`` is the wavefront's gathered shard: the live rows
    (``live_rows``) or [full row | A'] rows."""
    group = mesh.group("db")
    offset = mesh.rank_in("db") * db_shard.shape[0]
    f = int(dbt.static_q.shape[1])
    cfg = level_tune(dbt)
    if dbt.strategy == "batched":
        approx_fn = lambda q: local_argmin_allreduce(
            q, scan_shard, dbn_shard, group, precision=precision,
            chunks_per_sm=cfg.chunks_per_sm)
        rows_f = db_shard[:, :f]
        return batched_scan_core(
            dbt, kappa_mult, approx_fn,
            row_fn=lambda i: psum_gather(rows_f, i, offset, group),
            afilt_fn=lambda i: psum_gather(afilt_shard, i, offset, group))

    # the anchor scans this rank's shard only (the single card's kernel
    # pass); its winner is resolved over the shards inside the step's one
    # collective (pick_and_gather)
    score = {}
    scan = (exact_scan_fn(dbt, True, wk_shard) if wk_shard is not None
            else exact_scan_fn(dbt, False, db_shard, dbn_shard))

    def anchor_fn(queries):
        idx, score["s"] = scan(queries)
        return idx + offset, None

    gather = lambda cand, p: pick_and_gather(table, cand, p, score.pop("s"),
                                             offset, group)
    bp, s, n_coh = wavefront_scan_core(
        dbt, kappa_mult, anchor_fn, row_fn=None if live_rows else gather,
        live_gather=gather if live_rows else None,
        data_group=mesh.group("data") if query_parallel else None,
        data_size=mesh.shape["data"] if query_parallel else 1)
    return bp, s, torch.stack([n_coh, torch.zeros_like(n_coh)])


def multichip_level_step(
    mesh: Mesh,
    frame_static_q: torch.Tensor,  # (T, Nb, F) every frame's query side
    db_shard: torch.Tensor,  # (R, Fp) this rank's scoring-DB shard
    dbn_shard: torch.Tensor,  # (R,) its norms, +inf on padding rows
    afilt_shard: torch.Tensor,  # (R,) its A' values
    template: LevelDB,  # the slim level (make_level_template)
    kappa_mult: float,
    wk_shard: Optional[torch.Tensor] = None,  # (R, Kp) packed2k weights
    dbl_shard: Optional[torch.Tensor] = None,  # (R, L+2) live rows
    bf16_approx: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level of T frames on the (data, db) mesh.  Returns (bp (T, Nb)
    fp32, s (T, Nb) int32, counts (T, 2) int64: coherence picks and, on
    the batched strategy, refinement switches), the same on every rank.

    The shards come from ``backends.cuda.build_sharded_db`` and the
    template from ``backends.cuda.make_level_template`` (its ``feat_mean``
    the global shift when packed).  ``wk_shard`` (the wavefront) scans
    with packed2k, else the fp32 argmin runs; with ``dbl_shard`` the
    packed level's gathers move the L+2 live columns, else full rows.
    Batched's approximate match is the bf16 kernel where ``bf16_approx``
    (None: on the card; the CPU runs exact fp32, as the JAX package off a
    TPU).  T must divide by the data axis, unless one wavefront frame
    runs query-parallel.  Counts ``mesh.level_steps`` and
    ``mesh.psum_gather_bytes`` (the JAX package's host-side estimate of
    the gathers' payload) in a metrics run."""
    chaos.site("mesh.step", frames=int(frame_static_q.shape[0]))
    t_total = int(frame_static_q.shape[0])
    data = mesh.shape["data"]
    strategy = template.strategy
    query_parallel = t_total == 1 and data > 1 and strategy == "wavefront"
    if t_total % data and not query_parallel:
        raise ValueError(f"{t_total} frames not divisible by data={data}")
    if strategy not in ("wavefront", "batched"):
        raise ValueError(f"strategy {strategy!r} has no mesh scan core")
    if bf16_approx is None:
        bf16_approx = db_shard.device.type == "cuda"
    precision = "default" if strategy == "batched" and bf16_approx \
        else "highest"
    packed = wk_shard is not None and strategy == "wavefront"
    fused_live = packed and dbl_shard is not None
    # batched's DEFAULT scan reads a bf16 copy of the shard, made once a
    # level (the JAX kernel rounds its fp32 operand in the same way)
    scan_shard = (db_shard.to(torch.bfloat16) if precision == "default"
                  else db_shard)
    f = int(frame_static_q.shape[2])
    table = None
    if strategy == "wavefront":  # the rows a step's gather moves
        table = (dbl_shard if fused_live else torch.cat(
            [db_shard[:, :f], afilt_shard[:, None]], dim=1))
    if obs_metrics._ACTIVE:
        nb = int(frame_static_q.shape[1])
        nf = int(template.off.shape[0])
        width = int(dbl_shard.shape[1]) if fused_live else f + 1
        obs_metrics.inc("mesh.level_steps")
        obs_metrics.inc("mesh.psum_gather_bytes",
                        t_total * nb * (nf + 1) * width * 4)
    if query_parallel:
        mine = [0]
    else:
        per = t_total // data
        mine = list(range(mesh.rank_in("data") * per,
                          (mesh.rank_in("data") + 1) * per))
    outs = []
    for t in mine:
        dbt = dataclasses.replace(template, static_q=frame_static_q[t])
        outs.append(_frame_scan(
            mesh, dbt, kappa_mult, db_shard, dbn_shard, afilt_shard,
            scan_shard, wk_shard if packed else None, table, fused_live,
            precision, query_parallel))
    bp = torch.stack([o[0] for o in outs])
    s = torch.stack([o[1] for o in outs])
    counts = torch.stack([o[2] for o in outs])
    if query_parallel or data == 1:
        return bp, s, counts
    # every frame to every rank: one all_gather of the planes and counts
    # as float64 (exact for the fp32 values, indices and counts)
    nb = bp.shape[1]
    both = all_gather_stack(torch.cat([bp.double(), s.double(),
                                       counts.double()], dim=1),
                            mesh.group("data")).reshape(t_total, -1)
    return (both[:, :nb].float(), both[:, nb:2 * nb].to(torch.int32),
            both[:, 2 * nb:].long())
