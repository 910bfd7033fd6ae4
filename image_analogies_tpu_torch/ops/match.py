"""Matching kernels of the port — the counterpart of the JAX package's
``ops/pallas_match.py``, one entry per Pallas kernel:

- ``argmin_l2``: per query, the lexicographic (score, index) minimum over DB
  rows of ``dbn[n] - 2 q.db[n]`` in exact fp32 (replaces ``_argmin_kernel``
  at HIGHEST, the wavefront's form; CUDA source ``csrc/argmin_l2.cu``).
- ``argmin_l2_bf16``: the same minimum over one bf16 pass with fp32
  accumulation (replaces ``_argmin_kernel`` at DEFAULT precision, the
  batched and rowwise strategies' form; ``csrc/argmin_bf16.cu``).
- ``packed_best``: per query, the lexicographic (score, lowest index)
  maximum of one to three bf16 passes with fp32 accumulation against the
  lane-packed DB (replaces ``_packed_best_kernel`` in all six forms:
  ``packed_best`` itself is the main path's ``packed2k`` form,
  ``csrc/packed2k_best.cu`` up to 512 lanes and ``csrc/packed2kw_best.cu``
  past them (``_packed2k_route``); ``packed3_best`` (exact_hi2) is
  ``csrc/packed3_best.cu`` up to 256 lanes and ``csrc/packed3w_best.cu``
  past them (``_packed3_route``); ``packed2_best``, ``packed1w_best``,
  ``packed2wn_best`` and ``packed1wn_best`` are ``csrc/<form>.cu``).
- ``packed_champions``: the same packed passes, one champion per DB tile
  (replaces ``_packed_kernel``; ``csrc/tile_champions.cu``, and folded
  past 256 lanes ``csrc/packed3w_best.cu``: ``_champions_route``).
- ``pertile_champions``: per DB tile, the champion of ``q.db - dbnh`` over
  the bf16 centered DB (replaces ``_pertile_kernel``;
  ``csrc/pertile_champions.cu``).
- ``argmin2_l2``: the lexicographic top-2 of ``dbn - 2 q.db`` (replaces
  ``_argmin2_kernel``; ``csrc/argmin2.cu``).

Every bf16 scan runs on the Hopper core ``csrc/hopper_scan.cuh``
(``wgmma`` fed by a TMA ring), each with a launch plan over
``_hopper_plan``; packed3 and its per-tile champions past 256 lanes run
their own kernel beside it (query sets as register operands); the fp32
``argmin_l2`` has a kernel of its own (``csrc/argmin_l2.cu``).
Every kernel wrapper follows one contract: a CPU tensor runs the plain PyTorch
version in this module; a CUDA tensor launches the hand-written kernel or
raises — there is no fallback.
``LAUNCHES`` counts kernel launches, one key per kernel entry and packed
form (one per wrapper call that launched; the packed2k form past 512 lanes
counts as ``packed2kw_best``, the packed3 form past 256 lanes as
``packed3w_best``), so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from image_analogies_tpu_torch.ops import _build

# launches of each CUDA kernel entry since the last reset (plain-version
# calls on CPU tensors do not count)
LAUNCHES = {"argmin_l2": 0, "argmin_l2_bf16": 0, "packed_best": 0,
            "packed2kw_best": 0, "packed3_best": 0, "packed3w_best": 0,
            "packed2_best": 0, "packed1w_best": 0, "packed2wn_best": 0,
            "packed1wn_best": 0, "packed_champions": 0,
            "pertile_champions": 0, "argmin2_l2": 0}

# score given to padding rows by the norm-in-W scheme: far below any real
# score, finite (an inf lane would split to hi=-inf, lo=NaN)
_PAD_SCORE = -3.0e38


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bf16_split2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact hi/lo split of fp32 ``x``: ``hi`` is the TRUNCATED bf16 (the
    top 16 bits, by bit mask) and ``x - hi`` is exact.  Never
    ``.to(torch.bfloat16)`` here: that rounds to nearest and would change
    the packed scan's product set."""
    hi = (x.contiguous().view(torch.int32) & -65536).view(torch.float32)
    return hi, x - hi


def bf16_split3(x: torch.Tensor):
    """(d1, d2, r2): x = d1 + d2 + r2 with d1/d2 exactly bf16-representable
    fp32 (top-16-bit truncations) and |r2| <= 2^-16 |x|."""
    d1, r1 = bf16_split2(x)
    d2, r2 = bf16_split2(r1)
    return d1, d2, r2


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _snap_tile(tile_n: int, npad: int) -> int:
    """Largest divisor of ``npad`` that is <= ``tile_n`` (a copy of the JAX
    package's ``pallas_match._snap_tile``)."""
    tile_n = max(min(int(tile_n), npad), 1)
    if npad % tile_n == 0:
        return tile_n
    for t in range(tile_n, 0, -1):
        if npad % t == 0:
            return t
    return 1


def _lex_lt(va, ia, vb, ib):
    """Lexicographic (value, index) less-than — the one ordering every
    argmin path uses, so 'lowest index wins ties' holds everywhere."""
    return (va < vb) | ((va == vb) & (ia < ib))


def add_norm_lanes(wk: torch.Tensor, dbnh_row: torch.Tensor, l: int
                   ) -> torch.Tensor:
    """Write -||d||^2/2 into ``wk`` (in place, and return it) as three
    bf16-split lanes at [2l, 2l+3), multiplied by constant-1 query lanes in
    the scan.  Padding rows (+inf half norm) get finite ``_PAD_SCORE``
    lanes and lose every max."""
    npad, kp = wk.shape
    assert 2 * l + 3 <= kp, (l, kp)
    neg = torch.where(torch.isfinite(dbnh_row), -dbnh_row.float(),
                      torch.full_like(dbnh_row, _PAD_SCORE))
    n1, n2, n3 = bf16_split3(neg)
    wk[:, 2 * l:2 * l + 3] = torch.stack(
        [x.to(torch.bfloat16) for x in (n1, n2, n3)], dim=1)
    return wk


@functools.lru_cache(maxsize=8)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else \
        torch.cuda.current_device()


def _on_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def _check_cuda(name: str, **tensors) -> None:
    dev = None
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected the "
                             "card like the other operands")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: operands on different devices")
        dev = t.device


# ------------------------------------------------------------- argmin_l2


def argmin_l2_plain(q: torch.Tensor, dbp: torch.Tensor, dbn: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``argmin_l2``: fp32 ``dbn - 2 (q @ db.T)`` over the
    first ``q.shape[1]`` DB columns, then the first (lowest-index)
    minimum."""
    f = q.shape[1]
    scores = dbn[None, :] - 2.0 * (q @ dbp[:, :f].T)
    idx = torch.argmin(scores, dim=1)
    val = scores.gather(1, idx[:, None])[:, 0]
    return idx.to(torch.int32), val


# launch geometry of csrc/argmin_l2.cu: 8 warps a block, each warp nq
# queries (nq <= 16: 128 a block), 128-row DB tiles, k slabs of <= 18
# float4 columns in a ring of two stages, and the shared memory a block
# may use (one block per SM)
_ARGMIN_WARPS = 8
_ARGMIN_MAX_NQ = 16
_ARGMIN_ROWS = 128
_ARGMIN_SLAB4 = 18
_ARGMIN_SMEM = 232448 - 1024
_ARGMIN_KEY_STRIDE = 16  # int64s between two queries' merge keys


class ArgminPlan(NamedTuple):
    nq: int  # queries per warp: the kernel instance (8 nq queries a block)
    rows: int  # DB rows per tile
    tiles_per_chunk: int  # DB tiles per block
    n_chunks: int  # grid x: DB chunks
    q_chunks: int  # grid y: query chunks of 8 nq queries


def _argmin_smem(f: int, nq: int) -> int:
    """Dynamic shared memory of the nq instance at width F: the resident
    queries plus two stages, each one k slab (its float4 columns of a
    tile's rows and one pad) and the tile's norms (the kernel's
    ``smem_bytes``)."""
    kc = (f + 3) // 4
    n_slabs = -(-kc // _ARGMIN_SLAB4)
    slab4 = -(-kc // n_slabs)
    return (16 * kc * _ARGMIN_WARPS * nq
            + 2 * (16 * slab4 * (_ARGMIN_ROWS + 1) + 4 * _ARGMIN_ROWS))


def _argmin_plan(m: int, n: int, sm_count: int, f: int) -> ArgminPlan:
    """Launch plan of ``argmin_l2`` for M queries of width F against N DB
    rows on a card of ``sm_count`` SMs (F enters because the queries stay
    resident in shared memory).  The query groups of 8 are split into the
    fewest chunks the instance cap and the shared memory allow, evenly; the
    128-row DB tiles are cut into about one chunk per SM for each query
    chunk, never less than one tile a block."""
    if m < 1 or n < 1 or f < 1 or sm_count < 1:
        raise ValueError(f"argmin_l2 plan: m={m}, n={n}, f={f}, "
                         f"sm_count={sm_count}")
    nq_cap = _ARGMIN_MAX_NQ
    while nq_cap and _argmin_smem(f, nq_cap) > _ARGMIN_SMEM:
        nq_cap -= 1
    if not nq_cap:
        raise ValueError(f"argmin_l2: F={f} is too wide for the kernel's "
                         "shared memory")
    groups = -(-m // _ARGMIN_WARPS)
    q_chunks = -(-groups // nq_cap)
    nq = -(-groups // q_chunks)
    tiles = -(-n // _ARGMIN_ROWS)
    per = -(-tiles // max(1, sm_count // q_chunks))
    return ArgminPlan(nq, _ARGMIN_ROWS, per, -(-tiles // per), q_chunks)


# (device index, stream) -> (keys, ticket) of the one-launch merge
_ARGMIN_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] \
    = {}


def _argmin_workspace(device: torch.device, stream: int, m: int):
    """The merge workspace of ``stream``: (keys (>= 16 M,) int64 all-ones,
    query m's at 16 m, one 128-byte line each; ticket (1,) int32 zero),
    the state every launch leaves behind.  Allocated once per (device,
    stream), grown for a larger M."""
    key = (device.index, stream)
    ws = _ARGMIN_WORKSPACE.get(key)
    if ws is None or ws[0].numel() < m * _ARGMIN_KEY_STRIDE:
        keys = torch.full((max(m, 256) * _ARGMIN_KEY_STRIDE,), -1,
                          dtype=torch.int64, device=device)
        ticket = ws[1] if ws is not None else torch.zeros(
            (1,), dtype=torch.int32, device=device)
        ws = _ARGMIN_WORKSPACE[key] = (keys, ticket)
    return ws


def argmin_l2(q: torch.Tensor, dbp: torch.Tensor, dbn: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query m: (idx, score) = the lexicographic minimum over DB rows n
    of ``dbn[n] - 2 q[m].dbp[n]``, exact fp32, lowest index on ties.

    ``q`` (M, F) fp32; ``dbp`` (Npad, Fp >= F) fp32 (only the first F
    columns are read — the rest is lane padding; on the card Fp is a
    multiple of 4); ``dbn`` (Npad,) fp32 row norms, +inf on padding rows so
    they never win.  The caller adds ||q||^2.  Returns (idx (M,) int32,
    score (M,) fp32).  On the card: one kernel launch, and no allocation
    past the two outputs."""
    if q.dim() != 2 or dbp.dim() != 2 or dbn.dim() != 1:
        raise ValueError("argmin_l2: q (M,F), dbp (N,Fp), dbn (N,)")
    m, f = q.shape
    n, fp = dbp.shape
    if f > fp or dbn.shape[0] != n or m == 0 or n == 0:
        raise ValueError(f"argmin_l2: shapes q {tuple(q.shape)}, dbp "
                         f"{tuple(dbp.shape)}, dbn {tuple(dbn.shape)}")
    if not (q.dtype == dbp.dtype == dbn.dtype == torch.float32):
        raise ValueError("argmin_l2: operands must be float32")
    if _on_cpu(q, dbp, dbn):
        return argmin_l2_plain(q, dbp, dbn)
    _check_cuda("argmin_l2", q=q, dbp=dbp, dbn=dbn)
    if fp % 4:
        raise ValueError(f"argmin_l2: the card kernel copies DB rows in "
                         f"16-byte pieces; Fp={fp} must be a multiple of 4")
    dev = _device_index(q)
    plan = _argmin_plan(m, n, _sm_count(dev), f)
    lib = _build.load("argmin_l2")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    keys, ticket = _argmin_workspace(torch.device("cuda", dev), stream, m)
    out_idx = torch.empty((m,), dtype=torch.int32, device=q.device)
    out_val = torch.empty((m,), dtype=torch.float32, device=q.device)
    err = lib.ia_argmin_l2(
        q.data_ptr(), m, f, dbp.data_ptr(), n, fp, f, dbn.data_ptr(),
        plan.nq, plan.q_chunks, plan.n_chunks, plan.tiles_per_chunk,
        keys.data_ptr(), ticket.data_ptr(), out_idx.data_ptr(),
        out_val.data_ptr(), dev, stream)
    _build.check(lib, err, "argmin_l2 launch")
    LAUNCHES["argmin_l2"] += 1
    return out_idx, out_val


# ------------------------------------------------------------ packed_best

# (fold_a, two_streams, norm_in_w) -> the form's name and launch-count key
_PACKED_FORMS = {
    (False, False, True): "packed_best",  # packed2k: the main path's scan
    (True, True, False): "packed3_best",  # exact_hi2
    (False, True, False): "packed2_best",
    (True, False, False): "packed1w_best",
    (False, True, True): "packed2wn_best",
    (True, False, True): "packed1wn_best",
}


# launch geometry of the Hopper core csrc/hopper_scan.cuh, whose entries
# take the plan and only refuse one outside these limits: one to three
# consumer warpgroups of 64 query rows a block, each holding its query sets
# (one; two folded or with a second weight stream; three with both), DB
# tiles of 64 rows (argmin2, pertile and argmin_l2_bf16 up to k_used = 256:
# 128; two query sets and two streams past 448 lanes: 32; the kernel's
# ``tile_rows``, ``_core_rows``), rows cut into 32-lane boxes (64 bytes a
# row), a ring of at most 8 stages, each one DB tile of every weight stream
# (with the norms in the ring, 4 bytes a tile row), and the dynamic shared
# memory a block may take (one block per SM)
_P2K_ROWS = 64  # query rows of a warpgroup = DB rows of a packed2k tile
_P2K_CONSUMERS = (3, 2)  # the most first
_A2_CONSUMERS = (3, 2, 1)  # argmin2: one where folded queries are wide
_P3_CONSUMERS = (3, 2, 1)  # packed3: one at 256 lanes
_P3_MAX_LANES = 256  # packed3_best.cu's widest k_used (``_packed3_route``)
_P2K_BOX = 32
_P2K_MAX_STAGES = 8
_P2K_SMEM = 232448 - 1024


class Packed2kPlan(NamedTuple):
    consumers: int  # consumer warpgroups a block
    bm: int  # query rows a block (<= 64 consumers)
    stages: int  # ring depth
    tiles_per_chunk: int  # DB tiles per block
    n_chunks: int  # grid y: DB chunks
    q_tiles: int  # grid x: query tiles of bm rows
    smem: int  # dynamic shared memory of a block


def _hopper_smem(k_used: int, stages: int, consumers: int, qsets: int = 1,
                 norms: bool = False, rows: int = _P2K_ROWS,
                 streams: int = 1) -> int:
    """Dynamic shared memory of a block of the Hopper core (the kernel's
    ``smem_bytes``): 1 KiB of alignment slack, the consumer warpgroups'
    resident query rows (``qsets`` blocks each) and the ring of
    ``rows``-row DB tiles of ``streams`` weight arrays, ceil(k_used / 32)
    64-byte boxes a row, and with ``norms`` 4 bytes a tile row."""
    nbox = -(-k_used // _P2K_BOX)
    box_row = _P2K_BOX * 2
    return (1024 + consumers * qsets * nbox * _P2K_ROWS * box_row
            + stages * (streams * nbox * rows * box_row
                        + (4 * rows if norms else 0)))


def _hopper_stages(k_used: int, consumers: int, qsets: int = 1,
                   norms: bool = False, rows: int = _P2K_ROWS,
                   streams: int = 1) -> int:
    """The deepest ring (at most 8 stages) that fits beside the resident
    queries of ``consumers`` warpgroups; 0 if none does."""
    stages = _P2K_MAX_STAGES
    while stages and _hopper_smem(k_used, stages, consumers, qsets, norms,
                                  rows, streams) > _P2K_SMEM:
        stages -= 1
    return stages


def _core_rows(k_used: int, qsets: int, streams: int, norms: bool,
               wide: bool = False) -> int:
    """DB rows of a Hopper-core tile (the kernel's ``tile_rows``): 128 for
    an epilogue that takes them (``wide``) up to k_used = 256; else 64 where
    one ring stage of 64-row tiles of ``streams`` weight arrays fits beside
    one warpgroup's ``qsets`` query sets, else 32 (two sets and two streams
    past 448 lanes)."""
    if wide and k_used <= 256:
        return 128
    return 64 if _hopper_smem(k_used, 1, 1, qsets, norms, 64,
                              streams) <= _P2K_SMEM else 32


def _argmin2_rows(k_used: int) -> int:
    """DB rows of an argmin2 tile (the kernel's ``tile_rows``): 128 up to
    k_used = 256, where each dependent ``wgmma`` step then does twice the
    work, else 64."""
    return 128 if k_used <= 256 else 64


def _hopper_plan(name: str, m: int, n: int, sm_count: int, k_used: int,
                 consumer_choices, qsets: int, norms: bool,
                 rows: int = _P2K_ROWS, streams: int = 1) -> Packed2kPlan:
    """Launch plan of a Hopper-core scan for M queries against N DB rows on
    a card of ``sm_count`` SMs.  The most consumer warpgroups a block (of
    ``consumer_choices``) for which the ring beside their resident queries
    keeps at least two stages, else the fewest with the ring that fits;
    the fewest query tiles of at most 64 rows a warpgroup, as even as they
    come (each tile's blocks read every DB tile from L2 again, and blocks
    of equal work stay in step, so the later ones find it there); the
    deepest ring the shared memory allows; and the 64-row DB tiles cut into
    about one chunk per SM for each query tile, so each block walks one
    long run of tiles and the ring fills once per SM."""
    if m < 1 or n < 1 or sm_count < 1 or k_used < 16 or k_used % 16:
        raise ValueError(f"{name} plan: m={m}, n={n}, k_used={k_used}, "
                         f"sm_count={sm_count}")
    last = consumer_choices[-1]
    consumers, stages = next(
        ((c, st) for c in consumer_choices
         for st in [_hopper_stages(k_used, c, qsets, norms, rows, streams)]
         if st >= 2),
        (last, _hopper_stages(k_used, last, qsets, norms, rows, streams)))
    if not stages:
        raise ValueError(f"{name}: k_used={k_used} is too wide for the "
                         "kernel's shared memory")
    bm = -(-m // -(-m // (_P2K_ROWS * consumers)))
    q_tiles = -(-m // bm)
    tiles = -(-n // rows)
    per = -(-tiles // max(1, sm_count // q_tiles))
    return Packed2kPlan(consumers, bm, stages, per, -(-tiles // per),
                        q_tiles, _hopper_smem(k_used, stages, consumers,
                                              qsets, norms, rows, streams))


def _packed2k_smem(k_used: int, stages: int, consumers: int) -> int:
    """Dynamic shared memory of a packed2k block (``_hopper_smem``)."""
    return _hopper_smem(k_used, stages, consumers)


def _packed2k_plan(m: int, n: int, sm_count: int, k_used: int
                   ) -> Packed2kPlan:
    """Launch plan of the packed2k scan (``_hopper_plan``): three consumer
    warpgroups a block where a ring of two stages fits beside their
    resident queries, else two."""
    return _hopper_plan("packed2k", m, n, sm_count, k_used, _P2K_CONSUMERS,
                        qsets=1, norms=False)


# packed2k_best.cu takes k_used up to 512; past it packed2kw_best.cu, the
# core's packed2k instance at 33-72 k steps (k_used up to 1,152: the
# widest a preset reaches, RGB sources at patch 7 with the temporal block,
# is 1,040) with one consumer warpgroup (``_packed2kw_plan``)
_P2K_MAX_LANES = 512
_P2KW_MAX_LANES = 1152


def _packed2k_route(k_used: int) -> str:
    """The library (and launch-count key) that runs the packed2k form at
    ``k_used`` lanes, by width alone: ``packed_best`` (csrc/
    packed2k_best.cu, two or three warpgroups, instances up to 32 k steps)
    up to 512 lanes; past them ``packed2kw_best`` (csrc/packed2kw_best.cu,
    instances of 33-72 k steps: one warpgroup, since two warpgroups'
    resident query rows, 128 bytes a lane each, leave room for one ring
    stage at most up to 576 lanes and for none from 592 on; tiles of
    ``_core_rows`` rows, plan ``_packed2kw_plan``)."""
    if k_used > _P2KW_MAX_LANES:
        raise ValueError(f"packed2k: k_used={k_used} is past the widest "
                         f"kernel's {_P2KW_MAX_LANES} lanes")
    return "packed_best" if k_used <= _P2K_MAX_LANES else "packed2kw_best"


def _packed2kw_plan(m: int, n: int, sm_count: int, k_used: int
                    ) -> Packed2kPlan:
    """Launch plan of the packed2k scan past 512 lanes (``_hopper_plan``):
    one consumer warpgroup of one query set, DB tiles of ``_core_rows``
    rows (64 up to 896 lanes, 32 past them) and the deepest ring that fits
    beside it (two stages at 528-576 lanes, one from 592 on)."""
    if not _P2K_MAX_LANES < k_used <= _P2KW_MAX_LANES:
        raise ValueError(f"packed2kw: k_used={k_used} is outside the "
                         f"kernel's ({_P2K_MAX_LANES}, {_P2KW_MAX_LANES}]")
    return _hopper_plan("packed2kw", m, n, sm_count, k_used, (1,),
                        qsets=1, norms=False,
                        rows=_core_rows(k_used, 1, 1, False))


def _argmin2_plan(m: int, n: int, sm_count: int, k_used: int, fold: bool
                  ) -> Packed2kPlan:
    """Launch plan of the argmin2 scan (``_hopper_plan``), its norms in the
    ring and its tiles ``_argmin2_rows`` rows; with ``fold`` (q_split) each
    warpgroup holds its hi and its lo query rows.  Three consumer
    warpgroups where a ring of two stages fits beside their queries, else
    two, else one with the ring that fits: at k_used = 512 folded, one
    stage."""
    return _hopper_plan("argmin2", m, n, sm_count, k_used, _A2_CONSUMERS,
                        qsets=2 if fold else 1, norms=True,
                        rows=_argmin2_rows(k_used))


class PertilePlan(NamedTuple):
    consumers: int  # consumer warpgroups a block
    bm: int  # query rows a block (<= 64 consumers)
    stages: int  # ring depth
    tiles_per_chunk: int  # DB tiles a block: whole output tiles
    n_chunks: int  # grid y: DB chunks
    q_tiles: int  # grid x: query tiles of bm rows
    smem: int  # dynamic shared memory of a block
    rows: int  # DB rows a tile
    parts: int  # output tiles a scan tile (1: each champion in place)


# the fewest DB tiles a part of a split scan tile keeps
_PT_MIN_PART = 2


def _pertile_rows(tile_n: int, k_used: int) -> int:
    """DB rows of a pertile tile (the kernel's ``tile_rows`` of its
    ``EpiTile`` instance): 128 where they cut the scan tile evenly and
    k_used <= 256, else 64."""
    return 128 if tile_n % 128 == 0 and k_used <= 256 else 64


def _pertile_plan(m: int, n: int, sm_count: int, k_used: int, fold: bool,
                  tile_n: int, parts: Optional[int] = None) -> PertilePlan:
    """Launch plan of the pertile scan for M queries against N DB rows cut
    into scan tiles of ``tile_n`` rows: ``_hopper_plan``'s warpgroups, query
    tiles and ring (norms in the ring; with ``fold`` each warpgroup holds
    its hi and its lo query rows; tiles of ``_pertile_rows`` rows), and
    chunks of whole scan tiles, about one block per SM for each query tile,
    so every (scan tile, query row) is written by one block.  Where the
    scan tiles are too few to fill the card that way, each is cut into
    ``parts`` (a power of two) output tiles of at least ``_PT_MIN_PART``
    DB tiles, one block each, whose champions a merge folds; ``parts``
    given (a divisor of the scan tile's DB tiles) overrides that rule."""
    if tile_n < 64 or tile_n % 64 or n % tile_n:
        raise ValueError(f"pertile_champions plan: tile_n={tile_n} must be a "
                         f"multiple of 64 dividing n={n}")
    rows = _pertile_rows(tile_n, k_used)
    base = _hopper_plan("pertile_champions", m, n, sm_count, k_used,
                        _A2_CONSUMERS, qsets=2 if fold else 1, norms=True,
                        rows=rows)
    sub = tile_n // rows  # DB tiles a scan tile
    ntiles = n // tile_n
    room = max(1, sm_count // base.q_tiles)  # blocks of one query tile
    if parts is None:
        parts = 1
        while (sub % (2 * parts) == 0
               and sub // (2 * parts) >= _PT_MIN_PART
               and ntiles * 2 * parts <= room):
            parts *= 2
    elif parts < 1 or sub % parts:
        raise ValueError(f"pertile_champions plan: {parts} parts of a scan "
                         f"tile of {sub} DB tiles")
    return _whole_tiles(base, n, sm_count, tile_n, rows, parts)


def _whole_tiles(base, n: int, sm_count: int, tile_n: int, rows: int,
                 parts: int = 1) -> PertilePlan:
    """``base``'s warpgroups, query tiles and ring, with chunks of whole
    output tiles: scan tiles of ``tile_n`` rows (``rows``-row DB tiles each)
    cut in ``parts``, about one chunk per SM for each query tile, so every
    (output tile, query row) is written by one block."""
    sub = tile_n // rows  # DB tiles a scan tile
    units = n // tile_n * parts
    room = max(1, sm_count // base.q_tiles)  # blocks of one query tile
    per = -(-units // room)  # output tiles a block
    return PertilePlan(base.consumers, base.bm, base.stages,
                       per * (sub // parts), -(-units // per), base.q_tiles,
                       base.smem, rows, parts)


def _packed3_route(k_used: int) -> str:
    """The library (and launch-count key) that runs the packed3 form at
    ``k_used`` lanes, by width alone: ``packed3_best``
    (csrc/packed3_best.cu, the Hopper core) up to 256 lanes; past them a
    warpgroup's three resident query sets (147,456 bytes at 384 lanes)
    leave the core no room for one ring stage of both weight streams, so
    ``packed3w_best`` (csrc/packed3w_best.cu, which holds one or two query
    sets in registers; plan ``_packed3w_plan``)."""
    return "packed3_best" if k_used <= _P3_MAX_LANES else "packed3w_best"


def _packed3_plan(m: int, n: int, sm_count: int, k_used: int
                  ) -> Packed2kPlan:
    """Launch plan of the packed3 scan (``_hopper_plan``): three query
    sets a warpgroup ([q1|q1], [q2|q2], [q1|q3]), a ring stage of one W1
    and one W2 tile of 64 rows and their norms; three consumer warpgroups
    where a ring of two stages fits beside their queries, else two, else
    one (at 256 lanes)."""
    if k_used > _P3_MAX_LANES:
        raise ValueError(f"packed3: k_used={k_used} is past the Hopper "
                         f"kernel's {_P3_MAX_LANES} lanes")
    return _hopper_plan("packed3", m, n, sm_count, k_used, _P3_CONSUMERS,
                        qsets=3, norms=True, streams=2)


# csrc/packed3w_best.cu: k_used in (256, 512]; up to 26 k steps (416
# lanes) two query sets a warpgroup sit in registers and a block runs up
# to two consumer warpgroups, past them one set and one warpgroup (the
# kernel's ``reg_sets`` / ``max_consumers``)
_P3W_MAX_LANES = 512
_P3W_REG2_MAX_KSTEPS = 26


class Packed3wPlan(NamedTuple):
    consumers: int  # consumer warpgroups a block
    bm: int  # query rows a block (<= 64 consumers)
    stages: int  # ring depth
    tiles_per_chunk: int  # DB tiles per block
    n_chunks: int  # grid y: DB chunks
    q_tiles: int  # grid x: query tiles of bm rows
    smem: int  # dynamic shared memory of a block
    rows: int  # DB rows a tile
    reg_sets: int  # query sets a warpgroup holds in registers


def _packed3w_layout(k_used: int) -> Tuple[int, int, int]:
    """(query sets in registers, most consumer warpgroups, DB rows a tile)
    of the packed3w instance at ``k_used`` lanes (the kernel's
    ``reg_sets``, ``max_consumers`` and ``w_tile_rows``): two sets and two
    warpgroups up to 26 k steps, else one and one; 64-row tiles where a
    ring of two such stages fits beside the shared-memory sets of the most
    warpgroups, else 32."""
    reg = 2 if k_used // 16 <= _P3W_REG2_MAX_KSTEPS else 1
    cmax = 2 if reg == 2 else 1
    rows = 64 if _hopper_smem(k_used, 2, cmax, 3 - reg, True, 64,
                              2) <= _P2K_SMEM else 32
    return reg, cmax, rows


def _packed3w_plan(m: int, n: int, sm_count: int, k_used: int
                   ) -> Packed3wPlan:
    """Launch plan of the packed3 scan past 256 lanes (``_hopper_plan``
    over ``_packed3w_layout``): 3 - reg_sets query sets a warpgroup in
    shared memory, a ring stage of one W1 and one W2 tile and their norms;
    two consumer warpgroups where the instance runs two and a ring of two
    stages fits, else one.  Past 448 lanes one set of 64 rows leaves room
    for a single 32-row stage only."""
    if not _P3_MAX_LANES < k_used <= _P3W_MAX_LANES:
        raise ValueError(f"packed3w: k_used={k_used} is outside the "
                         f"kernel's ({_P3_MAX_LANES}, {_P3W_MAX_LANES}]")
    reg, cmax, rows = _packed3w_layout(k_used)
    base = _hopper_plan("packed3w", m, n, sm_count, k_used,
                        tuple(range(cmax, 0, -1)), qsets=3 - reg,
                        norms=True, rows=rows, streams=2)
    return Packed3wPlan(*base, rows=rows, reg_sets=reg)


def _packed_form_plan(form: str, m: int, n: int, sm_count: int,
                      k_used: int) -> Packed2kPlan:
    """Launch plan of one of the four superseded packed forms on the core
    (``_hopper_plan``): two query sets a warpgroup (folded, or one against
    each of two weight streams), the half norms in the ring unless the norm
    rides W's lanes, tiles of ``_core_rows`` rows (32 for the two-stream
    forms past 448 lanes); three consumer warpgroups where a ring of two
    stages fits beside their queries, else two, else one."""
    fold, two, norm_in_w = next(key for key, name in _PACKED_FORMS.items()
                                if name == form)
    streams = 2 if two else 1
    return _hopper_plan(form, m, n, sm_count, k_used, _A2_CONSUMERS,
                        qsets=2, norms=not norm_in_w,
                        rows=_core_rows(k_used, 2, streams, not norm_in_w),
                        streams=streams)


def _dots(q: torch.Tensor, w: torch.Tensor, k_used: int) -> torch.Tensor:
    return q[:, :k_used].float() @ w[:, :k_used].float().T


def _packed_scores_plain(qa, w1, k_used, qb, w2, dbnh, fold_a):
    """The packed passes' (M, N) fp32 scores in the JAX kernels' order:
    qa.W1 (row blocks summed with ``fold_a``), plus qb.W2, minus dbnh."""
    m = qa.shape[0] // 2 if fold_a else qa.shape[0]
    s = _dots(qa[:m], w1, k_used)
    if fold_a:
        s = s + _dots(qa[m:], w1, k_used)
    if w2 is not None:
        s = s + _dots(qb, w2, k_used)
    if dbnh is not None:
        s = s - dbnh[None, :]
    return s


def _first_max(scores: torch.Tensor):
    idx = torch.argmax(scores, dim=1)  # first occurrence: lowest index
    return idx.to(torch.int32), scores.gather(1, idx[:, None])[:, 0]


def _check_packed(name, qa, w1, k_used, qb, w2, dbnh, fold_a) -> int:
    """Validate the packed operands; returns the used lanes."""
    if qa.dim() != 2 or w1.dim() != 2 or qa.shape[1] != w1.shape[1]:
        raise ValueError(f"{name}: qa {tuple(qa.shape)} and w1 "
                         f"{tuple(w1.shape)} must be (M,K) and (N,K)")
    qm, k = qa.shape
    n = w1.shape[0]
    k_used = k if k_used == 0 else k_used
    if (k % 128 or not 0 < k <= _P2KW_MAX_LANES or k_used % 16
            or not 0 < k_used <= k):
        raise ValueError(f"{name}: K={k} must be a multiple of 128 up to "
                         f"{_P2KW_MAX_LANES} and k_used={k_used} a multiple "
                         "of 16 in (0, K]")
    if qm == 0 or n == 0 or (fold_a and qm % 2):
        raise ValueError(f"{name}: qa has {qm} rows, w1 {n}")
    m = qm // 2 if fold_a else qm
    if (w2 is None) != (qb is None):
        raise ValueError(f"{name}: qb and w2 come together")
    if w2 is not None and (tuple(w2.shape) != tuple(w1.shape)
                           or tuple(qb.shape) != (m, k)):
        raise ValueError(f"{name}: qb {tuple(qb.shape)} / w2 "
                         f"{tuple(w2.shape)} do not match qa / w1")
    if any(t is not None and t.dtype != torch.bfloat16
           for t in (qa, w1, qb, w2)):
        raise ValueError(f"{name}: query and weight operands must be "
                         "bfloat16")
    if dbnh is not None and (dbnh.dtype != torch.float32
                             or tuple(dbnh.shape) != (n,)):
        raise ValueError(f"{name}: dbnh must be float32 of shape ({n},)")
    return k_used


def packed_best_plain(qa: torch.Tensor, w1: torch.Tensor, k_used: int = 0,
                      *, qb: Optional[torch.Tensor] = None,
                      w2: Optional[torch.Tensor] = None,
                      dbnh: Optional[torch.Tensor] = None,
                      fold_a: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``packed_best``: the fp32 scores of the packed
    passes over the first ``k_used`` lanes, then the first (lowest-index)
    maximum."""
    k_used = k_used or qa.shape[1]
    return _first_max(_packed_scores_plain(qa, w1, k_used, qb, w2, dbnh,
                                           fold_a))


def packed_best(qa: torch.Tensor, w1: torch.Tensor, k_used: int = 0, *,
                qb: Optional[torch.Tensor] = None,
                w2: Optional[torch.Tensor] = None,
                dbnh: Optional[torch.Tensor] = None,
                fold_a: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query row m: (idx, val) = the lexicographic maximum over DB rows
    n of the packed passes (bf16 operands, fp32 accumulation), lowest index
    on ties:

        qa[m].w1[n] (+ qa[M+m].w1[n] with ``fold_a``) (+ qb[m].w2[n])
        (- dbnh[n] when given; else the norm rides w1's lanes)

    With no ``qb``/``w2``/``dbnh`` and no fold this is the main path's
    ``packed2k`` form: ``qa`` (M, K) rows ``[q1|q1|1 1 1|q2|q1|0]`` against
    ``wk = [d1|d2|n1 n2 n3|d1|d3|0]`` (``pack_wk`` in backends/cuda.py);
    on the card it runs ``csrc/packed2k_best.cu`` (``wgmma`` on a TMA ring,
    launch plan ``_packed2k_plan``) up to ``k_used`` = 512 and
    ``csrc/packed2kw_best.cu`` (the same core, plan ``_packed2kw_plan``)
    past it, by the width rule ``_packed2k_route``.  Folded, with both
    streams and dbnh it is exact_hi2's ``packed3`` form (``packed3_best``),
    which the width rule ``_packed3_route`` sends to
    ``csrc/packed3_best.cu`` (the same
    core with a second weight stream, plan ``_packed3_plan``) up to
    ``k_used`` = 256 and to ``csrc/packed3w_best.cu`` (plan
    ``_packed3w_plan``) past it.  The other four combinations the JAX
    package names are the ``*_best`` wrappers below, each on the core from
    ``csrc/<form>.cu`` (plan ``_packed_form_plan``).  Every kernel but
    packed2k's reads ``qa`` and ``qb`` as one query tensor, without a copy
    where ``qb`` lies right after ``qa`` (``_query_operand``).  K a
    multiple of 128 up to 1,152 (each form's kernel refuses the widths past
    its own); lanes at and past ``k_used`` (a multiple of 16; 0 means K)
    must be zero in the query rows, the kernel skips them.  Returns (idx (M,)
    int32, val (M,) fp32).
    """
    k_used = _check_packed("packed_best", qa, w1, k_used, qb, w2, dbnh,
                           fold_a)
    form = _PACKED_FORMS.get((fold_a, w2 is not None, dbnh is None))
    if form is None:
        raise ValueError(
            f"packed_best: fold_a={fold_a}, two streams={w2 is not None}, "
            f"norm in W={dbnh is None} is not one of the packed forms")
    if _on_cpu(qa, w1, qb, w2, dbnh):
        return packed_best_plain(qa, w1, k_used, qb=qb, w2=w2, dbnh=dbnh,
                                 fold_a=fold_a)
    _check_cuda("packed_best", qa=qa, w1=w1, qb=qb, w2=w2, dbnh=dbnh)
    k = qa.shape[1]
    m = qa.shape[0] // 2 if fold_a else qa.shape[0]
    n = w1.shape[0]
    dev = _device_index(qa)
    stream = torch.cuda.current_stream(qa.device).cuda_stream
    route = (_packed3_route(k_used) if form == "packed3_best" else
             _packed2k_route(k_used) if form == "packed_best" else form)
    sm = _sm_count(dev)
    plan_fn = {"packed_best": _packed2k_plan,
               "packed2kw_best": _packed2kw_plan,
               "packed3_best": _packed3_plan,
               "packed3w_best": _packed3w_plan}.get(route)
    plan = (plan_fn(m, n, sm, k_used) if plan_fn is not None
            else _packed_form_plan(form, m, n, sm, k_used))
    part_val = torch.empty((plan.n_chunks, m), dtype=torch.float32,
                           device=qa.device)
    part_idx = torch.empty((plan.n_chunks, m), dtype=torch.int32,
                           device=qa.device)
    out_idx = torch.empty((m,), dtype=torch.int32, device=qa.device)
    out_val = torch.empty((m,), dtype=torch.float32, device=qa.device)
    geometry = (plan.consumers, plan.bm, plan.stages, plan.tiles_per_chunk,
                plan.smem, plan.n_chunks, part_val.data_ptr(),
                part_idx.data_ptr(), out_idx.data_ptr(), out_val.data_ptr(),
                dev, stream)
    if form == "packed_best":
        source = ("packed2k_best" if route == "packed_best"
                  else "packed2kw_best")
        lib = _build.load(source)
        err = getattr(lib, f"ia_{source}")(qa.data_ptr(), w1.data_ptr(), m,
                                           n, k, k_used, *geometry)
    else:
        lib = _build.load(route)
        ptr = lambda t: None if t is None else t.data_ptr()
        err = getattr(lib, f"ia_{route}")(
            _query_operand(qa, qb).data_ptr(), w1.data_ptr(), ptr(w2),
            ptr(dbnh), m, n, k, k_used, *geometry)
    _build.check(lib, err, f"{route} launch")
    LAUNCHES[route] += 1
    return out_idx, out_val


def _query_operand(qa: torch.Tensor, qb: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """The card kernels' one query operand, qa's rows then qb's: qa itself
    where there is no qb or qb lies right after it in memory (the kernels
    read it by its pointer; the wrappers build their rows so,
    ``_row_blocks``), else a copy of both."""
    if qb is None or qb.data_ptr() == (qa.data_ptr()
                                       + qa.numel() * qa.element_size()):
        return qa
    return torch.cat([qa, qb])


def _pack_rows(left: torch.Tensor, right: torch.Tensor, kp: int
               ) -> torch.Tensor:
    """(M, kp) bf16 rows ``[left | right | 0]``."""
    m, l = left.shape
    out = torch.zeros((m, kp), dtype=torch.bfloat16, device=left.device)
    out[:, :l] = left
    out[:, l:2 * l] = right
    return out


def _row_blocks(pairs, kp: int) -> torch.Tensor:
    """One (len(pairs) M, kp) bf16 tensor of the row blocks ``[left | right
    | 0]``, one block a (left, right) pair: the card kernels read a form's
    query sets as one operand, so views of its blocks need no copy."""
    m, l = pairs[0][0].shape
    out = torch.zeros((len(pairs), m, kp), dtype=torch.bfloat16,
                      device=pairs[0][0].device)
    out[:, :, :l] = torch.stack([left for left, _ in pairs])
    out[:, :, l:2 * l] = torch.stack([right for _, right in pairs])
    return out.view(len(pairs) * m, kp)


def norm_query_rows(q1: torch.Tensor, q2: torch.Tensor, kp: int
                    ) -> torch.Tensor:
    """The qa row blocks of the norm-in-W single-stream scan: rows [0, M)
    = [q1|q1|1 1 1] (products q1.d1 + q1.d2 + norm), rows [M, 2M) =
    [q2|0|0] (product q2.d1), folded by the kernel (JAX
    ``norm_query_rows`` without the row padding the TPU tiles need)."""
    l = q1.shape[1]
    row_a = _pack_rows(q1, q1, kp)
    row_a[:, 2 * l:2 * l + 3] = 1.0
    return torch.cat([row_a, _pack_rows(q2, torch.zeros_like(q2), kp)])


def _lanes(l: int, norm: bool = False) -> int:
    return _round_up(2 * l + (3 if norm else 0), 16)


def packed2_best(q1, q2, w1, w2, dbnh):
    """Two-stream scan q1.d1 + q1.d2 + q2.d1 + q1.d3 - ||d||^2/2: rows
    [q1|q1].W1 + [q2|q1].W2 with W1 = [d1|d2], W2 = [d1|d3].  Returns
    (idx (M,), val (M,))."""
    m, l = q1.shape
    q = _row_blocks([(q1, q1), (q2, q1)], w1.shape[1])
    return packed_best(q[:m], w1, _lanes(l), qb=q[m:], w2=w2, dbnh=dbnh)


def packed1w_best(q1, q2, w1, dbnh):
    """Single-weight-stream scan q1.d1 + q1.d2 + q2.d1 - ||d||^2/2: folded
    rows [q1|q1] and [q2|0] against W1 = [d1|d2] (rejected for parity by
    the JAX package; kept with its test)."""
    qa = _row_blocks([(q1, q1), (q2, torch.zeros_like(q2))], w1.shape[1])
    return packed_best(qa, w1, _lanes(q1.shape[1]), dbnh=dbnh, fold_a=True)


def packed2wn_best(q1, q2, w1n, w2):
    """packed2's product set with the norm riding W1's lanes
    (``add_norm_lanes``): rows [q1|q1|1 1 1].W1n + [q2|q1|0].W2
    (superseded by ``packed_best``'s K-wide form; kept with its test)."""
    m, l = q1.shape
    q = _row_blocks([(q1, q1), (q2, q1)], w1n.shape[1])
    q[:m, 2 * l:2 * l + 3] = 1.0
    return packed_best(q[:m], w1n, _lanes(l, norm=True), qb=q[m:], w2=w2)


def packed1wn_best(q1, q2, w1n):
    """Single-stream, norm-in-W scan q1.d1 + q1.d2 + q2.d1 - ||d||^2/2
    (``norm_query_rows`` folded against W1n; rejected for parity by the
    JAX package, kept with its test)."""
    kp, l = w1n.shape[1], q1.shape[1]
    return packed_best(norm_query_rows(q1, q2, kp), w1n,
                       _lanes(l, norm=True), fold_a=True)


def _packed3_rows(q1, q2, q3, kp):
    """(qa, qb) of the packed3 scan: views of one (3M, kp) bf16 tensor
    with rows [q1|q1], [q2|q2] (qa, folded) and [q1|q3] (qb), built once so
    that the card kernel reads them as its one query operand."""
    m = q1.shape[0]
    q = _row_blocks([(q1, q1), (q2, q2), (q1, q3)], kp)
    return q[:2 * m], q[2 * m:]


def packed3_best(q1, q2, q3, w1, w2, dbnh):
    """The exact_hi2 scan: the full six-product bf16_6x set
    q1.d1 + q1.d2 + q2.d1 + q1.d3 + q2.d2 + q3.d1 - ||d||^2/2 as folded
    rows [q1|q1], [q2|q2] against W1 = [d1|d2] plus [q1|q3] against
    W2 = [d3|d1].  ``q1``/``q2``/``q3`` are the (M, L) bf16 splits of the
    centered live query dims.  Returns (idx (M,), val (M,))."""
    qa, qb = _packed3_rows(q1, q2, q3, w1.shape[1])
    return packed_best(qa, w1, _lanes(q1.shape[1]), qb=qb, w2=w2, dbnh=dbnh,
                       fold_a=True)


# ------------------------------------------------------- packed_champions


def _tile_champions(scores: torch.Tensor, tile_n: int):
    """Tile-major (ntiles, M) per-tile (max, first argmax + tile offset)."""
    m, npad = scores.shape
    st = scores.view(m, npad // tile_n, tile_n)
    arg = torch.argmax(st, dim=2)  # first occurrence within the tile
    vals = st.gather(2, arg[..., None])[..., 0]
    off = torch.arange(0, npad, tile_n, device=scores.device)
    idx = (arg + off[None, :]).to(torch.int32)
    return vals.T.contiguous(), idx.T.contiguous()


def _check_tile(name: str, tile_n: int, npad: int) -> int:
    """The tile snapped to a divisor of ``npad``; the CUDA per-tile scans
    need it to be a multiple of 64 rows, which their DB tiles divide (32
    or 64 rows; 128 only where they divide the tile)."""
    tile_n = _snap_tile(tile_n, npad)
    if tile_n % 64:
        raise ValueError(f"{name}: the CUDA scan needs a tile of a multiple "
                         f"of 64 rows dividing {npad}; got {tile_n}")
    return tile_n


def _champions_route(k_used: int, fold: bool) -> str:
    """The library that runs the per-tile champions at ``k_used`` lanes:
    ``tile_champions`` (csrc/tile_champions.cu, the Hopper core) but folded
    past 256 lanes, where three resident query sets leave the core no room
    for a ring stage of both weight streams (as for packed3,
    ``_packed3_route``): ``packed3w_best`` (its kernel with the per-tile
    epilogue, entry ``ia_packed3w_champions``)."""
    return ("packed3w_best" if fold and k_used > _P3_MAX_LANES
            else "tile_champions")


def _champions_plan(m: int, n: int, sm_count: int, k_used: int, fold: bool,
                    tile_n: int) -> PertilePlan:
    """Launch plan of the per-tile champions (``_champions_route``): on the
    core, packed3's layout (``_hopper_plan``: two or, folded, three query
    sets a warpgroup, a ring stage of a W1 and a W2 tile and their norms,
    tiles of ``_core_rows`` rows: 32 unfolded past 448 lanes); folded past
    256 lanes ``_packed3w_plan``.  Chunks of whole output tiles of
    ``tile_n`` rows (a multiple of 64 dividing N), about one chunk per SM
    for each query tile (``_whole_tiles``), so each champion is written in
    place by one block."""
    if tile_n < 64 or tile_n % 64 or n % tile_n:
        raise ValueError(f"packed_champions plan: tile_n={tile_n} must be a "
                         f"multiple of 64 dividing n={n}")
    if _champions_route(k_used, fold) == "packed3w_best":
        base = _packed3w_plan(m, n, sm_count, k_used)
        rows = base.rows
    else:
        qsets = 3 if fold else 2
        rows = _core_rows(k_used, qsets, 2, True)
        base = _hopper_plan("packed_champions", m, n, sm_count, k_used,
                            _P3_CONSUMERS, qsets=qsets, norms=True,
                            rows=rows, streams=2)
    return _whole_tiles(base, n, sm_count, tile_n, rows)


def packed_champions_plain(qa, qb, w1, w2, dbnh, tile_n: int,
                           k_used: int = 0, fold_a: bool = False):
    """Plain version of ``packed_champions``."""
    k_used = k_used or qa.shape[1]
    tile_n = _snap_tile(tile_n, w1.shape[0])
    return _tile_champions(
        _packed_scores_plain(qa, w1, k_used, qb, w2, dbnh, fold_a), tile_n)


def packed_champions(qa, qb, w1, w2, dbnh, tile_n: int, k_used: int = 0,
                     fold_a: bool = False):
    """Per query row m and DB tile t of ``tile_n`` rows (snapped to a
    divisor of Npad): the (max, first argmax) of the two-stream packed
    passes  qa.W1 (+ folded block) + qb.W2 - dbnh.  Returns tile-major
    (vals (ntiles, M) fp32, idx (ntiles, M) int32 global rows); an
    all-padding tile gives -inf at its first row.  On the card it runs
    ``csrc/tile_champions.cu`` on the Hopper core, or folded past 256 lanes
    ``csrc/packed3w_best.cu`` (``_champions_route``; launch plan
    ``_champions_plan``), each output tile's champion written in place."""
    k_used = _check_packed("packed_champions", qa, w1, k_used, qb, w2, dbnh,
                           fold_a)
    if w2 is None or dbnh is None:
        raise ValueError("packed_champions: needs qb, w2 and dbnh")
    if _on_cpu(qa, qb, w1, w2, dbnh):
        return packed_champions_plain(qa, qb, w1, w2, dbnh, tile_n, k_used,
                                      fold_a)
    _check_cuda("packed_champions", qa=qa, qb=qb, w1=w1, w2=w2, dbnh=dbnh)
    m = qb.shape[0]
    n, k = w1.shape
    tile_n = _check_tile("packed_champions", tile_n, n)
    ntiles = n // tile_n
    dev = _device_index(qa)
    plan = _champions_plan(m, n, _sm_count(dev), k_used, fold_a, tile_n)
    route = _champions_route(k_used, fold_a)
    lib = _build.load(route)
    entry = ("ia_tile_champions" if route == "tile_champions"
             else "ia_packed3w_champions")
    vals = torch.empty((ntiles, m), dtype=torch.float32, device=qa.device)
    idx = torch.empty((ntiles, m), dtype=torch.int32, device=qa.device)
    err = getattr(lib, entry)(
        _query_operand(qa, qb).data_ptr(), w1.data_ptr(), w2.data_ptr(),
        dbnh.data_ptr(), m, n, k, k_used, int(fold_a), tile_n,
        plan.consumers, plan.bm, plan.stages, plan.tiles_per_chunk,
        plan.smem, plan.n_chunks, vals.data_ptr(), idx.data_ptr(), dev,
        torch.cuda.current_stream(qa.device).cuda_stream)
    _build.check(lib, err, "packed_champions launch")
    LAUNCHES["packed_champions"] += 1
    return vals, idx


def packed2_champions(q1, q2, w1, w2, dbnh, tile_n: int):
    """Per-tile twin of ``packed2_best``: (vals (M, ntiles), idx (M,
    ntiles))."""
    m, l = q1.shape
    q = _row_blocks([(q1, q1), (q2, q1)], w1.shape[1])
    vals, idx = packed_champions(q[:m], q[m:], w1, w2, dbnh, tile_n,
                                 _lanes(l))
    return vals.T, idx.T


def packed3_champions(q1, q2, q3, w1, w2, dbnh, tile_n: int):
    """Per-tile twin of ``packed3_best``: (vals (M, ntiles), idx (M,
    ntiles))."""
    qa, qb = _packed3_rows(q1, q2, q3, w1.shape[1])
    vals, idx = packed_champions(qa, qb, w1, w2, dbnh, tile_n,
                                 _lanes(q1.shape[1]), fold_a=True)
    return vals.T, idx.T


# ------------------------------------------------------ pertile_champions


def _scan_queries(q: torch.Tensor, q_split: bool) -> torch.Tensor:
    """The bf16 query block of the bf16-DB scans.  ``q_split``: (2M, Fp)
    = [hi; lo] with hi the truncated bf16 of the fp32 query (exact) and lo
    the residual ROUNDED to bf16, as the JAX entries' ``.astype``.  Without
    it: the query rounded to bf16."""
    if q_split:
        hi, lo = bf16_split2(q.float())
        return torch.cat([hi.to(torch.bfloat16), lo.to(torch.bfloat16)])
    return q if q.dtype == torch.bfloat16 else q.to(torch.bfloat16)


def _check_bf16_scan(name, q, dbp, norm, k_used) -> int:
    if q.dim() != 2 or dbp.dim() != 2 or q.shape[1] != dbp.shape[1]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and dbp "
                         f"{tuple(dbp.shape)} must be (M,Fp) and (N,Fp)")
    m, fp = q.shape
    n = dbp.shape[0]
    k_used = fp if k_used == 0 else k_used
    if fp not in (128, 256, 384, 512) or k_used % 16 or \
            not 0 < k_used <= fp:
        raise ValueError(f"{name}: Fp={fp} must be 128/256/384/512 and "
                         f"k_used={k_used} a multiple of 16 in (0, Fp]")
    if m == 0 or n == 0:
        raise ValueError(f"{name}: empty operand")
    if dbp.dtype != torch.bfloat16 or norm.dtype != torch.float32 or \
            tuple(norm.shape) != (n,):
        raise ValueError(f"{name}: dbp must be bfloat16 and its norms "
                         f"float32 of shape ({n},)")
    return k_used


def pertile_champions_plain(q, dbp, dbnh, tile_n: int,
                            q_split: bool = False, k_used: int = 0):
    """Plain version of ``pertile_champions``."""
    qk = _scan_queries(q, q_split)
    k_used = k_used or qk.shape[1]
    return packed_champions_plain(qk, None, dbp, None, dbnh, tile_n, k_used,
                                  fold_a=q_split)


def pertile_champions(q: torch.Tensor, dbp: torch.Tensor,
                      dbnh: torch.Tensor, tile_n: int,
                      q_split: bool = False, k_used: int = 0):
    """Per query row m and DB tile t of ``tile_n`` rows (snapped to a
    divisor of Npad): (max, first argmax) of  s2 = q.db - dbnh  over the
    bf16 DB ``dbp`` (Npad, Fp), bigger = closer.  ``q`` (M, Fp) fp32 (or
    bf16 without ``q_split``): rounded to bf16, or with ``q_split`` its
    hi/lo bf16 blocks both scored and summed.  Lanes at and past
    ``k_used`` (0: Fp) are zero in ``q`` and skipped.  Returns tile-major
    (vals (ntiles, M) fp32, idx (ntiles, M) int32 global rows); padding
    rows carry dbnh = +inf, so an all-padding tile gives -inf at its first
    row.  On the card it runs ``csrc/pertile_champions.cu`` on the Hopper
    core (``wgmma`` on a TMA ring, the norms in the ring, each scan tile's
    champion written in place; launch plan ``_pertile_plan``)."""
    k_used = _check_bf16_scan("pertile_champions", q, dbp, dbnh, k_used)
    if _on_cpu(q, dbp, dbnh):
        return pertile_champions_plain(q, dbp, dbnh, tile_n, q_split, k_used)
    # fp32 queries: the C entry writes their bf16 query block
    q = (q.float() if q_split or q.dtype != torch.bfloat16 else q
         ).contiguous()
    _check_cuda("pertile_champions", q=q, dbp=dbp, dbnh=dbnh)
    m, n = q.shape[0], dbp.shape[0]
    tile_n = _check_tile("pertile_champions", tile_n, n)
    plan = _pertile_plan(m, n, _sm_count(_device_index(q)), k_used,
                         q_split, tile_n)
    return _pertile_launch(q, dbp, dbnh, tile_n, k_used, q_split, plan)


def _pertile_launch(q, dbp, dbnh, tile_n, k_used, q_split,
                    plan: PertilePlan):
    """One call of ``csrc/pertile_champions.cu`` on checked card operands
    by ``plan``: ``q`` (M, Fp) fp32, whose bf16 query block
    (``_scan_queries``: hi/lo rows with ``q_split``) the entry writes
    first, or that block itself in bf16 ((2M, Fp) with ``q_split``).
    Returns (vals, idx), (n / tile_n, M) each."""
    n, k = dbp.shape
    qf32 = q.dtype == torch.float32
    m = q.shape[0] if qf32 or not q_split else q.shape[0] // 2
    ntiles = n // tile_n
    dev = q.device
    qk = (torch.empty(((2 if q_split else 1) * m, k), dtype=torch.bfloat16,
                      device=dev) if qf32 else None)
    vals = torch.empty((ntiles, m), dtype=torch.float32, device=dev)
    idx = torch.empty((ntiles, m), dtype=torch.int32, device=dev)
    part_val = part_idx = None
    if plan.parts > 1:
        part_val = torch.empty((ntiles * plan.parts, m), dtype=torch.float32,
                               device=dev)
        part_idx = torch.empty((ntiles * plan.parts, m), dtype=torch.int32,
                               device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.load("pertile_champions")
    err = lib.ia_pertile_champions(
        q.data_ptr(), int(qf32), ptr(qk), dbp.data_ptr(), dbnh.data_ptr(), m,
        n, k, k_used, int(q_split), tile_n, plan.consumers, plan.bm,
        plan.stages, plan.tiles_per_chunk, plan.smem, plan.n_chunks,
        plan.parts, ptr(part_val), ptr(part_idx), vals.data_ptr(),
        idx.data_ptr(), _device_index(q),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "pertile_champions launch")
    LAUNCHES["pertile_champions"] += 1
    return vals, idx


def _pad_lanes(queries: torch.Tensor, fp: int) -> torch.Tensor:
    m, f = queries.shape
    qp = torch.zeros((m, fp), dtype=queries.dtype, device=queries.device)
    qp[:, :f] = queries
    return qp


def pertile_champions_queries(queries: torch.Tensor, dbp: torch.Tensor,
                              dbnh: torch.Tensor, tile_n: int,
                              q_split: bool = False):
    """Raw-query wrapper of ``pertile_champions``: lane-pad the (M, F)
    fp32 queries, scan, and return (vals (M, ntiles), idx (M, ntiles))."""
    f = queries.shape[1]
    vals, idx = pertile_champions(_pad_lanes(queries, dbp.shape[1]), dbp,
                                  dbnh, tile_n, q_split, _round_up(f, 16))
    return vals.T, idx.T


# --------------------------------------------------------- argmin_l2_bf16


def argmin_l2_bf16_plain(q, dbp, dbn, k_used: int = 0):
    """Plain version of ``argmin_l2_bf16``: round the query to bf16, go
    back to fp32, one fp32 product with the bf16 DB, then the first
    (lowest-index) minimum of ``dbn - 2 dots``."""
    qk = _scan_queries(q, False)
    k_used = k_used or qk.shape[1]
    s = dbn[None, :] - 2.0 * _dots(qk, dbp, k_used)
    idx = torch.argmin(s, dim=1)
    return idx.to(torch.int32), s.gather(1, idx[:, None])[:, 0]


def _argmin_bf16_plan(m: int, n: int, sm_count: int, k_used: int
                      ) -> Packed2kPlan:
    """Launch plan of the argmin_l2_bf16 scan (``_hopper_plan``): one
    query set a warpgroup, the norms in the ring, tiles of
    ``_argmin2_rows`` rows (128 up to k_used = 256, else 64); three
    consumer warpgroups where a ring of two stages fits beside their
    queries, else two, else one.  At level 0 of batched npr_1024 (M =
    1,024, N = 2^20, 80 lanes, 132 SMs): six query tiles of 171 rows, so
    each DB tile is read six times from L2 (1.2 GB from L2 to the SMs),
    against eight of 128 rows (1.6 GB) that would waste none of a block's
    192; the fewest tiles win."""
    return _hopper_plan("argmin_l2_bf16", m, n, sm_count, k_used,
                        _A2_CONSUMERS, qsets=1, norms=True,
                        rows=_argmin2_rows(k_used))


def argmin_l2_bf16(q: torch.Tensor, dbp: torch.Tensor, dbn: torch.Tensor,
                   k_used: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query row m: (idx, score) = the lexicographic minimum over DB
    rows n of  score = dbn[n] - 2 q[m].dbp[n]  with bf16 operands and fp32
    accumulation, lowest index on ties — what the JAX package's
    ``pallas_argmin_l2(..., bf16=True)`` computes.

    ``q`` (M, Fp) fp32, rounded to bf16 to nearest (or already bf16);
    ``dbp`` (Npad, Fp) bf16 rows, rounded from fp32; ``dbn`` (Npad,) fp32
    norms of the UNROUNDED rows, +inf on padding rows, which never win.
    Lanes at and past ``k_used`` (0: Fp) are zero in ``q`` and skipped.
    The caller adds ||q||^2.  Returns (idx (M,) int32, score (M,) fp32).
    On the card it runs ``csrc/argmin_bf16.cu`` on the Hopper core
    (``wgmma`` on a TMA ring, the norms in the ring; launch plan
    ``_argmin_bf16_plan``), whose entry rounds fp32 queries itself."""
    k_used = _check_bf16_scan("argmin_l2_bf16", q, dbp, dbn, k_used)
    if _on_cpu(q, dbp, dbn):
        return argmin_l2_bf16_plain(q, dbp, dbn, k_used)
    # fp32 queries: the C entry writes their bf16 query block
    q = (q if q.dtype == torch.bfloat16 else q.float()).contiguous()
    _check_cuda("argmin_l2_bf16", q=q, dbp=dbp, dbn=dbn)
    m, fp = q.shape
    n = dbp.shape[0]
    dev = _device_index(q)
    plan = _argmin_bf16_plan(m, n, _sm_count(dev), k_used)
    qf32 = q.dtype == torch.float32
    qk = (torch.empty((m, fp), dtype=torch.bfloat16, device=q.device)
          if qf32 else None)
    part_val = torch.empty((plan.n_chunks, m), dtype=torch.float32,
                           device=q.device)
    part_idx = torch.empty((plan.n_chunks, m), dtype=torch.int32,
                           device=q.device)
    out_idx = torch.empty((m,), dtype=torch.int32, device=q.device)
    out_val = torch.empty((m,), dtype=torch.float32, device=q.device)
    lib = _build.load("argmin_bf16")
    err = lib.ia_argmin_l2_bf16(
        q.data_ptr(), int(qf32), None if qk is None else qk.data_ptr(),
        dbp.data_ptr(), dbn.data_ptr(), m, n, fp, k_used, plan.consumers,
        plan.bm, plan.stages, plan.tiles_per_chunk, plan.smem, plan.n_chunks,
        part_val.data_ptr(), part_idx.data_ptr(), out_idx.data_ptr(),
        out_val.data_ptr(), dev,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "argmin_l2_bf16 launch")
    LAUNCHES["argmin_l2_bf16"] += 1
    return out_idx, out_val


def prepadded_argmin_queries(queries: torch.Tensor, dbp: torch.Tensor,
                             dbn: torch.Tensor):
    """Raw-query wrapper of ``argmin_l2_bf16`` (the JAX package's
    ``prepadded_argmin_queries`` at DEFAULT precision): lane-pad the (M, F)
    fp32 queries, scan, and recover the squared distance
    d = max(score + ||q||^2, 0) with the norm of the unrounded query.  The
    kernel takes any M, so the rows are not padded to the TPU's tiles.
    Returns (idx (M,) int32, d (M,) fp32)."""
    f = queries.shape[1]
    idx, score = argmin_l2_bf16(_pad_lanes(queries, dbp.shape[1]), dbp, dbn,
                                _round_up(f, 16))
    qn = (queries * queries).sum(dim=1)
    return idx, torch.clamp(score + qn, min=0.0)


# ------------------------------------------------------------- argmin2_l2


def argmin2_l2_plain(q, dbp, dbn, q_split: bool = False, k_used: int = 0):
    """Plain version of ``argmin2_l2``: the scores ``dbn - 2 q.db`` (hi
    and lo dots summed first under ``q_split``), the first minimum, then
    the first minimum with that column set to +inf."""
    qk = _scan_queries(q, q_split)
    k_used = k_used or qk.shape[1]
    m = q.shape[0]
    dots = _dots(qk[:m], dbp, k_used)
    if q_split:
        dots = dots + _dots(qk[m:], dbp, k_used)
    s = dbn[None, :] - 2.0 * dots
    i1 = torch.argmin(s, dim=1)
    v1 = s.gather(1, i1[:, None])[:, 0]
    s.scatter_(1, i1[:, None], float("inf"))
    i2 = torch.argmin(s, dim=1)
    v2 = s.gather(1, i2[:, None])[:, 0]
    return i1.to(torch.int32), v1, i2.to(torch.int32), v2


def argmin2_l2(q: torch.Tensor, dbp: torch.Tensor, dbn: torch.Tensor,
               q_split: bool = False, k_used: int = 0):
    """Per query row m: the two lexicographically smallest (score, index)
    pairs over DB rows n of  score = dbn[n] - 2 q[m].db[n]  (bf16 operands,
    fp32 accumulation; lowest index on ties).  ``dbn`` (Npad,) holds full
    row norms, +inf on padding rows, which lose every compare.  ``q`` as in
    ``pertile_champions``.  Returns (i1, v1, i2, v2), (M,) each; where no
    second row exists (a one-row DB) v2 is +inf and i2 names no real row.
    On the card it runs ``csrc/argmin2.cu`` on the Hopper core (``wgmma``
    on a TMA ring, the norms in the ring; launch plan ``_argmin2_plan``).
    """
    k_used = _check_bf16_scan("argmin2_l2", q, dbp, dbn, k_used)
    if _on_cpu(q, dbp, dbn):
        return argmin2_l2_plain(q, dbp, dbn, q_split, k_used)
    qk = _scan_queries(q, q_split).contiguous()
    _check_cuda("argmin2_l2", q=qk, dbp=dbp, dbn=dbn)
    m, fp = q.shape
    n = dbp.shape[0]
    dev = _device_index(qk)
    plan = _argmin2_plan(m, n, _sm_count(dev), k_used, q_split)
    lib = _build.load("argmin2")
    f32, i32 = torch.float32, torch.int32
    part = [torch.empty((plan.n_chunks, m), dtype=dt, device=qk.device)
            for dt in (f32, i32, f32, i32)]
    i1, i2 = (torch.empty((m,), dtype=i32, device=qk.device)
              for _ in range(2))
    v1, v2 = (torch.empty((m,), dtype=f32, device=qk.device)
              for _ in range(2))
    err = lib.ia_argmin2(
        qk.data_ptr(), dbp.data_ptr(), dbn.data_ptr(), m, n, fp, k_used,
        int(q_split), plan.consumers, plan.bm, plan.stages,
        plan.tiles_per_chunk, plan.smem, plan.n_chunks,
        *(t.data_ptr() for t in part), i1.data_ptr(), v1.data_ptr(),
        i2.data_ptr(), v2.data_ptr(), dev,
        torch.cuda.current_stream(qk.device).cuda_stream)
    _build.check(lib, err, "argmin2_l2 launch")
    LAUNCHES["argmin2_l2"] += 1
    return i1, v1, i2, v2


def prepadded_argmin2_queries(queries: torch.Tensor, dbp: torch.Tensor,
                              dbn: torch.Tensor, q_split: bool = False):
    """Raw-query wrapper of ``argmin2_l2``: lane-pad the (M, F) fp32
    queries and return (i1, i2, valid2) — valid2 is False where no second
    distinct row exists.  Scores are not returned: two-pass callers
    re-score both candidates in exact fp32."""
    f = queries.shape[1]
    i1, _, i2, v2 = argmin2_l2(_pad_lanes(queries, dbp.shape[1]), dbp, dbn,
                               q_split, _round_up(f, 16))
    return i1, i2, torch.isfinite(v2)
