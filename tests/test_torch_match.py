"""The port's matching kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the Pallas kernels
run in interpret mode, as tests/test_pallas_kernel.py runs them.  The same
NumPy-seeded inputs go to both.  tests/test_torch_cuda.py holds the CUDA
kernels against the same plain versions on the card.
"""

import dataclasses
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_analogies_tpu.config import PRESETS as JAX_PRESETS
from image_analogies_tpu.ops import features as jfeatures
from image_analogies_tpu.ops import pallas_match as pm
from image_analogies_tpu_torch import PRESETS
from image_analogies_tpu_torch.backends.cuda import pack_wk
from image_analogies_tpu_torch.ops import _build, match
from image_analogies_tpu_torch.ops.features import spec_for_level
from tests.test_torch_cuda import argmin_inputs, packed_inputs, query_rows
from tests.test_torch_wavefront import one_torch_thread  # noqa: F401

HIGHEST = jax.lax.Precision.HIGHEST


def _bf16_bits_from_jax(x):
    return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(
        torch.bfloat16)


def _bf16_bits(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("far", [False, True])
def test_argmin_plain_matches_pallas_interpret(far):
    q, db, dbn = argmin_inputs()
    n = 900
    if far:  # real rows far away: zero padding rows would win if unmasked
        db[:n] += 100.0
        dbn[:n] = (db[:n] ** 2).sum(1)
    m, f = q.shape
    qp = np.zeros((16, db.shape[1]), np.float32)
    qp[:m, :f] = q
    ref_i, ref_s = pm.pallas_argmin_l2_prepadded(
        jnp.asarray(qp), jnp.asarray(db), jnp.asarray(dbn[None, :]),
        tile_n=512, interpret=True, precision=HIGHEST)
    ref_i, ref_s = np.asarray(ref_i)[:m], np.asarray(ref_s)[:m]
    before = dict(match.LAUNCHES)
    idx, score = match.argmin_l2(torch.from_numpy(q), torch.from_numpy(db),
                                 torch.from_numpy(dbn))
    assert match.LAUNCHES == before  # CPU tensors: plain version, no launch
    assert idx.dtype == torch.int32 and score.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), ref_i)
    np.testing.assert_allclose(score.numpy(), ref_s, rtol=1e-5, atol=1e-5)
    assert idx.numpy().max() < n
    if not far:
        assert int(idx[0]) == 40  # duplicate tie -> lowest index


@pytest.mark.parametrize("n", [64, 99, 4096, 16384, 65000, 65536, 1048576])
@pytest.mark.parametrize("sm_count", [132, 114])
def test_argmin_plan_covers_every_tile_once(n, sm_count):
    """The fp32 argmin kernel's launch plan, M = 1..300: the DB chunks
    cover every 256-row tile exactly once and none is empty, the instance
    is the query bucket ceil(M / 8) while M fits one block (128 queries,
    fewer where the shared memory of a wide F caps it), the query chunks
    hold every query, and the grid stays within the launch limits and
    about one block per SM."""
    tiles = -(-n // match._ARGMIN_ROWS)
    for f in (68, 67, 300, 520):
        cap = max(nq for nq in range(1, 17)
                  if match._argmin_smem(f, nq) <= match._ARGMIN_SMEM)
        for m in range(1, 301):
            plan = match._argmin_plan(m, n, sm_count, f)
            per = plan.tiles_per_chunk
            assert plan.rows == match._ARGMIN_ROWS and per >= 1
            assert (plan.n_chunks - 1) * per < tiles <= plan.n_chunks * per
            assert 1 <= plan.nq <= cap and plan.q_chunks <= 65535
            assert 8 * plan.nq * plan.q_chunks >= m
            assert 8 * plan.nq * (plan.q_chunks - 1) < m  # no empty chunk
            if m <= 8 * cap:
                assert (plan.q_chunks, plan.nq) == (1, -(-m // 8))
            blocks = plan.n_chunks * plan.q_chunks
            assert blocks <= max(sm_count, plan.q_chunks)
            if n == 65536 and sm_count == 132 and m <= 128 and f == 68:
                assert (plan.n_chunks, per) == (128, 4)  # 4 tiles a block
    assert (cap, match._argmin_plan(88, 65536, 132, 68).nq) == (9, 11)
    with pytest.raises(ValueError):
        match._argmin_plan(8, n, sm_count, 8000)  # queries do not fit


def test_packed_plain_matches_pallas_interpret():
    """The plain packed scan against `packed2k_best(interpret=True)` on the
    same K-wide weight array, with padding rows (norm lanes -3e38) and
    duplicate rows."""
    x, q = packed_inputs()
    m, l = q.shape
    n, npad = x.shape[0], 1024
    nrm = (x.astype(np.float32) ** 2).sum(1)
    xt = torch.from_numpy(x)
    live = torch.arange(l)
    wk, dbnh = pack_wk(xt, torch.zeros(l), torch.from_numpy(0.5 * nrm),
                       live, npad)
    assert wk.shape == (npad, 256) and torch.isinf(dbnh[n:]).all()
    g1, g2, _ = pm.bf16_split3(jnp.asarray(q))
    q1, q2 = g1.astype(jnp.bfloat16), g2.astype(jnp.bfloat16)
    wk_j = jnp.asarray(_bf16_bits(wk)).view(jnp.bfloat16)
    ref_i, ref_v = pm.packed2k_best(q1, q2, wk_j, tile_n=256,
                                    interpret=True)
    ref_i, ref_v = np.asarray(ref_i), np.asarray(ref_v)

    qa = query_rows(_bf16_bits_from_jax(q1), _bf16_bits_from_jax(q2), 256)
    before = dict(match.LAUNCHES)
    idx, val = match.packed_best(qa, wk, k_used=224)
    assert match.LAUNCHES == before
    np.testing.assert_array_equal(idx.numpy(), ref_i)
    # the band tests/test_pallas_kernel.py holds packed2k_best to
    np.testing.assert_allclose(val.numpy(), ref_v, rtol=0, atol=5e-7)
    assert int(idx[2]) == 3 and idx.numpy().max() < n
    # the full-width product (k_used = K) gives the same picks: the
    # skipped lanes are zero
    idx_full, _ = match.packed_best(qa, wk)
    np.testing.assert_array_equal(idx_full.numpy(), ref_i)


@pytest.mark.parametrize("n", [64, 99, 4096, 4097, 65000, 65536, 262144,
                               1048000, 1048576])
@pytest.mark.parametrize("sm_count", [132, 114])
def test_packed2k_plan_covers_every_tile_once(n, sm_count):
    """The packed2k kernel's launch plan, M = 1..400: the DB chunks cover
    every 64-row tile exactly once and none is empty; three consumer
    warpgroups a block where a ring of two stages fits beside their
    resident queries, else two; the block's shared memory (those queries
    and the deepest ring that fits) stays within the card's 232,448 bytes;
    the fewest query tiles of at most 64 rows a warpgroup hold every query,
    as even as they come, none empty (the kernel skips a warpgroup with no
    row of its tile: the card tests at M 64/65/128/129/192/193 cover it);
    and the grid is about one block per SM."""
    tiles = -(-n // match._P2K_ROWS)
    for k_used in (224, 128, 96, 16, 512):
        nbox = -(-k_used // match._P2K_BOX)
        for m in range(1, 401):
            plan = match._packed2k_plan(m, n, sm_count, k_used)
            per = plan.tiles_per_chunk
            assert per >= 1
            assert (plan.n_chunks - 1) * per < tiles <= plan.n_chunks * per
            c = plan.consumers
            assert plan.smem == match._packed2k_smem(k_used, plan.stages, c)
            assert plan.smem + 1024 <= 232448
            assert plan.smem == 1024 + (c + plan.stages) * nbox * 4096
            assert 1 <= plan.stages <= 8
            assert (plan.stages == match._P2K_MAX_STAGES
                    or match._packed2k_smem(k_used, plan.stages + 1, c)
                    > match._P2K_SMEM)
            three = match._packed2k_smem(k_used, 2, 3) <= match._P2K_SMEM
            assert c == (3 if three else 2)
            bm = plan.bm
            assert plan.q_tiles == -(-m // (64 * c)) == -(-m // bm)
            assert bm <= 64 * c and (m - 1) // plan.q_tiles < bm
            assert plan.n_chunks * plan.q_tiles <= max(sm_count,
                                                       plan.q_tiles)
    # the widest level-0 batch, M = 344: two tiles of 172 rows (three
    # warpgroups each), 5 stages, 66 chunks of 249 tiles; level 1's M =
    # 176: one tile, 128 chunks of 32
    assert match._packed2k_plan(344, 1048576, 132, 224) == (
        3, 172, 5, 249, 66, 2, 230400)
    assert match._packed2k_plan(176, 262144, 132, 224)[:6] == (
        3, 176, 5, 32, 128, 1)
    assert match._packed2k_plan(48, 262144, 132, 224)[:5] == (
        3, 48, 5, 32, 128)
    # K = 512 lanes: two warpgroups, a ring of one stage
    assert match._packed2k_plan(8, n, sm_count, 512)[:3] == (2, 8, 1)
    with pytest.raises(ValueError):
        match._packed2k_plan(8, n, sm_count, 100)  # not a multiple of 16


@pytest.mark.parametrize("n", [1, 63, 64, 4096, 4097, 16384, 65536, 262144,
                               1048000, 1048576])
@pytest.mark.parametrize("sm_count", [132, 114, 1])
@pytest.mark.parametrize("fold", [False, True])
def test_argmin2_plan_covers_every_tile_once(n, sm_count, fold):
    """The argmin2 kernel's launch plan, M = 1..400 and k_used 16..512, hi
    and lo query blocks folded or not: DB tiles of 128 rows up to k_used =
    256, else 64; the DB chunks cover every tile exactly once and none is
    empty; the query tiles of at most 64 rows a warpgroup hold every query,
    as even as they come, none empty; the block's shared memory (the
    resident query blocks of 4 KiB a 32-lane box, the ring and 4 bytes of
    norms a tile row a stage) stays within the card's 232,448 bytes; the
    most consumer warpgroups (3, 2, 1) that keep a ring of two stages, else
    one; the ring the deepest that fits; and the grid about one block per
    SM."""
    qsets = 2 if fold else 1
    for k_used in (16, 80, 112, 224, 256, 272, 368, 384, 512):
        rows = 128 if k_used <= 256 else 64
        tiles = -(-n // rows)
        nbox = -(-k_used // 32)
        smem = lambda st, c: (1024 + c * qsets * nbox * 4096
                              + st * (nbox * rows * 64 + 4 * rows))
        for m in range(1, 401):
            plan = match._argmin2_plan(m, n, sm_count, k_used, fold)
            per = plan.tiles_per_chunk
            assert per >= 1
            assert (plan.n_chunks - 1) * per < tiles <= plan.n_chunks * per
            c, st = plan.consumers, plan.stages
            assert plan.smem == smem(st, c)
            assert plan.smem + 1024 <= 232448
            assert 1 <= st <= 8
            assert st == 8 or smem(st + 1, c) > 232448 - 1024
            two = [cc for cc in (3, 2, 1) if smem(2, cc) <= 232448 - 1024]
            assert c == (two[0] if two else 1)
            bm = plan.bm
            assert plan.q_tiles == -(-m // (64 * c)) == -(-m // bm)
            assert bm <= 64 * c and (m - 1) // plan.q_tiles < bm
            assert plan.n_chunks * plan.q_tiles <= max(sm_count,
                                                       plan.q_tiles)
    # level 0 of two_pass at the widest batch (M = 344, 80 lanes, hi/lo):
    # two query tiles of 172 rows on three warpgroups, a ring of 6 stages
    # of 128 DB rows, 66 chunks of 125 tiles; the headline M = 352 the same
    # with 176 rows
    assert match._argmin2_plan(344, 1048576, 132, 80, True) == (
        3, 172, 6, 125, 66, 2, 225280)
    assert match._argmin2_plan(352, 1048576, 132, 80, True)[:3] == (
        3, 176, 6)
    # the widest lanes the wrapper takes, folded: one warpgroup, one stage
    assert match._argmin2_plan(45, n, sm_count, 512, True)[:3] == (1, 45, 1)
    with pytest.raises(ValueError):
        match._argmin2_plan(8, n, sm_count, 100, fold)  # not a multiple of 16


def _bf16_scan_smem(k_used, stages, consumers):
    """The argmin_l2_bf16 block's shared memory (one query set, the norms
    in the ring): 1 KiB of slack, 4 KiB a 32-lane query box a warpgroup,
    and a stage of DB tiles of 128 rows up to k_used = 256, else 64."""
    rows = 128 if k_used <= 256 else 64
    nbox = -(-k_used // 32)
    return (1024 + consumers * nbox * 4096
            + stages * (nbox * rows * 64 + 4 * rows))


@pytest.mark.parametrize("n", [1, 63, 64, 128, 4096, 4097, 16384, 65536,
                               262144, 1048000, 1048576])
@pytest.mark.parametrize("sm_count", [132, 114, 1])
def test_argmin_bf16_plan_covers_every_tile_once(n, sm_count):
    """The argmin_l2_bf16 kernel's launch plan, M = 1..1,100 and k_used
    16..512: DB tiles of 128 rows up to k_used = 256, else 64; the DB
    chunks cover every tile exactly once and none is empty; the query
    tiles of at most 64 rows a warpgroup hold every query, as even as they
    come, none empty; the block's shared memory within the card's 232,448
    bytes, the most consumer warpgroups (3, 2, 1) that keep a ring of two
    stages, the ring the deepest that fits; and the grid about one block
    per SM."""
    limit = 232448 - 1024
    for k_used in (16, 64, 80, 112, 256, 272, 368, 464, 512):
        rows = 128 if k_used <= 256 else 64
        tiles = -(-n // rows)
        smem = lambda st, c: _bf16_scan_smem(k_used, st, c)
        for m in (*range(1, 400, 7), 64, 65, 128, 171, 192, 193, 512, 1024,
                  1100):
            plan = match._argmin_bf16_plan(m, n, sm_count, k_used)
            per = plan.tiles_per_chunk
            assert per >= 1
            assert (plan.n_chunks - 1) * per < tiles <= plan.n_chunks * per
            covered = [0] * tiles
            for chunk in range(plan.n_chunks):
                for t in range(chunk * per, min(tiles, (chunk + 1) * per)):
                    covered[t] += 1
            assert covered == [1] * tiles
            c, st = plan.consumers, plan.stages
            assert plan.smem == smem(st, c) <= limit
            assert 1 <= st <= 8 and (st == 8 or smem(st + 1, c) > limit)
            assert c == next(cc for cc in (3, 2, 1) if smem(2, cc) <= limit)
            bm = plan.bm
            assert plan.q_tiles == -(-m // (64 * c)) == -(-m // bm)
            assert bm <= 64 * c and (m - 1) // plan.q_tiles < bm
            assert plan.n_chunks * plan.q_tiles <= max(sm_count,
                                                       plan.q_tiles)
    with pytest.raises(ValueError):
        match._argmin_bf16_plan(8, n, sm_count, 100)  # not a multiple of 16


def test_argmin_bf16_plan_headline_and_levels():
    """The argmin_l2_bf16 plans of batched npr_1024's five levels on 132
    SMs are pinned: level 0 (one 1,024-pixel scan row against N = 2^20 at
    80 lanes) six query tiles of 171 rows on three warpgroups, a ring of
    7 stages of 128 DB rows, 22 chunks of 373 tiles (132 blocks); levels
    1-3 three, two and one query tiles; level 4 (F = 50: 64 lanes) one
    tile of 64 rows, 8 stages, one DB tile a block."""
    plan = lambda m, n, k: tuple(match._argmin_bf16_plan(m, n, 132, k))
    assert plan(1024, 1048576, 80) == (3, 171, 7, 373, 22, 6, 213504)
    assert plan(512, 262144, 80) == (3, 171, 7, 47, 44, 3, 213504)
    assert plan(256, 65536, 80) == (3, 128, 7, 8, 64, 2, 213504)
    assert plan(128, 16384, 80) == (3, 128, 7, 1, 128, 1, 213504)
    assert plan(64, 4096, 64) == (3, 64, 8, 1, 32, 1, 160768)


@pytest.mark.parametrize("k_used", range(16, 513, 16))
def test_argmin_bf16_plan_fits_every_width(k_used):
    """At every k_used the wrapper takes (16 to 512 in steps of 16) a plan
    exists whose block fits the card's shared memory with a ring of two
    stages or more: three warpgroups up to 352 lanes, two to 448, one past
    them (one query set of 64 rows beside 64-row tiles of 1 KiB)."""
    for m, n in ((1, 64), (1024, 1048576), (513, 99)):
        plan = match._argmin_bf16_plan(m, n, 132, k_used)
        assert plan.smem == _bf16_scan_smem(k_used, plan.stages,
                                            plan.consumers)
        assert plan.smem <= 232448 - 1024 and plan.stages >= 2
        assert plan.consumers == (3 if k_used <= 352 else
                                  2 if k_used <= 448 else 1)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k_used,fp", [(80, 128), (16, 128), (256, 256),
                                       (272, 384)])
def test_argmin_l2_bf16_cpu_runs_the_plain_version(qdtype, k_used, fp):
    """On CPU tensors ``argmin_l2_bf16`` is its plain version and counts no
    launch: fp32 queries are rounded to bf16 to nearest (as the card's
    entry rounds them), so they give the bf16 queries' picks and scores;
    duplicate rows go to the lower index and padding rows never win."""
    rng = np.random.default_rng(k_used + fp)
    n, npad, f = 300, 320, k_used - 5
    db = np.zeros((npad, fp), np.float32)
    db[:n, :f] = rng.standard_normal((n, f)).astype(np.float32)
    db[250] = db[7]
    dbp = torch.from_numpy(db).to(torch.bfloat16)
    dbn = torch.full((npad,), float("inf"))
    dbn[:n] = torch.from_numpy((db[:n] ** 2).sum(1))
    q = torch.zeros((9, fp))
    q[:, :f] = torch.from_numpy(rng.standard_normal((9, f)).astype(
        np.float32))
    q[0] = dbp[7].float()
    match.reset_launch_counts()
    idx, val = match.argmin_l2_bf16(q.to(qdtype), dbp, dbn, k_used)
    assert sum(match.LAUNCHES.values()) == 0
    ref_i, ref_v = match.argmin_l2_bf16_plain(q.to(torch.bfloat16), dbp, dbn,
                                              k_used)
    assert torch.equal(idx, ref_i) and torch.equal(val, ref_v)
    assert idx.dtype == torch.int32 and int(idx[0]) == 7
    assert int(idx.max()) < n
    # the plain version's own scores: dbn - 2 q.db over k_used lanes
    s = dbn[None, :] - 2.0 * (q.to(torch.bfloat16).float()[:, :k_used]
                              @ dbp[:, :k_used].float().T)
    assert torch.equal(idx.long(), torch.argmin(s, dim=1))


@pytest.mark.parametrize("n", [4096, 65536, 1048576])
@pytest.mark.parametrize("tile_n", [64, 128, 256, 1024, 4096])
@pytest.mark.parametrize("sm_count", [132, 1])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("k_used", [80, 256, 272, 512])
def test_pertile_plan_covers_every_tile_once(n, tile_n, sm_count, fold,
                                             k_used):
    """The pertile kernel's launch plan, M = 1..400: DB tiles of 128 rows
    where the scan tile is a multiple of 128 rows and k_used <= 256, else
    64; chunks of whole output tiles (a scan tile, or one of its ``parts``,
    a power of two of at least 2 DB tiles, only where the scan tiles alone
    leave SMs idle), so every DB tile is covered by exactly one block and
    every (scan tile, query row) written once, none of them empty; the
    query tiles and the ring as ``_hopper_plan`` (norms in the ring, hi/lo
    rows resident with ``fold``), the block's shared memory within the
    card's 232,448 bytes; and the grid about one block per SM."""
    qsets = 2 if fold else 1
    rows = 128 if tile_n % 128 == 0 and k_used <= 256 else 64
    sub = tile_n // rows
    ntiles = n // tile_n
    tiles = n // rows
    nbox = -(-k_used // 32)
    smem = lambda st, c: (1024 + c * qsets * nbox * 4096
                          + st * (nbox * rows * 64 + 4 * rows))
    for m in (1, 2, 24, 48, 63, 64, 65, 88, 128, 176, 192, 193, 344, 352,
              400):
        plan = match._pertile_plan(m, n, sm_count, k_used, fold, tile_n)
        assert plan.rows == rows == match._pertile_rows(tile_n, k_used)
        parts, per = plan.parts, plan.tiles_per_chunk
        unit = sub // parts  # DB tiles an output tile
        assert parts >= 1 and parts & (parts - 1) == 0 and sub % parts == 0
        assert parts == 1 or unit >= match._PT_MIN_PART
        # whole output tiles a chunk; the chunks cover every DB tile once
        assert per >= unit and per % unit == 0
        assert (plan.n_chunks - 1) * per < tiles <= plan.n_chunks * per
        covered = [0] * tiles
        for chunk in range(plan.n_chunks):
            for t in range(chunk * per, min(tiles, (chunk + 1) * per)):
                covered[t] += 1
        assert covered == [1] * tiles
        # every output tile (scan tile part) written by one block
        writers = {}
        for chunk in range(plan.n_chunks):
            for t in range(chunk * per, min(tiles, (chunk + 1) * per)):
                if (t + 1) % unit == 0:
                    writers[t // unit] = writers.get(t // unit, 0) + 1
        assert writers == {u: 1 for u in range(ntiles * parts)}
        c, st = plan.consumers, plan.stages
        assert plan.smem == smem(st, c) and plan.smem + 1024 <= 232448
        assert 1 <= st <= 8
        assert st == 8 or smem(st + 1, c) > 232448 - 1024
        bm = plan.bm
        assert plan.q_tiles == -(-m // (64 * c)) == -(-m // bm)
        assert bm <= 64 * c and (m - 1) // plan.q_tiles < bm
        room = max(1, sm_count // plan.q_tiles)
        assert plan.n_chunks <= max(room, ntiles)
        # split only where the whole scan tiles leave SMs idle, and then no
        # further than the card holds
        if parts > 1:
            assert ntiles < room and ntiles * parts <= room
        else:
            assert (ntiles * 2 > room or sub % 2
                    or sub // 2 < match._PT_MIN_PART)
        # parts forced: whole scan tiles, or the rule's own choice
        whole = match._pertile_plan(m, n, sm_count, k_used, fold, tile_n,
                                    parts=1)
        assert whole.parts == 1 and whole.tiles_per_chunk % sub == 0
        assert whole[:3] == plan[:3]
        assert plan == match._pertile_plan(m, n, sm_count, k_used, fold,
                                           tile_n, parts=parts)
    # the headline (scan_rescue at level 0 of npr_1024: M = 352 as hi/lo
    # rows, N = 2^20, 80 lanes, scan tile 4,096): two query tiles of 176
    # rows on three warpgroups, a ring of 6 stages of 128 DB rows, 64
    # chunks of 4 scan tiles (128 DB tiles), each champion in place; level
    # 2's widest segment (M = 88, N = 65,536: 16 scan tiles) in 8 parts of
    # 4 DB tiles; the other levels' widest: level 1 in 2 parts, level 3 in
    # 4 of 2 DB tiles, level 4 (scan tiles of 2 DB tiles) in place
    assert match._pertile_plan(352, 1048576, 132, 80, True, 4096) == (
        3, 176, 6, 128, 64, 2, 225280, 128, 1)
    assert match._pertile_plan(88, 65536, 132, 80, True, 4096)[3:] == (
        4, 128, 1, 225280, 128, 8)
    assert [match._pertile_plan(m_, n_, 132, 80, True, t_).parts
            for m_, n_, t_ in ((176, 262144, 4096), (48, 16384, 1024),
                               (24, 4096, 256))] == [2, 4, 1]
    for bad in (32, 96):  # below 64 rows; not dividing N
        with pytest.raises(ValueError):
            match._pertile_plan(8, n, sm_count, k_used, fold, bad)
    with pytest.raises(ValueError):  # parts not dividing the scan tile
        match._pertile_plan(8, n, sm_count, k_used, fold, tile_n, 3 * sub)


@pytest.mark.parametrize("n", [64, 99, 4096, 4097, 65536, 262144, 1048000,
                               1048576])
@pytest.mark.parametrize("sm_count", [132, 114])
def test_packed3_plan_covers_every_tile_once(n, sm_count):
    """The packed3 kernel's launch plan, M = 1..400 at the lane widths
    exact_hi2 scans (112: luminance; up to 256: RGB sources): the DB chunks
    cover every 64-row tile exactly once and none is empty; the query tiles of at
    most 64 rows a warpgroup hold every query, as even as they come, none
    empty; the block's shared memory (three resident query sets of 4 KiB a
    32-lane box per warpgroup, and a ring whose stages hold a W1 and a W2
    tile and 4 bytes of norms a tile row) stays within the card's 232,448
    bytes with the deepest ring that fits; the most consumer warpgroups
    (3, 2, 1) that keep a ring of two stages; and the grid about one block
    per SM."""
    for k_used in (112, 128, 160, 256):
        nbox = -(-k_used // 32)
        tiles = -(-n // 64)
        smem = lambda st, c: (1024 + c * 3 * nbox * 4096
                              + st * (2 * nbox * 64 * 64 + 4 * 64))
        for m in range(1, 401):
            plan = match._packed3_plan(m, n, sm_count, k_used)
            per = plan.tiles_per_chunk
            assert per >= 1
            assert (plan.n_chunks - 1) * per < tiles <= plan.n_chunks * per
            c, st = plan.consumers, plan.stages
            assert plan.smem == smem(st, c)
            assert plan.smem + 1024 <= 232448
            assert 2 <= st <= 8
            assert st == 8 or smem(st + 1, c) > 232448 - 1024
            two = [cc for cc in match._P3_CONSUMERS
                   if smem(2, cc) <= 232448 - 1024]
            assert c == two[0]
            bm = plan.bm
            assert plan.q_tiles == -(-m // (64 * c)) == -(-m // bm)
            assert bm <= 64 * c and (m - 1) // plan.q_tiles < bm
            assert plan.n_chunks * plan.q_tiles <= max(sm_count,
                                                       plan.q_tiles)
    with pytest.raises(ValueError):
        match._packed3_plan(8, n, sm_count, 272)  # past the Hopper kernel


def test_packed3_plan_headline_and_route():
    """The headline packed3 plan (exact_hi2 at level 0 of npr_1024: M =
    352, N = 2^20, 2L = 110 lanes used as 112, 132 SMs) is pinned; at 256
    lanes (RGB sources) one warpgroup keeps a ring of two stages; the width
    rule sends every k_used up to 256 to the Hopper core and the wider
    ones to packed3w_best.cu."""
    assert match._packed3_plan(352, 1048576, 132, 112) == (
        3, 176, 2, 249, 66, 2, 214528)
    assert match._packed3_plan(352, 1048576, 132, 256)[:4] == (1, 59, 2, 745)
    for k_used in range(16, 513, 16):
        assert match._packed3_route(k_used) == (
            "packed3_best" if k_used <= 256 else "packed3w_best")


def test_packed3w_plan_headline():
    """The packed3 plans past 256 lanes at M = 352, N = 2^20 on 132 SMs are
    pinned: at 304 lanes (the video preset's block on RGB sources), 384 and
    416 (super_resolution on RGB sources) two sets a warpgroup in registers
    and two warpgroups a block (three query tiles of 118 rows), 32-row DB
    tiles in a ring of three or two stages; at 512 one set and one
    warpgroup (six query tiles), a single 32-row stage."""
    plan = lambda k: tuple(match._packed3w_plan(352, 1048576, 132, k))
    assert plan(304) == (2, 118, 3, 745, 44, 3, 206208, 32, 2)
    assert plan(384) == (2, 118, 2, 745, 44, 3, 197888, 32, 2)
    assert plan(416) == (2, 118, 2, 745, 44, 3, 214272, 32, 2)
    assert plan(512) == (1, 59, 1, 1490, 22, 6, 197760, 32, 1)
    for k_used in (256, 528):  # the Hopper core's widths; past 512
        with pytest.raises(ValueError):
            match._packed3w_plan(352, 1048576, 132, k_used)


@pytest.mark.parametrize("k_used", range(272, 513, 16))
@pytest.mark.parametrize("n", [64, 99, 65536, 1048000, 1048576])
def test_packed3w_plan_fits_every_width(k_used, n):
    """At every k_used past 256 (272 to 512 in steps of 16) and M = 1..400
    on 132 and 114 SMs: the block's shared memory (1 KiB of slack, 3 -
    reg_sets query sets of 4 KiB a 32-lane box per warpgroup, a ring whose
    stages hold a W1 and a W2 tile and 4 bytes of norms a tile row) stays
    within the card's 232,448 - 1,024 bytes with the deepest ring that
    fits; the ring keeps two stages or more up to 448 lanes, and past 448
    (one query set of 64 rows in shared memory beside 32-row tiles of
    480-512 bytes a stream) takes a single stage; two sets in registers
    and two warpgroups up to 416 lanes (26 k steps), one past them; 64-row
    DB tiles at 272 and 288 lanes, 32-row ones above; the DB chunks cover
    every tile exactly once and none is empty; the query tiles hold every
    query, as even as they come; the grid about one block per SM."""
    nbox = -(-k_used // 32)
    reg, cmax, rows = match._packed3w_layout(k_used)
    assert (reg, cmax) == ((2, 2) if k_used <= 416 else (1, 1))
    assert rows == (64 if k_used <= 288 else 32)
    smem = lambda st, c: (1024 + c * (3 - reg) * nbox * 4096
                          + st * (2 * nbox * rows * 64 + 4 * rows))
    tiles = -(-n // rows)
    for sm_count in (132, 114):
        for m in (*range(1, 401, 9), 64, 128, 129, 352):
            plan = match._packed3w_plan(m, n, sm_count, k_used)
            assert (plan.rows, plan.reg_sets) == (rows, reg)
            c, st = plan.consumers, plan.stages
            assert c == cmax
            assert plan.smem == smem(st, c) <= 232448 - 1024
            assert st == 8 or smem(st + 1, c) > 232448 - 1024
            assert st >= 2 if k_used <= 448 else st == 1
            per = plan.tiles_per_chunk
            assert (plan.n_chunks - 1) * per < tiles <= plan.n_chunks * per
            bm = plan.bm
            assert plan.q_tiles == -(-m // (64 * c)) == -(-m // bm)
            assert bm <= 64 * c and (m - 1) // plan.q_tiles < bm
            assert plan.n_chunks * plan.q_tiles <= max(sm_count,
                                                       plan.q_tiles)


@pytest.mark.parametrize("preset,temporal,width", [
    ("super_resolution", False, 207), ("video", True, 148)])
def test_rgb_presets_reach_packed3w(preset, temporal, width):
    """exact_hi2 on RGB sources (``color_mode="source_rgb"``, three source
    channels) scans 2L lanes at level 0: L = 207 at super_resolution's
    patch 7, L = 148 at the video preset's patch 5 with the temporal block
    (the port's own ``spec_for_level``, live query dims as the JAX
    package's ``query_live_mask``); both widths go to packed3w_best.cu, on
    Kp = 512 and 384 lanes."""
    params = dataclasses.replace(PRESETS[preset], match_mode="exact_hi2",
                                 color_mode="source_rgb")
    spec = spec_for_level(params, 0, params.levels, 3, temporal=temporal)
    live = int(spec.query_live_mask().sum())
    jspec = jfeatures.spec_for_level(
        dataclasses.replace(JAX_PRESETS[preset], match_mode="exact_hi2",
                            color_mode="source_rgb"), 0, params.levels, 3,
        temporal=temporal)
    assert live == width == int(np.asarray(jspec.query_live_mask()).sum())
    k_used = (2 * live + 15) // 16 * 16
    assert match._packed3_route(k_used) == "packed3w_best"
    assert max(-(-2 * live // 128) * 128, 128) == (512 if live > 192
                                                   else 384)
    match._packed3w_plan(352, 1048576, 132, k_used)


# query counts of the new plans' tests: one, every warpgroup edge, the
# wavefront's widest batches, and past three query tiles of 192 rows
_PLAN_MS = (1, 2, 63, 64, 65, 128, 129, 191, 192, 193, 344, 352, 400, 577,
            1024, 1100)
_SMEM_MAX = 232448 - 1024


def _core_smem(k_used, stages, consumers, qsets, streams, norms, rows):
    """The kernel's ``smem_bytes``: slack, the resident query sets, the
    ring."""
    nbox = -(-k_used // 32)
    return (1024 + consumers * qsets * nbox * 4096
            + stages * (streams * nbox * rows * 64 + (4 * rows if norms
                                                      else 0)))


def _assert_core_plan(plan, m, n, sm_count, k_used, qsets, streams, norms,
                      rows, choices=(3, 2, 1)):
    """The warpgroups, query tiles and ring of a Hopper-core plan: the most
    consumer warpgroups of ``choices`` that keep a ring of two stages, else
    the fewest; the deepest ring within the shared memory; the fewest,
    evenest query tiles of at most 64 rows a warpgroup."""
    c, st = plan.consumers, plan.stages
    assert plan.smem == _core_smem(k_used, st, c, qsets, streams, norms,
                                   rows) <= _SMEM_MAX
    assert 1 <= st <= 8
    assert st == 8 or _core_smem(k_used, st + 1, c, qsets, streams, norms,
                                 rows) > _SMEM_MAX
    two = [cc for cc in choices
           if _core_smem(k_used, 2, cc, qsets, streams, norms,
                         rows) <= _SMEM_MAX]
    assert c == (two[0] if two else choices[-1])
    bm = plan.bm
    assert plan.q_tiles == -(-m // (64 * c)) == -(-m // bm)
    assert bm <= 64 * c and (m - 1) // plan.q_tiles < bm


@pytest.mark.parametrize("form", ["packed2_best", "packed1w_best",
                                  "packed2wn_best", "packed1wn_best"])
@pytest.mark.parametrize("sm_count", [132, 114, 1])
def test_packed_form_plans_cover_every_tile_once(form, sm_count):
    """The launch plan of each superseded packed form on the core, at every
    k_used 16-512 and M 1-1,100: two query sets a warpgroup, the half
    norms in the ring but for the norm-in-W forms, DB tiles of 64 rows, 32
    for the two-stream forms past 448 lanes (two sets beside one 64-row
    stage of both streams do not fit); the DB chunks cover every tile
    exactly once, none empty; the warpgroups, query tiles and ring as
    ``_hopper_plan`` chooses them within the card's shared memory; about
    one block per SM."""
    streams = 2 if form in ("packed2_best", "packed2wn_best") else 1
    norms = form in ("packed2_best", "packed1w_best")
    for k_used in range(16, 513, 16):
        rows = match._core_rows(k_used, 2, streams, norms)
        assert rows == (32 if streams == 2 and k_used > 448 else 64)
        for n in (1, 63, 64, 4097, 65536, 1048576):
            tiles = -(-n // rows)
            for m in _PLAN_MS:
                plan = match._packed_form_plan(form, m, n, sm_count, k_used)
                per = plan.tiles_per_chunk
                assert per >= 1
                assert (plan.n_chunks - 1) * per < tiles <= (plan.n_chunks
                                                             * per)
                _assert_core_plan(plan, m, n, sm_count, k_used, 2, streams,
                                  norms, rows)
                assert plan.n_chunks * plan.q_tiles <= max(sm_count,
                                                           plan.q_tiles)
    with pytest.raises(ValueError):
        match._packed_form_plan(form, 8, 4096, sm_count, 100)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("sm_count", [132, 114, 1])
def test_champions_plan_covers_every_tile_once(fold, sm_count):
    """The per-tile champions' launch plan at every k_used 16-512, M
    1-1,100 and output tiles of 64 to 4,096 rows: on the core (folded up to
    256 lanes) three or two query sets, a ring stage of both streams and
    their norms, 64-row DB tiles (32 unfolded past 448 lanes); folded past
    256 lanes packed3w_best.cu's layout (``_packed3w_plan``).  Chunks of
    whole output tiles cover every DB tile exactly once, none empty, so
    each (output tile, query row) is written by one block; about one block
    per SM."""
    for k_used in range(16, 513, 16):
        wide = fold and k_used > 256
        assert match._champions_route(k_used, fold) == (
            "packed3w_best" if wide else "tile_champions")
        rows = (match._packed3w_layout(k_used)[2] if wide
                else match._core_rows(k_used, 3 if fold else 2, 2, True))
        assert rows == (match._packed3w_layout(k_used)[2] if wide
                        else 32 if k_used > 448 else 64)
        for n, tile in ((64, 64), (4096, 256), (65536, 4096),
                        (1048576, 4096), (69632, 4096)):
            sub = tile // rows
            tiles = n // rows
            for m in _PLAN_MS:
                plan = match._champions_plan(m, n, sm_count, k_used, fold,
                                             tile)
                per = plan.tiles_per_chunk
                assert (plan.rows, plan.parts) == (rows, 1)
                assert per >= sub and per % sub == 0
                assert (plan.n_chunks - 1) * per < tiles <= (plan.n_chunks
                                                             * per)
                writers = {}
                for chunk in range(plan.n_chunks):
                    for t in range(chunk * per, min(tiles, (chunk + 1) * per)):
                        if (t + 1) % sub == 0:
                            writers[t // sub] = writers.get(t // sub, 0) + 1
                assert writers == {u: 1 for u in range(n // tile)}
                if wide:
                    p3w = match._packed3w_plan(m, n, sm_count, k_used)
                    keep = ("consumers", "bm", "stages", "q_tiles", "smem")
                    assert [getattr(plan, f) for f in keep] == [
                        getattr(p3w, f) for f in keep]
                else:
                    _assert_core_plan(plan, m, n, sm_count, k_used,
                                      3 if fold else 2, 2, True, rows)
                room = max(1, sm_count // plan.q_tiles)
                assert plan.n_chunks <= max(room, n // tile)
    with pytest.raises(ValueError):  # not a multiple of 64; not dividing N
        match._champions_plan(8, 4096, sm_count, 112, fold, 96)
    with pytest.raises(ValueError):
        match._champions_plan(8, 4096, sm_count, 112, fold, 8192)


def test_core_rows_change_only_two_sets_two_streams_past_448():
    """The core's tile-row rule (the kernel's ``tile_rows``) gives 32 rows
    only to two query sets against two weight streams past 448 lanes (the
    packed2 forms and the unfolded champions), and at every width the rows
    the existing instances run: packed2k 64; argmin2 and argmin_l2_bf16
    (``_argmin2_rows``); pertile (``_pertile_rows``); packed3 64."""
    for k_used in range(16, 513, 16):
        for qsets, streams in ((1, 1), (2, 1), (2, 2), (3, 2)):
            if qsets == 3 and k_used > 256:
                continue  # packed3's widths past 256 are packed3w_best.cu's
            for norms in (False, True):
                assert match._core_rows(k_used, qsets, streams, norms) == (
                    32 if (qsets, streams) == (2, 2) and k_used > 448
                    else 64)
        assert match._core_rows(k_used, 1, 1, False) == 64  # packed2k
        for qsets in (1, 2):  # argmin2 unfolded / folded, argmin_l2_bf16
            assert match._core_rows(k_used, qsets, 1, True, wide=True) == \
                match._argmin2_rows(k_used)
            for tile in (64, 128, 192, 4096):
                assert match._core_rows(k_used, qsets, 1, True,
                                        wide=tile % 128 == 0) == \
                    match._pertile_rows(tile, k_used)


def test_kernel_sources_are_the_hopper_core_and_their_entries():
    """No kernel source includes the first-design template or issues its
    ``mma.sync`` scan; every source is built and every built library's C
    entries exist in its source with the argument kinds ctypes passes (a
    pointer for each ``void*``, an int for each ``int``)."""
    csrc = _build.CSRC_DIR
    names = sorted(os.listdir(csrc))
    assert "bf16_scan.cuh" not in names
    for fname in names:
        text = open(os.path.join(csrc, fname)).read()
        assert "bf16_scan.cuh" not in text, fname
        assert "mma.sync.aligned.m16n8k16" not in text, fname
    assert sorted(f[:-3] for f in names if f.endswith(".cu")) == sorted(
        _build.KERNEL_SOURCES)
    for lib, entries in _build._SIGNATURES.items():
        text = open(os.path.join(csrc, f"{lib}.cu")).read()
        for fn, argtypes in entries.items():
            found = re.search(r"\bint " + fn + r"\(([^)]*)\)", text)
            assert found, (lib, fn)
            params = [p.strip() for p in found.group(1).split(",")]
            kinds = [_build._VOIDP if "*" in p else _build._INT
                     for p in params]
            assert kinds == argtypes, (lib, fn)


def test_form_query_rows_need_no_copy():
    """The two-stream forms' wrappers build qa and qb as adjacent blocks of
    one tensor (``_row_blocks``), which the card kernels read as their one
    query operand without a copy (``_query_operand``); apart, the operand
    is their concatenation."""
    g = torch.Generator().manual_seed(4)
    q1, q2 = (torch.randn((6, 9), generator=g).to(torch.bfloat16)
              for _ in range(2))
    q = match._row_blocks([(q1, q1), (q2, q1)], 128)
    assert q.shape == (12, 128) and q.is_contiguous()
    assert torch.equal(q.view(torch.int16), torch.cat([
        match._pack_rows(q1, q1, 128),
        match._pack_rows(q2, q1, 128)]).view(torch.int16))
    qa, qb = q[:6], q[6:]
    assert match._query_operand(qa, qb) is qa
    assert match._query_operand(qa, None) is qa
    apart = match._query_operand(qa, qb.clone())
    assert apart.data_ptr() != qa.data_ptr()
    assert torch.equal(apart.view(torch.int16), q.view(torch.int16))


def test_packed3_rows_are_one_tensor():
    """The packed3 query operands are adjacent views of one (3M, K) tensor
    (so the card kernel reads them without a copy), with the rows of the
    first design's concatenation."""
    g = torch.Generator().manual_seed(2)
    q1, q2, q3 = (torch.randn((5, 11), generator=g).to(torch.bfloat16)
                  for _ in range(3))
    qa, qb = match._packed3_rows(q1, q2, q3, 128)
    assert qa.shape == (10, 128) and qb.shape == (5, 128)
    assert qa.is_contiguous() and qb.is_contiguous()
    assert qb.data_ptr() == qa.data_ptr() + qa.numel() * 2
    want = torch.cat([match._pack_rows(q1, q1, 128),
                      match._pack_rows(q2, q2, 128),
                      match._pack_rows(q1, q3, 128)])
    assert torch.equal(torch.cat([qa, qb]).view(torch.int16),
                       want.view(torch.int16))


def test_bf16_split3_and_norm_lanes_bit_equal():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.standard_normal(500).astype(np.float32),
        (rng.standard_normal(100) * 1e-20).astype(np.float32),
        # (no denormal inputs or remainders: XLA's CPU runtime flushes
        # them to zero)
        np.array([0.0, -0.0, 1.0, -3e38, 3.4e38], np.float32)])
    for got, want in zip(match.bf16_split3(torch.from_numpy(x)),
                         pm.bf16_split3(jnp.asarray(x))):
        assert np.array_equal(got.numpy().view(np.uint32),
                              np.asarray(want).view(np.uint32))
    npad, kp, l = 64, 128, 20
    dbnh = np.abs(rng.standard_normal(npad)).astype(np.float32)
    dbnh[50:] = np.inf
    w0 = np.zeros((npad, kp), np.float32)
    want = pm.add_norm_lanes(jnp.asarray(w0).astype(jnp.bfloat16),
                             jnp.asarray(dbnh), l)
    got = match.add_norm_lanes(torch.zeros((npad, kp), dtype=torch.bfloat16),
                               torch.from_numpy(dbnh), l)
    assert np.array_equal(_bf16_bits(got), np.asarray(want).view(np.int16))
    # padding rows carry finite, hugely negative norm lanes
    assert torch.isfinite(got[50:].float()).all()
    assert float(got[50:, 2 * l:2 * l + 3].float().sum(1).max()) < -1e38


def test_wrappers_check_their_operands():
    q = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        match.argmin_l2(q.double(), torch.zeros((16, 8)), torch.zeros(16))
    with pytest.raises(ValueError):
        match.argmin_l2(q, torch.zeros((16, 4)), torch.zeros(16))
    qa = torch.zeros((4, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        match.packed_best(qa, torch.zeros((8, 200), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        match.packed_best(qa, torch.zeros((8, 256), dtype=torch.bfloat16),
                          k_used=100)
    with pytest.raises(ValueError):
        match.packed_best(qa.float(), torch.zeros((8, 256)))


# ------------------------------------------- packed2k past 512 lanes


@pytest.mark.parametrize("l", [148, 171, 207, 240, 256, 280])
def test_packed_plain_past_512_lanes_matches_pallas_interpret(l):
    """The plain packed2k scan at K = 640-1,152 (L = 148: 608 used lanes,
    RGB sources with the temporal block; 171 and 207: 688 and 832, RGB
    super-resolution's two levels; 256: 1,040, the same with the temporal
    block) against ``packed2k_best(interpret=True)`` on the same K-wide
    weight array, padding and duplicate rows included.  The wrapper takes
    these widths on the CPU (it used to refuse K past 512), and the
    width rule sends them past 512 lanes to packed2kw_best.cu on the
    card."""
    x, q = packed_inputs(m=21, l=l, n=900, dup=(3, 700))
    n, npad = x.shape[0], 1024
    nrm = (x.astype(np.float32) ** 2).sum(1)
    xt = torch.from_numpy(x)
    wk, _ = pack_wk(xt, torch.zeros(l), torch.from_numpy(0.5 * nrm),
                    torch.arange(l), npad)
    kp = wk.shape[1]
    k_used = (4 * l + 3 + 15) // 16 * 16
    assert kp == -(-(4 * l + 3) // 128) * 128 and 640 <= kp <= 1152
    assert match._packed2k_route(k_used) == "packed2kw_best"
    g1, g2, _ = pm.bf16_split3(jnp.asarray(q))
    q1, q2 = g1.astype(jnp.bfloat16), g2.astype(jnp.bfloat16)
    wk_j = jnp.asarray(_bf16_bits(wk)).view(jnp.bfloat16)
    ref_i, ref_v = pm.packed2k_best(q1, q2, wk_j, tile_n=256, interpret=True)
    qa = query_rows(_bf16_bits_from_jax(q1), _bf16_bits_from_jax(q2), kp)
    before = dict(match.LAUNCHES)
    idx, val = match.packed_best(qa, wk, k_used)
    assert match.LAUNCHES == before
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(val.numpy(), np.asarray(ref_v), rtol=0,
                               atol=2e-6)
    assert int(idx[2]) == 3 and idx.numpy().max() < n
    ref_plain = match.packed_best_plain(qa, wk, k_used)
    assert torch.equal(ref_plain[0], idx)


def _p2kw_smem(ksteps, reg, stages):
    """packed2kw_best.cu's ``w_smem``: slack, two warpgroups' 64 query rows
    past the register k steps in 32-lane boxes of 4 KiB, and a ring of
    32-row DB tiles of ceil(k steps / 2) boxes of 2 KiB."""
    return (1024 + 2 * -(-(ksteps - reg) // 2) * 4096
            + stages * -(-ksteps // 2) * 2048)


@pytest.mark.parametrize("k_used", range(528, 1153, 16))
@pytest.mark.parametrize("n", [64, 99, 65536, 1048000, 1048576])
def test_packed2kw_plan_fits_every_width(k_used, n):
    """The wide packed2k kernel's launch plan at every width it takes (M
    from 1 to 352, the widest level-0 batch): two consumer warpgroups of 64
    query rows and 32-row DB tiles; R k steps of each query row in
    registers, 4 R a thread beside 16 accumulators within 192 of the 255 a
    thread may take, and R the fewest that leave room for the plan's ring
    (up to three stages); the other k steps and the deepest ring that fits
    within the card's 232,448 - 1,024 bytes of shared memory; at least two
    stages at every width a preset reaches (608, 688, 832 and 1,040 lanes)
    and three up to 896 lanes; every DB tile in exactly one chunk."""
    ksteps = k_used // 16
    reg, consumers, rows = match._packed2kw_layout(k_used)
    assert (consumers, rows) == (2, 32)
    assert 1 <= reg < ksteps and 4 * reg + 16 <= 192
    tiles = -(-n // rows)
    for m in (1, 59, 64, 65, 128, 129, 344, 352):
        plan = match._packed2kw_plan(m, n, 132, k_used)
        assert (plan.consumers, plan.rows, plan.reg_ksteps) == (2, 32, reg)
        st = plan.stages
        assert plan.smem == _p2kw_smem(ksteps, reg, st) <= _SMEM_MAX
        assert st == 8 or _p2kw_smem(ksteps, reg, st + 1) > _SMEM_MAX
        assert _p2kw_smem(ksteps, reg - 1, min(st, 3)) > _SMEM_MAX
        assert st >= (3 if k_used <= 896 else 2 if k_used <= 1056 else 1)
        if k_used in (608, 688, 832, 1040):
            assert st >= 2
        per = plan.tiles_per_chunk
        assert (plan.n_chunks - 1) * per < tiles <= plan.n_chunks * per
        assert plan.q_tiles == -(-m // plan.bm) == -(-m // 128)
        assert plan.bm <= 128 and (m - 1) // plan.q_tiles < plan.bm
    with pytest.raises(ValueError):
        match._packed2kw_plan(8, 4096, 132, 512)
    with pytest.raises(ValueError):
        match._packed2k_route(1168)
    assert match._packed2k_route(512) == "packed_best"


def test_packed2kw_layout_is_the_kernels_rule():
    """``_packed2kw_layout`` mirrors packed2kw_best.cu: its warpgroups, tile
    rows, register limit and k-step range are the source's constexprs, and
    at every k step count (33 to 72) its register k steps are the source's
    ``reg_ksteps``, evaluated here from the source's own constants: the
    fewest that leave room for a ring of three stages if within
    REG_KMAX, else of two, else of one.  At the preset widths: 12 k steps
    at 608 lanes, 21 at 688, 36 at 832 (three stages each), 43 at 1,040
    (two)."""
    text = open(os.path.join(_build.CSRC_DIR, "packed2kw_best.cu")).read()
    const = {name: int(v) for name, v in re.findall(
        r"constexpr int (\w+) = (\d+);", text)}
    assert (const["CONS"], const["BN"]) == (2, 32)
    assert (16 * const["KMIN"], 16 * const["KMAX"]) == (
        match._P2K_MAX_LANES + 16, match._P2KW_MAX_LANES)
    assert re.search(r"min_reg\(ksteps, 3\) <= REG_KMAX", text)

    def w_smem(ksteps, r, stages):
        return (1024 + const["CONS"] * ((ksteps - r + 1) // 2) * 64 * 64
                + stages * ((ksteps + 1) // 2) * const["BN"] * 64)

    def min_reg(ksteps, stages):
        r = 0
        while r < ksteps and w_smem(ksteps, r, stages) > _SMEM_MAX:
            r += 1
        return r

    for ksteps in range(const["KMIN"], const["KMAX"] + 1):
        want = next((r for r in (min_reg(ksteps, 3), min_reg(ksteps, 2))
                     if r <= const["REG_KMAX"]), min_reg(ksteps, 1))
        assert match._packed2kw_layout(16 * ksteps) == (
            want, const["CONS"], const["BN"]), ksteps
    assert [match._packed2kw_layout(k)[0] for k in (608, 688, 832, 1040)] \
        == [12, 21, 36, 43]
    assert [match._packed2kw_plan(352, 1 << 20, 132, k).stages
            for k in (608, 688, 832, 1040)] == [3, 3, 3, 2]


def _rgb_level_planes(seed, ha, wa, hb, wb):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    hac, wac, hbc, wbc = ((ha + 1) // 2, (wa + 1) // 2, (hb + 1) // 2,
                          (wb + 1) // 2)
    return dict(a_src=u(ha, wa, 3), a_filt=u(ha, wa),
                a_src_coarse=u(hac, wac, 3), a_filt_coarse=u(hac, wac),
                b_src=u(hb, wb, 3), b_src_coarse=u(hbc, wbc, 3),
                b_filt_coarse=u(hbc, wbc))


@pytest.mark.parametrize("has_coarse,kp", [(False, 768), (True, 896)])
def test_rgb_patch7_packed2k_anchor_matches_jax(has_coarse, kp, monkeypatch):
    """exact_hi2_2p on RGB ``source_rgb`` sources at super_resolution's
    patch 7 (24^2; the coarsest level of two or one level: L = 171, K =
    768; a finer level: L = 207, K = 896): the port's anchor on the
    level state the JAX package built, against the JAX anchor with its
    ``packed2k_best`` in interpret mode -- the same picks, the duplicate
    row's lowest index.  The packed2k wrapper used to refuse K past 512
    here (ValueError), where the JAX kernel takes any multiple of 128."""
    from image_analogies_tpu.backends import tpu as jtpu
    from image_analogies_tpu.backends.base import LevelJob as JLevelJob
    from image_analogies_tpu.config import AnalogyParams as JParams
    from image_analogies_tpu_torch.backends import cuda as tcuda
    from image_analogies_tpu_torch.utils.state import level_db_from_numpy

    monkeypatch.setattr(jtpu, "packed2k_best", functools.partial(
        pm.packed2k_best, interpret=True))
    ha = wa = hb = wb = 24
    planes = _rgb_level_planes(5, ha, wa, hb, wb)
    planes["a_src"][19, 20] = planes["a_src"][2, 3]  # a duplicate row pair
    planes["a_filt"][19, 20] = planes["a_filt"][2, 3]
    if not has_coarse:
        for k in ("a_src_coarse", "a_filt_coarse", "b_src_coarse",
                  "b_filt_coarse"):
            planes[k] = None
    jspec = jfeatures.FeatureSpec(fine_size=7, coarse_size=3,
                                  has_coarse=has_coarse, src_channels=3)
    off = jfeatures.window_offsets(7)
    rowsafe = jnp.asarray((off[:, 0] < 0).astype(np.float32)
                          * jfeatures.causal_mask(7))
    j = {k: (None if v is None else jnp.asarray(v))
         for k, v in planes.items()}
    arrs = jtpu._prepare_level_arrays(
        jspec, j["a_src"], j["a_filt"], j["a_src_coarse"],
        j["a_filt_coarse"], None, j["b_src"], j["b_src_coarse"],
        j["b_filt_coarse"], None, rowsafe, 256, True, "packed2", 0, 0)
    arrs = {k: (None if v is None else np.array(v)) for k, v in arrs.items()}
    assert arrs["db_pad"].shape[1] == kp
    mode = "exact_hi2_2p"
    jparams = JParams(backend="tpu", strategy="wavefront", match_mode=mode,
                      patch_size=7, color_mode="source_rgb")
    jjob = JLevelJob(level=0, spec=jspec, kappa_mult=4.0, **planes)
    tmpl = jtpu.make_level_template(jparams, jjob, "wavefront", mode)
    jdb = dataclasses.replace(tmpl, **{
        k: (None if v is None else jnp.asarray(v)) for k, v in arrs.items()})
    arrs.update(diag=[np.asarray(s) for s in tmpl.diag],
                off=np.asarray(tmpl.off),
                fine_sqrtw=np.asarray(tmpl.fine_sqrtw))
    tdb = level_db_from_numpy(arrs, dict(
        ha=ha, wa=wa, hb=hb, wb=wb, fine_start=tmpl.fine_start,
        match_mode=mode), torch.device("cpu"))
    rng = np.random.default_rng(1)
    q = arrs["static_q"][rng.integers(0, hb * wb, 37)]
    q = (q + rng.uniform(0, 0.05, q.shape)).astype(np.float32)
    q[0] = arrs["db"][2 * wa + 3]
    jp, _ = jtpu.make_anchor_fn(jdb)(jnp.asarray(q))
    tp, td = tcuda.make_anchor_fn(tdb)(torch.from_numpy(q))
    assert td is None
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert int(tp[0]) == 2 * wa + 3 and int(tp.max()) < ha * wa
