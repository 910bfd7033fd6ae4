"""Rank functions of the port's mesh tests (``tests/test_torch_parallel.py``,
``tests/test_torch_mesh.py``), run in gloo worlds on the CPU by
``image_analogies_tpu_torch.parallel.launch.spawn_local``.

A module of its own, importing torch and the port only: each spawned rank
imports it to find its function, and must not pay for the JAX package.
Every function takes (rank, ...) and returns picklable NumPy results; the
tests hold them against the JAX package in their own process.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np


def _np(t):
    return t.detach().cpu().numpy()


def argmin_world(rank, cases):
    """A world of 4 on a (data=2, db=2) mesh: the sharded argmin, its
    ties, the ring and the packed all-reduce at 1 (no group), 2 (the db
    group) and 4 (the world) shards; and the world-size errors."""
    import torch
    import torch.distributed as dist

    from image_analogies_tpu_torch.parallel import sharded_match as sm
    from image_analogies_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(db_shards=2, data_shards=2)
    groups = {1: None, 2: mesh.group("db"), 4: dist.group.WORLD}
    me = {1: 0, 2: mesh.rank_in("db"), 4: rank}
    out = {"mesh": (dict(mesh.shape), dict(mesh.ranks))}
    for key, (db, q) in cases["argmin"].items():
        dbt = torch.from_numpy(db)
        dbn = (dbt * dbt).sum(dim=1)
        for shards, g in groups.items():
            dbp, dbnp, _ = sm.shard_level_db(dbt, dbn, dbn * 0, g)
            for prec in sm.PRECISIONS:
                idx, d = sm.make_sharded_argmin(g, prec)(
                    torch.from_numpy(q), dbp.to(torch.bfloat16)
                    if prec == "default" else dbp, dbnp)
                out[(key, shards, prec)] = (_np(idx), _np(d))
            if key == "ring":
                m = q.shape[0] // shards
                tile = torch.from_numpy(q[me[shards] * m:(me[shards] + 1) * m])
                idx, d = sm.make_ring_argmin(g)(tile, dbp, dbnp)
                out[("ring_tile", shards)] = (me[shards], _np(idx), _np(d))
    q1, q2, wk = cases["packed"]  # bf16 tensors
    for shards, g in groups.items():
        r = wk.shape[0] // shards
        shard = wk[me[shards] * r:(me[shards] + 1) * r]
        idx, val = sm.packed_champion_allreduce(q1, q2, shard, g)
        out[("packed", shards)] = (_np(idx), _np(val))
    for shape in ((2, 1), (1, 8)):
        try:
            make_mesh(*shape)
            out[("mesh_error", shape)] = None
        except ValueError as e:
            out[("mesh_error", shape)] = str(e)
    return out


def _params(**kw):
    from image_analogies_tpu_torch import AnalogyParams

    return AnalogyParams(device="cpu", **kw)


def _run(a, ap, b, params, keep_levels=False):
    from image_analogies_tpu_torch import create_image_analogy

    res = create_image_analogy(a, ap, b, params, keep_levels=keep_levels)
    return {"bp": res.bp_y, "s": res.source_map,
            "stats": [{k: v for k, v in st.items()
                       if k in ("level", "mesh", "match_mode",
                                "coherence_ratio", "refined_ratio")}
                      for st in res.stats]}


def image_world(rank, cases):
    """Single-image runs: every case (name, a, ap, b, params kwargs) on
    this world's mesh."""
    return {name: _run(a, ap, b, _params(**kw))
            for name, (a, ap, b, kw) in cases.items()}


def packed_level_world(rank, case):
    """The packed mesh level (exact_hi2_2p: packed2k per shard, then the
    max+argmax all-reduce) driven by hand, as the JAX test drives its
    ``multichip_level_step``: with and without the fused live gather."""
    import torch

    from image_analogies_tpu_torch.backends.base import LevelJob
    from image_analogies_tpu_torch.backends.cuda import (
        build_sharded_db,
        make_level_template,
        prepare_query_arrays,
    )
    from image_analogies_tpu_torch.ops.features import spec_for_level
    from image_analogies_tpu_torch.parallel.mesh import make_mesh
    from image_analogies_tpu_torch.parallel.step import multichip_level_step

    a_src, a_filt, b_src, kw = case
    params = _params(**kw)
    spec = spec_for_level(params, 0, 1, 1)
    job = LevelJob(level=0, spec=spec, kappa_mult=params.kappa_factor(0) ** 2,
                   a_src=a_src, a_filt=a_filt, b_src=b_src)
    mesh = make_mesh(db_shards=2)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    template = make_level_template(params, job, "wavefront", "exact_hi2_2p",
                                   torch.device("cpu"))
    dbp, dbnp, afp, wk, shift, dbl = build_sharded_db(
        spec, t(a_src), t(a_filt), None, None, None, template.rowsafe, mesh,
        True, packed=True)
    template.feat_mean = shift
    static_q = prepare_query_arrays(spec, t(b_src), None, None, None)
    out = {"rows": int(dbp.shape[0])}
    for fused in (False, True):
        _, s, _ = multichip_level_step(
            mesh, static_q[None], dbp, dbnp, afp, template, job.kappa_mult,
            wk_shard=wk, dbl_shard=dbl if fused else None)
        out[fused] = _np(s[0])
    return out


def build_world(rank, case):
    """A sharded level's LevelDB: which fields are placeholders, which
    shards, and the level synthesized through the mesh step."""
    import torch

    from image_analogies_tpu_torch.backends.base import LevelJob
    from image_analogies_tpu_torch.backends.cuda import CudaMatcher
    from image_analogies_tpu_torch.ops.features import spec_for_level

    a, ap, b, kw = case
    params = _params(**kw)
    job = LevelJob(level=0, spec=spec_for_level(params, 0, 1, 1),
                   kappa_mult=4.0, a_src=a, a_filt=ap, b_src=b)
    m = CudaMatcher(params, torch.device("cpu"))
    db = m.build_features(job)
    rows = {name: tuple(getattr(db, name).shape)
            for name in ("db", "db_rowsafe", "a_filt_flat", "db_sharded",
                         "dbn_sharded", "afilt_sharded")
            if getattr(db, name) is not None}
    bp, s, st = m.synthesize_level(db, job)
    try:
        m.best_match(db, job, 0, np.zeros(b.size, np.float32),
                     np.zeros(b.size, np.int32))
        best = None
    except ValueError as e:
        best = str(e)
    return {"rows": rows, "mesh": dict(db.mesh.shape), "bp": _np(bp),
            "s": _np(s), "best_match_error": best}


def packed_build_world(rank, case):
    """The packed level's build on this world's mesh
    (``CudaMatcher.build_mesh_level``): the K-wide weight shard's bits and
    the centering shift."""
    import torch

    from image_analogies_tpu_torch.backends.base import LevelJob
    from image_analogies_tpu_torch.backends.cuda import CudaMatcher
    from image_analogies_tpu_torch.ops.features import spec_for_level

    a, ap, b, kw = case
    params = _params(**kw)
    job = LevelJob(level=0, spec=spec_for_level(params, 0, 1, 1),
                   kappa_mult=4.0, a_src=a, a_filt=ap, b_src=b)
    db = CudaMatcher(params, torch.device("cpu")).build_mesh_level(job)
    return {"mode": db.match_mode, "wk": _np(db.db_pad.view(torch.int16)),
            "shift": _np(db.feat_mean)}


def cli_world(rank, args):
    """``cli.main`` on every rank: what each prints, and its exit code."""
    from image_analogies_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(list(args))
    return code, buf.getvalue()


def _frames(a, n):
    rng = np.random.default_rng(1)
    return [np.clip(np.roll(a, t, axis=1)
                    + 0.01 * rng.standard_normal(a.shape), 0, 1)
            .astype(np.float32) for t in range(n)]


def video_world(rank, cases):
    """Frame-sharded clips: every case (name, a, ap, n_frames, params
    kwargs); and, for the case named "ckpt", a run killed after its
    coarse level (the second level call raises), its resume from the
    checkpoint, and a resume under another kappa (a stale checkpoint,
    recomputed)."""
    from image_analogies_tpu_torch import video_analogy
    from image_analogies_tpu_torch.models import video as video_mod
    from image_analogies_tpu_torch.utils import failure

    out = {}
    for name, (a, ap, n, kw) in cases.items():
        params = _params(**kw)
        frames = _frames(a, n)
        if name != "ckpt":
            res = video_analogy(a, ap, frames, params)
            out[name] = {"frames_y": res.frames_y, "stats": res.stats}
            continue
        orig = failure.run_with_retry
        calls = {"n": 0}

        def dying(fn, **kw2):
            calls["n"] += 1
            if calls["n"] == 2:
                raise failure.InjectedFailure("killed after coarse level")
            return orig(fn, **kw2)

        video_mod.failure.run_with_retry = dying
        try:
            video_analogy(a, ap, frames, params)
            killed = False
        except failure.InjectedFailure:
            killed = True
        finally:
            video_mod.failure.run_with_retry = orig
        import os

        ck = params.checkpoint_dir
        files = sorted(os.listdir(os.path.join(ck, "phase1")))
        resumed = video_analogy(a, ap, frames,
                                params.replace(resume_from_level=0))
        stale = video_analogy(a, ap, frames,
                              params.replace(kappa=5.0, resume_from_level=0))
        out[name] = {"killed": killed, "files": files,
                     "resumed": resumed.frames_y, "stale": stale.frames_y}
    return out


def pair_world(rank, cases):
    """A world of 2: the single-image cases, the packed mesh level, the
    sharded builds, a packed frame-sharded clip and the CLI, in one
    world."""
    return {"images": image_world(rank, cases["images"]),
            "packed": packed_level_world(rank, cases["packed"]),
            "build": build_world(rank, cases["build"]),
            "packed_build": packed_build_world(rank, cases["packed_build"]),
            "video": video_world(rank, cases["video"]),
            "cli": cli_world(rank, cases["cli"])}


def quad_world(rank, cases):
    """A world of 4: the single-image cases at db_shards=4 and the
    frame-sharded clips on a 2 x 2 mesh."""
    return {"images": image_world(rank, cases["images"]),
            "video": video_world(rank, cases["video"])}


def seeded_argmin(m, n, npad, f=68, fp=128, seed=3):
    """Seeded argmin operands, NumPy: lane-padded DB rows, +inf-norm
    padding rows, a duplicate pair in different halves, query 0 equal to
    it.  Returns (q, db, dbn)."""
    rng = np.random.default_rng(seed)
    db = np.zeros((npad, fp), np.float32)
    db[:n, :f] = rng.standard_normal((n, f)).astype(np.float32)
    lo, hi = n // 7, n * 6 // 7
    db[hi] = db[lo]
    q = rng.standard_normal((m, f)).astype(np.float32)
    q[0] = db[lo, :f]
    dbn = np.full((npad,), np.inf, np.float32)
    dbn[:n] = (db[:n] ** 2).sum(1)
    return q, db, dbn


def gloo_card_rank(rank, shape):
    """Two ranks sharing one card over gloo: this rank's shard of the
    seeded DB on cuda:0, the sharded argmin (both precisions).  Returns
    the picks and the bytes staged through the host."""
    import torch
    import torch.distributed as dist

    from image_analogies_tpu_torch.parallel import mesh
    from image_analogies_tpu_torch.parallel import sharded_match as sm

    dev = torch.device("cuda", 0)
    q, db, dbn = (torch.from_numpy(x).to(dev) for x in seeded_argmin(*shape))
    mesh.reset_staged()
    g = dist.group.WORLD
    dbp, dbnp, _ = sm.shard_level_db(db, dbn, dbn * 0, g)
    idx, _ = sm.local_argmin_allreduce(q, dbp, dbnp, g)
    idx_h, _ = sm.local_argmin_allreduce(q, dbp.to(torch.bfloat16), dbnp,
                                         g, precision="default")
    return _np(idx), _np(idx_h), mesh.STAGED["bytes"]
