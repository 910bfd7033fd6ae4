"""The port's mesh path end to end (``parallel/step.py`` through
``create_image_analogy``, ``video_analogy``, the lane engine and the CLI)
in gloo worlds of CPU ranks (``spawn_local``): a world of 2 and a world
of 4, each running every case of its own.

- db_shards 2 and 4: the wavefront equals the port's single-device run bit
  for bit, and batched too (the JAX test asks SSIM >= 0.99 and source-map
  agreement >= 0.95; the CPU's exact fp32 scan gives the single device's
  bits);
- the packed mesh level (exact_hi2_2p: packed2k per shard, the global
  shift) with and without the fused live gather, against the JAX
  ``multichip_level_step(packed_interpret=True)``: the first divergence
  in scan order must be a tie in the fp band (``tests/test_sharded.py``'s
  check);
- the sharded build keeps no per-rank DB copy;
- query-parallel (data_shards=2 on one image): the single device's bits,
  at exact_hi and at exact_hi2_2p (one db shard packs over the single
  card's shift);
- video over data=2 at exact_hi2_2p: the serial clip's bits;
- video on a 2 x 2 mesh: every frame the serial clip's within 1e-5, an
  odd frame count padded, a run killed after its coarse level resumed
  from its checkpoint, a stale checkpoint recomputed;
- the refusals (sequential video, the lane engine, retries and the
  watchdog on a sharded run) and the CLI flags.
"""

import json

import numpy as np
import pytest

import jax.numpy as jnp

from tests import torch_mesh_workers as workers
from tests.conftest import make_pair
from image_analogies_tpu.utils.ssim import ssim

IMG = dict(levels=2, kappa=2.0)


def _port(a, ap, b, **kw):
    from image_analogies_tpu_torch import AnalogyParams, create_image_analogy

    return create_image_analogy(a, ap, b, AnalogyParams(device="cpu", **kw))


def _video(a, ap, n, **kw):
    from image_analogies_tpu_torch import AnalogyParams, video_analogy

    return video_analogy(a, ap, workers._frames(a, n),
                         AnalogyParams(device="cpu", **kw))


VIDEO = dict(levels=2, kappa=2.0, temporal_weight=1.0,
             remap_luminance=False)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from image_analogies_tpu_torch.parallel.launch import spawn_local

    a, ap, b = make_pair(20, 20, seed=7)
    pa, pap, pb = make_pair(24, 24, seed=21)
    va, vap, _ = make_pair(16, 16, seed=2)
    tmp = tmp_path_factory.mktemp("cli")
    for name, x in (("a", a), ("ap", ap), ("b", b)):
        np.save(tmp / f"{name}.npy", x)
    cli = ["run", "--a", str(tmp / "a.npy"), "--ap", str(tmp / "ap.npy"),
           "--b", str(tmp / "b.npy"), "--out", str(tmp / "out.npy"),
           "--levels", "1", "--db-shards", "2", "--device", "cpu"]
    cases = {
        "images": {
            "wavefront": (a, ap, b, dict(IMG, db_shards=2)),
            "batched": (a, ap, b, dict(IMG, strategy="batched",
                                       db_shards=2)),
            "query_parallel": (a, ap, b, dict(IMG, data_shards=2)),
            "packed": (pa, pap, pb, dict(levels=1, kappa=3.0,
                                         match_mode="exact_hi2_2p",
                                         db_shards=2)),
            "query_parallel_packed": (pa, pap, pb, dict(
                levels=1, kappa=3.0, match_mode="exact_hi2_2p",
                data_shards=2)),
        },
        "packed": _packed_planes(pa, pap, pb),
        "build": (pa[:, :22], pap[:, :22], pb, dict(levels=1, db_shards=2)),
        "packed_build": (pa[:, :22], pap[:, :22], pb, dict(
            levels=1, match_mode="exact_hi2_2p", data_shards=2)),
        "video": {"packed": (va, vap, 2, dict(
            VIDEO, match_mode="exact_hi2_2p", data_shards=2))},
        "cli": cli,
    }
    outs = spawn_local(workers.pair_world, 2, device="cpu", args=(cases,))
    return (a, ap, b), (pa, pap, pb), tmp, outs


def _packed_planes(a, ap, b):
    from image_analogies_tpu_torch import AnalogyParams
    from image_analogies_tpu_torch.models.analogy import _prep_planes

    a_src, b_src, a_filt, _, _ = _prep_planes(
        a, ap, b, AnalogyParams(device="cpu"))
    return a_src, a_filt, b_src, dict(levels=1, kappa=3.0)


@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    from image_analogies_tpu_torch.parallel.launch import spawn_local

    a, ap, b = make_pair(20, 20, seed=7)
    va, vap, _ = make_pair(16, 16, seed=2)
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    cases = {
        "images": {
            "wavefront": (a, ap, b, dict(IMG, db_shards=4)),
            "batched": (a, ap, b, dict(IMG, strategy="batched",
                                       db_shards=4)),
        },
        "video": {
            "wavefront": (va, vap, 4, dict(VIDEO, data_shards=2,
                                           db_shards=2)),
            "batched_odd": (va, vap, 3, dict(VIDEO, strategy="batched",
                                             data_shards=2, db_shards=2)),
            "ckpt": (va, vap, 2, dict(VIDEO, data_shards=2, db_shards=2,
                                      checkpoint_dir=str(tmp / "ck"),
                                      log_path=str(tmp / "log.jsonl"))),
        },
    }
    outs = spawn_local(workers.quad_world, 4, device="cpu", args=(cases,))
    return (a, ap, b), (va, vap), tmp, outs


def _same_on_every_rank(outs, pick):
    ref = pick(outs[0])
    for out in outs[1:]:
        got = pick(out)
        for x, y in zip(ref, got):
            np.testing.assert_array_equal(x, y)
    return ref


@pytest.mark.parametrize("world,name,kw", [
    ("pair", "wavefront", dict(IMG)),
    ("pair", "query_parallel", dict(IMG)),
    ("quad", "wavefront", dict(IMG)),
])
def test_mesh_wavefront_equals_single_device(request, world, name, kw):
    (a, ap, b), _, _, outs = request.getfixturevalue(world)
    bp, s = _same_on_every_rank(
        outs, lambda o: (o["images"][name]["bp"], o["images"][name]["s"]))
    ref = _port(a, ap, b, **kw)
    np.testing.assert_array_equal(bp, ref.bp_y)
    np.testing.assert_array_equal(s, ref.source_map)
    stats = outs[0]["images"][name]["stats"]
    assert [st["match_mode"] for st in stats] == ["exact_hi", "exact_hi"]
    assert [st["coherence_ratio"] for st in stats] == [
        st["coherence_ratio"] for st in ref.stats]


@pytest.mark.parametrize("world,shards", [("pair", 2), ("quad", 4)])
def test_mesh_batched_meets_the_jax_limits(request, world, shards):
    (a, ap, b), _, _, outs = request.getfixturevalue(world)
    bp, s = _same_on_every_rank(
        outs, lambda o: (o["images"]["batched"]["bp"],
                         o["images"]["batched"]["s"]))
    ref = _port(a, ap, b, strategy="batched", **IMG)
    assert ssim(ref.bp_y, bp, data_range=1.0) >= 0.99
    assert (ref.source_map == s).mean() >= 0.95
    np.testing.assert_array_equal(bp, ref.bp_y)
    stats = outs[0]["images"]["batched"]["stats"]
    assert all(st["mesh"] == {"data": 1, "db": shards} for st in stats)
    assert [st["refined_ratio"] for st in stats] == [
        st["refined_ratio"] for st in ref.stats]


def _first_divergence_is_tie(s_mesh, s_solo, bp_solo, a_src, a_filt, b_src,
                             params, h, w):
    """tests/test_sharded.py's check: the first scan-order divergence is a
    tie of the anchor decision in the fp band."""
    from image_analogies_tpu.ops.features import (build_features_np,
                                                  fine_gather_maps,
                                                  spec_for_level)

    mism = np.nonzero(s_mesh.reshape(-1) != s_solo.reshape(-1))[0]
    if not mism.size:
        return
    spec = spec_for_level(params, 0, 1, 1)
    db_rows = build_features_np(spec, a_src, a_filt, None, None)
    ii, jj = mism // w, mism % w
    q0 = mism[np.argmin(jj + 3 * ii)]
    p_mesh, p_solo = int(s_mesh.reshape(-1)[q0]), int(s_solo.reshape(-1)[q0])
    flat_idx, _, written = fine_gather_maps(h, w, spec.fine_size)
    fsl = spec.fine_filt_slice
    qv = build_features_np(spec, b_src, None, None, None)[q0].copy()
    qv[fsl] = (bp_solo.reshape(-1)[flat_idx[q0]] * written[q0]
               * spec.sqrt_weights()[fsl])
    d = ((db_rows[[p_mesh, p_solo]].astype(np.float64)
          - qv.astype(np.float64)) ** 2).sum(1)
    scale = (qv.astype(np.float64) ** 2).sum() + max(
        (db_rows[p_mesh].astype(np.float64) ** 2).sum(),
        (db_rows[p_solo].astype(np.float64) ** 2).sum())
    assert abs(d[0] - d[1]) <= 2e-6 * scale, (
        f"first divergence at {q0} is not a tie: {d}")


def _jax_packed_level(pa, pap, pb, fused):
    """The JAX ``multichip_level_step`` with the packed scan in interpret
    mode on the 4-device virtual mesh (tests/test_sharded.py's setup)."""
    import dataclasses

    from image_analogies_tpu.backends.base import LevelJob
    from image_analogies_tpu.backends.tpu import (_prepare_query_arrays,
                                                  build_sharded_db,
                                                  make_level_template)
    from image_analogies_tpu.config import AnalogyParams
    from image_analogies_tpu.models.analogy import _prep_planes
    from image_analogies_tpu.ops.features import spec_for_level
    from image_analogies_tpu.parallel.mesh import make_mesh
    from image_analogies_tpu.parallel.step import multichip_level_step

    params = AnalogyParams(levels=1, kappa=3.0, backend="tpu",
                           strategy="wavefront")
    a_src, b_src, a_filt, _, _ = _prep_planes(pa, pap, pb, params)
    spec = spec_for_level(params, 0, 1, 1)
    job = LevelJob(level=0, spec=spec, kappa_mult=params.kappa_factor(0) ** 2,
                   a_src=a_src, a_filt=a_filt, b_src=b_src)
    mesh = make_mesh(db_shards=4)
    to_j = lambda x: None if x is None else jnp.asarray(x, jnp.float32)
    template = make_level_template(params, job, "wavefront")
    dbp, dbnp, afp, wk, shift, dbl = build_sharded_db(
        spec, to_j(a_src), to_j(a_filt), None, None, None,
        template.rowsafe, mesh, True, 1, packed=True)
    template = dataclasses.replace(template, feat_mean=shift)
    static_q = _prepare_query_arrays(spec, to_j(b_src), None, None, None)
    _, s, _ = multichip_level_step(
        mesh, static_q[None], dbp, dbnp, afp, template, job.kappa_mult,
        force_xla=True, wk_shard=wk, packed_interpret=True,
        dbl_shard=dbl if fused else None)
    return np.asarray(s[0])


@pytest.mark.parametrize("fused", [False, True])
def test_packed_mesh_level_matches_jax_interpret(pair, fused):
    """exact_hi2_2p on the mesh (packed2k per shard, plain on the CPU)
    against the JAX packed mesh level in interpret mode and against the
    port's single-device exact_hi run: the first divergence in scan order
    must be a tie in the fp band."""
    from image_analogies_tpu.config import AnalogyParams

    _, (pa, pap, pb), _, outs = pair
    a_src, a_filt, b_src, _ = _packed_planes(pa, pap, pb)
    s_mesh = _same_on_every_rank(outs, lambda o: (o["packed"][fused],))[0]
    assert outs[0]["packed"]["rows"] % 256 == 0
    solo = _port(pa, pap, pb, levels=1, kappa=3.0)
    params = AnalogyParams(levels=1, kappa=3.0, backend="tpu")
    h, w = pb.shape
    for ref in (_jax_packed_level(pa, pap, pb, fused), solo.source_map):
        _first_divergence_is_tie(s_mesh, ref, solo.bp_y, a_src, a_filt,
                                 b_src, params, h, w)


def test_packed_mesh_end_to_end(pair):
    """match_mode=exact_hi2_2p through create_image_analogy at db_shards=2:
    every rank the same bits, each level packed, and the first divergence
    from the single device's packed run a tie."""
    from image_analogies_tpu.config import AnalogyParams

    _, (pa, pap, pb), _, outs = pair
    bp, s = _same_on_every_rank(
        outs, lambda o: (o["images"]["packed"]["bp"],
                         o["images"]["packed"]["s"]))
    assert [st["match_mode"] for st in outs[0]["images"]["packed"]["stats"]
            ] == ["exact_hi2_2p"]
    solo = _port(pa, pap, pb, levels=1, kappa=3.0, match_mode="exact_hi2_2p")
    a_src, a_filt, b_src, _ = _packed_planes(pa, pap, pb)
    _first_divergence_is_tie(s, solo.source_map, solo.bp_y, a_src, a_filt,
                             b_src, AnalogyParams(levels=1, kappa=3.0),
                             *pb.shape)


def test_query_parallel_packed_equals_single_device(pair):
    """Query-parallel at exact_hi2_2p: one db shard holds the whole DB and
    packs it over the single card's shift, so the packed2k scan gives the
    single device's bits."""
    _, (pa, pap, pb), _, outs = pair
    bp, s = _same_on_every_rank(
        outs, lambda o: (o["images"]["query_parallel_packed"]["bp"],
                         o["images"]["query_parallel_packed"]["s"]))
    assert [st["match_mode"] for st in
            outs[0]["images"]["query_parallel_packed"]["stats"]] == [
        "exact_hi2_2p"]
    solo = _port(pa, pap, pb, levels=1, kappa=3.0, match_mode="exact_hi2_2p")
    np.testing.assert_array_equal(bp, solo.bp_y)
    np.testing.assert_array_equal(s, solo.source_map)


def test_one_db_shard_packs_the_single_card_bits(pair):
    """A mesh with one db shard (here query-parallel) builds the packed
    level over the single card's fp32 shift and half norms: its K-wide
    weights and shift are the single card's ``packed2`` arrays bit for
    bit (a float64 shift over the shards would move them by an ulp)."""
    import torch

    from image_analogies_tpu_torch import AnalogyParams
    from image_analogies_tpu_torch.backends.cuda import prepare_level_arrays
    from image_analogies_tpu_torch.ops.features import spec_for_level

    _, (pa, pap, pb), _, outs = pair
    spec = spec_for_level(AnalogyParams(device="cpu", levels=1), 0, 1, 1)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    ref = prepare_level_arrays(spec, t(pa[:, :22]), t(pap[:, :22]), None,
                               None, t(pb), None, None, pad_mode="packed2")
    for out in outs:
        got = out["packed_build"]
        assert got["mode"] == "exact_hi2_2p"
        np.testing.assert_array_equal(
            got["wk"], ref["db_pad"].view(torch.int16).numpy())
        np.testing.assert_array_equal(got["shift"], ref["feat_mean"].numpy())


def test_sharded_build_keeps_no_per_rank_db(pair):
    """Every DB-sized field of a sharded level is a 1-row placeholder; the
    shards hold half the (padded) rows each; the level synthesizes
    through the mesh step, and best_match refuses."""
    _, (pa, _, pb), _, outs = pair
    na = pa.shape[0] * 22
    for out in outs:
        rows = out["build"]["rows"]
        for name in ("db", "a_filt_flat"):
            assert rows[name][0] == 1, name
        assert "db_rowsafe" not in rows  # the wavefront builds none
        assert rows["db_sharded"][0] * 2 >= na
        assert rows["db_sharded"][0] < na
        assert rows["db_sharded"][0] % 256 == 0
        assert out["build"]["mesh"] == {"data": 1, "db": 2}
        assert out["build"]["bp"].shape == pb.shape
        assert out["build"]["s"].max() < na
        assert "placeholders" in out["build"]["best_match_error"]


def test_cli_shards_and_rank0_writes(pair):
    (a, ap, b), _, tmp, outs = pair
    (code0, out0), (code1, out1) = outs[0]["cli"], outs[1]["cli"]
    assert code0 == code1 == 0
    assert out0.strip() == str(tmp / "out.npy") and out1 == ""
    from image_analogies_tpu_torch import PRESETS, create_image_analogy

    ref = create_image_analogy(a, ap, b, PRESETS["oil_filter"].replace(
        levels=1), device="cpu")
    np.testing.assert_array_equal(np.load(tmp / "out.npy"), ref.bp)


def test_cli_flags_parse():
    from image_analogies_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["video", "--a", "a", "--ap", "b", "--frames", "f", "--out-dir", "o",
         "--db-shards", "2", "--data-shards", "2", "--coordinator", "h:1",
         "--num-processes", "4", "--process-id", "3"])
    params = cli._params_from_args(args, cli.PRESETS["video"])
    assert (params.db_shards, params.data_shards) == (2, 2)
    assert (args.coordinator, args.num_processes, args.process_id) == (
        "h:1", 4, 3)


def test_params_validate_shards():
    from image_analogies_tpu_torch import AnalogyParams

    with pytest.raises(ValueError, match="db_shards must be >= 1"):
        AnalogyParams(db_shards=0)
    with pytest.raises(ValueError, match="data_shards must be >= 1"):
        AnalogyParams(data_shards=0)


@pytest.mark.parametrize("kw", [
    dict(db_shards=2, level_retries=1),
    dict(data_shards=2, level_retries=2),
    dict(db_shards=2, dispatch_timeout_s=30.0),
])
def test_sharded_run_refuses_retries_and_watchdog(kw):
    """Each rank is its own process: a retry or a watchdog on one rank
    alone would leave its peers in the step's collectives."""
    from image_analogies_tpu_torch import AnalogyParams

    with pytest.raises(ValueError, match="sharded run"):
        AnalogyParams(device="cpu", **kw)
    AnalogyParams(device="cpu", **{k: v for k, v in kw.items()
                                   if not k.endswith("shards")})


def test_data_shards_on_one_image_is_the_wavefront_only():
    from image_analogies_tpu_torch import AnalogyParams, create_image_analogy

    a, ap, b = make_pair(12, 12, seed=1)
    with pytest.raises(ValueError, match="query-parallel"):
        create_image_analogy(a, ap, b, AnalogyParams(
            device="cpu", strategy="batched", data_shards=2))


@pytest.mark.parametrize("kw,reason", [
    (dict(data_shards=2), "sharded"), (dict(db_shards=2), "sharded")])
def test_engine_refuses_sharded(kw, reason):
    """Before any launch: data_shards (as the JAX engine) and db_shards
    (the JAX engine's lanes read the sharded level's placeholders)."""
    from image_analogies_tpu_torch import (AnalogyParams, BatchIncompatible,
                                           create_image_analogy_batch)

    a, ap, b = make_pair(12, 12, seed=1)
    with pytest.raises(BatchIncompatible) as e:
        create_image_analogy_batch(a, ap, [b, b], AnalogyParams(
            device="cpu", remap_luminance=False, **kw))
    assert e.value.reason == reason


def test_video_sequential_refuses_data_shards():
    a, ap, _ = make_pair(16, 16, seed=6)
    with pytest.raises(ValueError, match="two_phase"):
        from image_analogies_tpu_torch import AnalogyParams, video_analogy

        video_analogy(a, ap, workers._frames(a, 2), AnalogyParams(
            device="cpu", data_shards=2, temporal_weight=1.0),
            scheme="sequential")


@pytest.mark.parametrize("name,n,strategy", [
    ("wavefront", 4, "wavefront"), ("batched_odd", 3, "batched")])
def test_mesh_video_matches_serial(quad, name, n, strategy):
    _, (va, vap), _, outs = quad
    frames_y = _same_on_every_rank(
        outs, lambda o: tuple(o["video"][name]["frames_y"]))
    serial = _video(va, vap, n, strategy=strategy, **VIDEO)
    assert len(frames_y) == n
    for t, (fs, fr) in enumerate(zip(frames_y, serial.frames_y)):
        np.testing.assert_allclose(fs, fr, atol=1e-5,
                                   err_msg=f"frame {t} diverged")
    stats = outs[0]["video"][name]["stats"]
    assert stats and all(st["mesh"] == {"data": 2, "db": 2} for st in stats)
    assert sorted({st["frame"] for st in stats}) == list(range(n))


def test_mesh_video_packed_one_db_shard_is_serial_bits(pair):
    """Frames over data=2 at exact_hi2_2p: one db shard packs over the
    single card's shift, so every frame is the serial clip's bits."""
    _, _, _, outs = pair
    va, vap, _ = make_pair(16, 16, seed=2)
    frames_y = _same_on_every_rank(
        outs, lambda o: tuple(o["video"]["packed"]["frames_y"]))
    kw = dict(VIDEO, match_mode="exact_hi2_2p")
    serial = _video(va, vap, 2, **kw)
    assert {st["match_mode"] for st in serial.stats} == {"exact_hi2_2p"}
    assert len(frames_y) == 2
    for fs, fr in zip(frames_y, serial.frames_y):
        np.testing.assert_array_equal(fs, fr)


def test_mesh_video_checkpoint_kill_resume(quad):
    """Killed after the coarse level: phase 1's coarse checkpoint exists
    and its finest does not; the resumed clip is the serial clip's bits;
    the log (rank 0's) holds the resume records."""
    _, (va, vap), tmp, outs = quad
    got = outs[0]["video"]["ckpt"]
    assert got["killed"]
    assert got["files"] == ["level_01.npz"]
    serial = _video(va, vap, 2, **VIDEO)
    for out in outs:
        for fr, fx in zip(out["video"]["ckpt"]["resumed"], serial.frames_y):
            np.testing.assert_array_equal(fr, fx)
    events = [json.loads(line) for line in open(tmp / "log.jsonl")]
    assert any(e.get("event") == "resume_level"
               and e.get("phase") == "phase1" for e in events)


def test_mesh_video_stale_checkpoint_not_resumed(quad):
    _, (va, vap), _, outs = quad
    fresh = _video(va, vap, 2, **dict(VIDEO, kappa=5.0))
    for fr, fx in zip(outs[0]["video"]["ckpt"]["stale"], fresh.frames_y):
        np.testing.assert_array_equal(fr, fx)
