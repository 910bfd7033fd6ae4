"""The port's ``parallel/`` building blocks (``image_analogies_tpu_torch/
parallel/``) against the JAX package's ``parallel/``.

One gloo world of four CPU ranks (``spawn_local``) on a (data=2, db=2)
mesh computes the sharded argmin (both precisions), its ties, the ring and
the packed all-reduce at 1, 2 and 4 shards; the tests hold its results
against ``make_sharded_argmin`` / ``make_ring_argmin`` /
``packed_champion_allreduce`` on the JAX package's 8-device virtual mesh
and against the single-array references.  ``initialize_distributed`` and
the device/backend rule run in this process with the process group
mocked.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from image_analogies_tpu.ops.pallas_match import xla_argmin_l2
from image_analogies_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image_analogies_tpu.parallel.sharded_match import (
    make_ring_argmin as jax_make_ring_argmin,
    make_sharded_argmin as jax_make_sharded_argmin,
    shard_level_db as jax_shard_level_db,
    sharded_pad_geometry as jax_sharded_pad_geometry,
)

from tests import torch_mesh_workers as workers

F, M = 40, 16
SHARDS = (1, 2, 4)
NS = (64, 100)  # 100: padding rows in play


def _argmin_case(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, F)).astype(np.float32),
            rng.standard_normal((M, F)).astype(np.float32))


def _tie_case():
    """All rows identical: the LOWEST global index must win."""
    rng = np.random.default_rng(3)
    row = rng.standard_normal(8).astype(np.float32)
    return np.tile(row, (16, 1)), (row[None, :] + 0.01).astype(np.float32)


def _ring_case():
    """Cross-shard duplicates of query 0 at rows 5 and n-3."""
    rng = np.random.default_rng(5)
    n = 96
    db = rng.standard_normal((n, F)).astype(np.float32)
    q = rng.standard_normal((M, F)).astype(np.float32)
    db[5] = q[0]
    db[n - 3] = q[0]
    return db, q


def _packed_case():
    """The JAX test's packed operands (n=512, L=55, duplicates of query 0
    at rows 70 and 400, in different shards), in the port's layout."""
    import torch

    from image_analogies_tpu_torch.backends.cuda import pack_wk
    from image_analogies_tpu_torch.ops.match import bf16_split3

    rng = np.random.default_rng(9)
    n, lw = 512, 55
    x = rng.standard_normal((n, lw)).astype(np.float32)
    q = rng.standard_normal((M, lw)).astype(np.float32)
    x[70] = q[0]
    x[400] = q[0]
    shift = x.mean(0).astype(np.float32)
    xt = torch.from_numpy(x)
    live = torch.arange(lw)
    st = torch.from_numpy(shift)
    xc = xt - st[None, :]
    wk, _ = pack_wk(xt, st, 0.5 * (xc * xc).sum(dim=1), live, n)
    g1, g2, _ = bf16_split3(torch.from_numpy(q - shift[None, :]))
    return (g1.to(torch.bfloat16).view(torch.int16).numpy(),
            g2.to(torch.bfloat16).view(torch.int16).numpy(),
            wk.view(torch.int16).numpy())


def _cases():
    argmin = {(n, 0): _argmin_case(n, n) for n in NS}
    argmin["tie"] = _tie_case()
    argmin["ring"] = _ring_case()
    return {"argmin": argmin, "packed": _packed_case()}


@pytest.fixture(scope="module")
def world():
    import torch

    from image_analogies_tpu_torch.parallel.launch import spawn_local

    cases = _cases()
    # bf16 crosses the process boundary as int16 bits
    cases["packed"] = tuple(torch.from_numpy(x).view(torch.bfloat16)
                            for x in cases["packed"])
    outs = spawn_local(workers.argmin_world, 4, device="cpu", args=(cases,))
    return cases, outs


def _jax_sharded(db, q, shards):
    mesh = jax_make_mesh(db_shards=shards)
    dbj = jnp.asarray(db)
    dbn = jnp.sum(dbj * dbj, axis=1)
    db_sh, dbn_sh, _ = jax_shard_level_db(dbj, dbn, jnp.zeros(db.shape[0]),
                                          mesh)
    idx, d = jax_make_sharded_argmin(mesh, force_xla=True)(
        jnp.asarray(q), db_sh, dbn_sh)
    return np.asarray(idx), np.asarray(d)


def test_mesh_layout(world):
    _, outs = world
    for rank, out in enumerate(outs):
        shape, ranks = out["mesh"]
        assert shape == {"data": 2, "db": 2}
        assert ranks == {"data": rank // 2, "db": rank % 2}


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("n", NS)
def test_sharded_argmin_matches_jax_and_single_device(world, shards, n):
    """HIGHEST: the JAX ``make_sharded_argmin`` on the virtual mesh and
    ``xla_argmin_l2``: indices equal but on fp ties (where the distances
    tie), distances within 1e-3; every rank the same bits."""
    cases, outs = world
    db, q = cases["argmin"][(n, 0)]
    idx, d = outs[0][((n, 0), shards, "highest")]
    for out in outs[1:]:
        np.testing.assert_array_equal(out[((n, 0), shards, "highest")][0],
                                      idx)
    for ref_idx, ref_d in (_jax_sharded(db, q, shards),
                           xla_argmin_l2(jnp.asarray(q), jnp.asarray(db),
                                         jnp.sum(jnp.asarray(db) ** 2, 1))):
        ref_idx, ref_d = np.asarray(ref_idx), np.asarray(ref_d)
        np.testing.assert_allclose(d, ref_d, atol=1e-3)
        diff = idx != ref_idx
        np.testing.assert_allclose(d[diff], ref_d[diff], atol=1e-3)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("prec", ("highest", "default"))
def test_sharded_argmin_equals_one_shard_bitwise(world, shards, n, prec):
    """Both precisions: the sharded picks and distances are the one-shard
    call's bits (each row's score is its single-card score)."""
    _, outs = world
    one = outs[0][((n, 0), 1, prec)]
    got = outs[0][((n, 0), shards, prec)]
    np.testing.assert_array_equal(got[0], one[0])
    np.testing.assert_array_equal(got[1], one[1])


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("prec", ("highest", "default"))
def test_sharded_argmin_tie_break_lowest_index(world, shards, prec):
    _, outs = world
    assert int(outs[0][("tie", shards, prec)][0][0]) == 0


@pytest.mark.parametrize("shards", (2, 4))
def test_ring_matches_allreduce(world, shards):
    """The ring's picks are the all-reduce's, the planted tie to the
    lowest global index (row 5), and the JAX ring's."""
    cases, outs = world
    db, q = cases["argmin"]["ring"]
    tiles = {}
    for out in outs[:shards]:  # data row 0 holds the 2-shard group
        me, idx, d = out[("ring_tile", shards)]
        tiles[me] = (idx, d)
    ring_idx = np.concatenate([tiles[i][0] for i in range(shards)])
    ring_d = np.concatenate([tiles[i][1] for i in range(shards)])
    all_idx, all_d = outs[0][("ring", shards, "highest")]
    np.testing.assert_array_equal(ring_idx, all_idx)
    np.testing.assert_allclose(ring_d, all_d, atol=1e-4)
    assert int(ring_idx[0]) == 5
    mesh = jax_make_mesh(db_shards=shards)
    dbj = jnp.asarray(db)
    db_sh, dbn_sh, _ = jax_shard_level_db(
        dbj, jnp.sum(dbj * dbj, 1), jnp.zeros(db.shape[0]), mesh)
    gi, _ = jax_make_ring_argmin(mesh, force_xla=True)(jnp.asarray(q), db_sh,
                                                       dbn_sh)
    np.testing.assert_array_equal(ring_idx, np.asarray(gi))


@pytest.mark.parametrize("shards", SHARDS)
def test_packed_champion_allreduce_matches_global(world, shards):
    """The packed all-reduce gives the global packed scan's picks, the
    planted cross-shard tie to the lowest global index (70), and the JAX
    ``packed_champion_allreduce``'s (interpret mode on the virtual
    mesh)."""
    import torch

    from image_analogies_tpu_torch.ops.match import packed_best

    cases, outs = world
    q1, q2, wk = cases["packed"]
    m, lw = q1.shape
    qa = torch.cat([q1, q1, torch.ones((m, 3), dtype=torch.bfloat16), q2, q1,
                    torch.zeros((m, wk.shape[1] - 4 * lw - 3),
                                dtype=torch.bfloat16)], dim=1)
    ref, _ = packed_best(qa, wk, (4 * lw + 3 + 15) // 16 * 16)
    idx, _ = outs[0][("packed", shards)]
    np.testing.assert_array_equal(idx, ref.numpy())
    assert int(idx[0]) == 70
    if shards == 4:
        from jax.sharding import PartitionSpec as P

        from image_analogies_tpu.parallel.mesh import shard_map
        from image_analogies_tpu.parallel.sharded_match import \
            packed_champion_allreduce

        as_j = lambda t: jnp.asarray(t.view(torch.int16).numpy()).view(
            jnp.bfloat16)
        fn = shard_map(
            lambda a, b, w: packed_champion_allreduce(
                a, b, w, "db", tile_n=128, interpret=True),
            mesh=jax_make_mesh(db_shards=4),
            in_specs=(P(), P(), P("db", None)), out_specs=(P(), P()),
            check_rep=False)
        gi, _ = jax.jit(fn)(as_j(q1), as_j(q2), as_j(wk))
        np.testing.assert_array_equal(idx, np.asarray(gi))


def test_mesh_world_size_errors(world):
    """A world smaller or larger than data x db raises, with the JAX
    message's content; a rank is a process, not a spare device."""
    _, outs = world
    for out in outs:
        small = out[("mesh_error", (1, 8))]
        large = out[("mesh_error", (2, 1))]
        assert "mesh needs 8 processes (data=8 x db=1)" in small
        assert "mesh needs 2 processes" in large and "4 are running" in large


def test_mesh_without_a_world():
    from image_analogies_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "db": 1}
    assert mesh.group("db") is None and mesh.rank_in("data") == 0
    with pytest.raises(ValueError, match="mesh needs 2 processes"):
        make_mesh(db_shards=2)


@pytest.mark.parametrize("n,f,shards,tile", [
    (64, 40, 1, 1), (100, 40, 4, 1), (100, 68, 2, 256), (1 << 20, 68, 2, 256),
    (65536, 253, 4, 256), (7, 3, 8, 1), (1000, 128, 3, 128),
    (262144, 223, 2, 256)])
def test_sharded_pad_geometry_matches_jax(n, f, shards, tile):
    from image_analogies_tpu_torch.parallel.sharded_match import \
        sharded_pad_geometry

    assert sharded_pad_geometry(n, f, shards, tile) == \
        jax_sharded_pad_geometry(n, f, shards, tile)


# ------------------------------------------------- initialize_distributed


@pytest.fixture
def no_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def calls(monkeypatch):
    import torch.distributed as dist

    from image_analogies_tpu_torch.parallel import distributed

    got = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: got.update(backend=backend,
                                                         **kw))
    monkeypatch.setattr(distributed, "_STATE", {"device": None,
                                                "backend": None})
    return got


def test_initialize_distributed_noop(no_env, calls):
    from image_analogies_tpu_torch.parallel.distributed import (
        initialize_distributed, is_writer)

    assert initialize_distributed() is False
    assert calls == {} and is_writer()


def test_initialize_distributed_explicit_arguments(no_env, calls):
    from image_analogies_tpu_torch.parallel import distributed

    assert distributed.initialize_distributed("h0:1234", 2, 1,
                                              device="cpu") is True
    assert calls == {"backend": "gloo", "init_method": "tcp://h0:1234",
                     "world_size": 2, "rank": 1}
    assert str(distributed.rank_device()) == "cpu"


def test_initialize_distributed_environment(no_env, calls, monkeypatch):
    from image_analogies_tpu_torch.parallel.distributed import \
        initialize_distributed

    for k, v in (("MASTER_ADDR", "h9"), ("MASTER_PORT", "99"),
                 ("WORLD_SIZE", "4"), ("RANK", "3")):
        monkeypatch.setenv(k, v)
    assert initialize_distributed(device="cpu") is True
    assert calls["init_method"] == "tcp://h9:99"
    assert calls["world_size"] == 4 and calls["rank"] == 3
    calls.clear()
    # explicit arguments win over the environment
    initialize_distributed("h1:5", 2, 0, device="cpu")
    assert calls["init_method"] == "tcp://h1:5" and calls["rank"] == 0


@pytest.mark.parametrize("args", [(None, None, 1), ("h0:1", None, 0),
                                  ("h0:1", 2, None), (None, 2, 0)])
def test_initialize_distributed_partial_configuration(no_env, calls, args):
    from image_analogies_tpu_torch.parallel.distributed import \
        initialize_distributed

    with pytest.raises(ValueError, match="hang"):
        initialize_distributed(*args, device="cpu")
    assert calls == {}


def test_initialize_distributed_backend_device_rule(no_env, calls,
                                                    monkeypatch):
    """nccl for CUDA, gloo for the CPU; nccl on the CPU raises; no card
    and no device named raises; a rank past the host's cards raises
    unless the caller names the device (and so shares a card)."""
    import torch

    from image_analogies_tpu_torch.parallel.distributed import \
        initialize_distributed

    with pytest.raises(ValueError, match="nccl backend needs a CUDA"):
        initialize_distributed("h:1", 2, 0, backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_distributed("h:1", 2, 0)
    assert calls == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    with pytest.raises(ValueError, match="no card of its own"):
        initialize_distributed("h:1", 2, 1)
    initialize_distributed("h:1", 2, 0)
    assert calls["backend"] == "nccl"
    calls.clear()
    initialize_distributed("h:1", 2, 1, backend="gloo", device="cuda:0")
    assert calls["backend"] == "gloo"


def test_nccl_error_is_never_replaced_by_gloo(no_env, monkeypatch):
    """A failing NCCL init raises as it is: no second init on gloo."""
    import torch
    import torch.distributed as dist

    from image_analogies_tpu_torch.parallel.distributed import \
        initialize_distributed

    seen = []

    def init(backend, **kw):
        seen.append(backend)
        raise RuntimeError("NCCL error: Duplicate GPU detected")

    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    with pytest.raises(RuntimeError, match="Duplicate GPU"):
        initialize_distributed("h:1", 2, 0, device="cuda:0")
    assert seen == ["nccl"]


def test_parallel_never_imports_jax():
    """The grep-lock of tests/test_torch_ops.py covers parallel/ too; this
    checks the package's modules load with no JAX module of their own."""
    import importlib
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    pkg = root / "image_analogies_tpu_torch" / "parallel"
    names = sorted(p.stem for p in pkg.glob("*.py"))
    assert {"distributed", "launch", "mesh", "sharded_match",
            "step"} <= set(names)
    for name in names:
        src = (pkg / f"{name}.py").read_text()
        assert "import jax" not in src and "image_analogies_tpu." not in src
        importlib.import_module(f"image_analogies_tpu_torch.parallel.{name}")
