"""The port's bf16 scan entries (every form of the CUDA scan template)
against the JAX package's Pallas kernels in interpret mode, on the CPU.

On the CPU each port wrapper runs its plain PyTorch version.  Inputs are
made from a seed with numpy, split and packed once by the port, and handed
bit for bit to both packages.  Shapes are ragged, with duplicate rows,
padding rows, all-padding tiles and a one-row DB.  Picks must be equal;
values agree to rtol/atol 1e-5 (2e-5 where tests/test_pallas_kernel.py
states it), the fp32 sums running in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_analogies_tpu.ops import pallas_match as pm
from image_analogies_tpu_torch.ops import match
from tests.test_torch_wavefront import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _to_jax(t):
    """A torch tensor as a JAX array with the same bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(x):
    return np.asarray(x)


def _split3(x):
    """(d1, d2, d3) bf16 of fp32 ``x``: the truncated splits and the
    residual rounded, as the JAX package builds them."""
    d1, d2, r2 = match.bf16_split3(x)
    return tuple(v.to(torch.bfloat16) for v in (d1, d2, r2))


def _pack(left, right, npad, kp):
    n, l = left.shape
    w = torch.zeros((npad, kp), dtype=torch.bfloat16)
    w[:n, :l] = left
    w[:n, l:2 * l] = right
    return w


def _packed_case(m=13, l=55, n=1000, npad=1024, seed=0):
    """Live-dim rows with an exact duplicate pair and a query equal to the
    duplicated row; W1 = [d1|d2], W2 = [d3|d1] or [d1|d3]; half norms with
    +inf padding rows."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, l)) * 0.1).astype(np.float32)
    x[600] = x[3]
    q = (rng.standard_normal((m, l)) * 0.1).astype(np.float32)
    q[2] = x[3]
    d1, d2, d3 = _split3(torch.from_numpy(x))
    q1, q2, q3 = _split3(torch.from_numpy(q))
    kp = max((2 * l + 127) // 128 * 128, 128)
    dbnh = torch.full((npad,), float("inf"))
    dbnh[:n] = 0.5 * torch.from_numpy((x ** 2).sum(1))
    return dict(q1=q1, q2=q2, q3=q3, d1=d1, d2=d2, d3=d3, n=n, npad=npad,
                kp=kp, l=l, dbnh=dbnh)


def _run_form(form, c, tile=256):
    """(port (idx, val), JAX (idx, val)) of one packed_best form."""
    q1, q2, q3, npad, kp, l = (c[k] for k in ("q1", "q2", "q3", "npad",
                                               "kp", "l"))
    d1, d2, d3, dbnh = c["d1"], c["d2"], c["d3"], c["dbnh"]
    j = _to_jax
    dbnh_j = j(dbnh)[None, :]
    if form == "packed3_best":
        w1, w2 = _pack(d1, d2, npad, kp), _pack(d3, d1, npad, kp)
        got = match.packed3_best(q1, q2, q3, w1, w2, dbnh)
        want = pm.packed3_best(j(q1), j(q2), j(q3), j(w1), j(w2), dbnh_j,
                               tile_n=tile, interpret=True)
    elif form == "packed2_best":
        w1, w2 = _pack(d1, d2, npad, kp), _pack(d1, d3, npad, kp)
        got = match.packed2_best(q1, q2, w1, w2, dbnh)
        want = pm.packed2_best(j(q1), j(q2), j(w1), j(w2), dbnh_j,
                               tile_n=tile, interpret=True)
    elif form == "packed1w_best":
        w1 = _pack(d1, d2, npad, kp)
        got = match.packed1w_best(q1, q2, w1, dbnh)
        want = pm.packed1w_best(j(q1), j(q2), j(w1), dbnh_j, tile_n=tile,
                                interpret=True)
    elif form == "packed2wn_best":
        w1n = match.add_norm_lanes(_pack(d1, d2, npad, kp), dbnh, l)
        w2 = _pack(d1, d3, npad, kp)
        got = match.packed2wn_best(q1, q2, w1n, w2)
        want = pm.packed2wn_best(j(q1), j(q2), j(w1n), j(w2), tile_n=tile,
                                 interpret=True)
    elif form == "packed1wn_best":
        w1n = match.add_norm_lanes(_pack(d1, d2, npad, kp), dbnh, l)
        got = match.packed1wn_best(q1, q2, w1n)
        want = pm.packed1wn_best(j(q1), j(q2), j(w1n), tile_n=tile,
                                 interpret=True)
    else:  # the main path's packed2k form
        o2 = 2 * l + 3
        wk = torch.zeros((npad, 256), dtype=torch.bfloat16)
        wk[:c["n"], :l], wk[:c["n"], l:2 * l] = d1, d2
        match.add_norm_lanes(wk, dbnh, l)
        wk[:c["n"], o2:o2 + l], wk[:c["n"], o2 + l:o2 + 2 * l] = d1, d3
        m = q1.shape[0]
        qa = torch.zeros((m, 256), dtype=torch.bfloat16)
        qa[:, :l], qa[:, l:2 * l], qa[:, 2 * l:o2] = q1, q1, 1.0
        qa[:, o2:o2 + l], qa[:, o2 + l:o2 + 2 * l] = q2, q1
        got = match.packed_best(qa, wk, (o2 + 2 * l + 15) // 16 * 16)
        want = pm.packed2k_best(j(q1), j(q2), j(wk), tile_n=tile,
                                interpret=True)
    return got, want


@pytest.mark.parametrize("l", [148, 207])
@pytest.mark.parametrize("m,n,npad", [(13, 1000, 1024), (5, 700, 768)])
def test_packed3_past_256_lanes_matches_pallas(l, m, n, npad):
    """packed3_best past 256 lanes, where the card runs packed3w_best.cu:
    2L = 296 of Kp = 384 (L = 148, the video preset's block on RGB
    sources) and 2L = 414 of Kp = 512 (L = 207, super_resolution on RGB
    sources), against the JAX kernel in interpret mode: the same picks,
    values within the stated 1e-5."""
    c = _packed_case(m=m, l=l, n=n, npad=npad)
    assert c["kp"] == (384 if l == 148 else 512)
    assert match._packed3_route(match._lanes(l)) == "packed3w_best"
    before = dict(match.LAUNCHES)
    (idx, val), (ref_i, ref_v) = _run_form("packed3_best", c)
    assert match.LAUNCHES == before  # CPU tensors: plain version only
    np.testing.assert_array_equal(idx.numpy(), _np(ref_i))
    np.testing.assert_allclose(val.numpy(), _np(ref_v), **TOL)
    assert int(idx[2]) == 3  # the duplicate pair: lowest index
    assert int(idx.max()) < n  # padding rows never win


@pytest.mark.parametrize("form", ["packed_best", "packed3_best",
                                  "packed2_best", "packed1w_best",
                                  "packed2wn_best", "packed1wn_best"])
@pytest.mark.parametrize("m,n,npad", [(13, 1000, 1024), (5, 700, 768)])
def test_packed_forms_match_pallas(form, m, n, npad):
    c = _packed_case(m=m, n=n, npad=npad)
    before = dict(match.LAUNCHES)
    (idx, val), (ref_i, ref_v) = _run_form(form, c)
    assert match.LAUNCHES == before  # CPU tensors: plain version only
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), _np(ref_i))
    # norm-in-W forms: the 5e-7 band tests/test_pallas_kernel.py holds
    # them to; the subtract forms: the stated 1e-5
    norm_in_w = form in ("packed_best", "packed2wn_best", "packed1wn_best")
    tol = dict(rtol=0, atol=5e-7) if norm_in_w else TOL
    np.testing.assert_allclose(val.numpy(), _np(ref_v), **tol)
    assert int(idx[2]) == 3  # the duplicate pair: lowest index
    assert int(idx.max()) < n  # padding rows never win


@pytest.mark.parametrize("three", [False, True])
@pytest.mark.parametrize("tile", [128, 256])
def test_packed_champions_match_pallas(three, tile):
    """Per-tile champions of the packed passes, tile-major, with two
    all-padding tiles at the end (700 real rows of 1024)."""
    c = _packed_case(m=17, n=700, npad=1024, seed=7)
    q1, q2, q3, npad, kp = (c[k] for k in ("q1", "q2", "q3", "npad", "kp"))
    d1, d2, d3, dbnh = c["d1"], c["d2"], c["d3"], c["dbnh"]
    j = _to_jax
    if three:
        w1, w2 = _pack(d1, d2, npad, kp), _pack(d3, d1, npad, kp)
        vals, idx = match.packed3_champions(q1, q2, q3, w1, w2, dbnh, tile)
        rv, ri = pm.packed3_champions(j(q1), j(q2), j(q3), j(w1), j(w2),
                                      j(dbnh)[None, :], tile_n=tile,
                                      interpret=True)
    else:
        w1, w2 = _pack(d1, d2, npad, kp), _pack(d1, d3, npad, kp)
        vals, idx = match.packed2_champions(q1, q2, w1, w2, dbnh, tile)
        rv, ri = pm.packed2_champions(j(q1), j(q2), j(w1), j(w2),
                                      j(dbnh)[None, :], tile_n=tile,
                                      interpret=True)
    assert vals.shape == (17, npad // tile)
    np.testing.assert_array_equal(idx.numpy(), _np(ri))
    np.testing.assert_allclose(vals.numpy(), _np(rv), rtol=1e-5, atol=2e-5)
    dead = np.arange(npad // tile) * tile >= 700
    assert np.isneginf(vals.numpy()[:, dead]).all()
    assert (idx.numpy()[:, dead] == np.nonzero(dead)[0] * tile).all()


@pytest.mark.parametrize("three,l", [(False, 232), (False, 256),
                                     (True, 148), (True, 207)])
def test_wide_champions_match_pallas(three, l):
    """The per-tile champions at the widths where the card takes another
    layout, against the JAX kernel in interpret mode: packed2_champions at
    464 and 512 lanes (2L of Kp = 512; 32-row DB tiles on the core) and
    packed3_champions past 256 lanes (2L = 296 of 384, 414 of 512;
    packed3w_best.cu); three all-padding tiles (700 real rows of 1024).
    The same picks, values within 2e-5 as the narrower cases."""
    c = _packed_case(m=9, l=l, n=700, npad=1024, seed=5)
    q1, q2, q3, npad, kp = (c[k] for k in ("q1", "q2", "q3", "npad", "kp"))
    d1, d2, d3, dbnh = c["d1"], c["d2"], c["d3"], c["dbnh"]
    k_used = match._lanes(l)
    assert match._champions_route(k_used, three) == (
        "packed3w_best" if three else "tile_champions")
    assert three or match._core_rows(k_used, 2, 2, True) == 32
    j = _to_jax
    before = dict(match.LAUNCHES)
    if three:
        w1, w2 = _pack(d1, d2, npad, kp), _pack(d3, d1, npad, kp)
        vals, idx = match.packed3_champions(q1, q2, q3, w1, w2, dbnh, 256)
        rv, ri = pm.packed3_champions(j(q1), j(q2), j(q3), j(w1), j(w2),
                                      j(dbnh)[None, :], tile_n=256,
                                      interpret=True)
    else:
        w1, w2 = _pack(d1, d2, npad, kp), _pack(d1, d3, npad, kp)
        vals, idx = match.packed2_champions(q1, q2, w1, w2, dbnh, 256)
        rv, ri = pm.packed2_champions(j(q1), j(q2), j(w1), j(w2),
                                      j(dbnh)[None, :], tile_n=256,
                                      interpret=True)
    assert match.LAUNCHES == before  # CPU tensors: plain version only
    np.testing.assert_array_equal(idx.numpy(), _np(ri))
    np.testing.assert_allclose(vals.numpy(), _np(rv), rtol=1e-5, atol=2e-5)
    dead = np.arange(npad // 256) * 256 >= 700
    assert np.isneginf(vals.numpy()[:, dead]).all()
    assert (idx.numpy()[:, dead] == np.nonzero(dead)[0] * 256).all()
    assert int(idx[2, 0]) == 3  # the duplicate pair (rows 3, 600): lowest


@pytest.mark.parametrize("three", [False, True])
def test_packed_best_is_champions_plus_select(three):
    """The witness: the global champion equals the per-tile champions
    followed by a first-occurrence select over tiles."""
    c = _packed_case(m=13, n=1000, npad=1024, seed=3)
    q1, q2, q3, npad, kp = (c[k] for k in ("q1", "q2", "q3", "npad", "kp"))
    d1, d2, d3, dbnh = c["d1"], c["d2"], c["d3"], c["dbnh"]
    if three:
        w1, w2 = _pack(d1, d2, npad, kp), _pack(d3, d1, npad, kp)
        vals, idx = match.packed3_champions(q1, q2, q3, w1, w2, dbnh, 256)
        bi, bv = match.packed3_best(q1, q2, q3, w1, w2, dbnh)
    else:
        w1, w2 = _pack(d1, d2, npad, kp), _pack(d1, d3, npad, kp)
        vals, idx = match.packed2_champions(q1, q2, w1, w2, dbnh, 256)
        bi, bv = match.packed2_best(q1, q2, w1, w2, dbnh)
    k = torch.argmax(vals, dim=1)
    assert torch.equal(bi, idx.gather(1, k[:, None])[:, 0])
    assert torch.equal(bv, vals.gather(1, k[:, None])[:, 0])


def _bf16_db(n, f=68, fp=128, npad=None, seed=11):
    """A centered bf16 DB (n real rows of npad), its exact fp32 norms and
    half norms (+inf padding rows), duplicate rows 2 and 5 and fp32
    queries, one equal to row 2."""
    rng = np.random.default_rng(seed)
    npad = npad or n
    x = rng.standard_normal((n, f)).astype(np.float32)
    if n > 5:
        x[5] = x[2]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    dbp = torch.zeros((npad, fp), dtype=torch.bfloat16)
    dbp[:n, :f] = xb
    nrm = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    dbn = torch.full((npad,), float("inf"))
    dbn[:n] = torch.from_numpy(nrm)
    q = rng.standard_normal((13, f)).astype(np.float32)
    q[0] = xb[min(2, n - 1)].float().numpy()
    return torch.from_numpy(q), dbp, dbn


@pytest.mark.parametrize("q_split", [False, True])
@pytest.mark.parametrize("n,npad,tile", [(1300, 2048, 256), (512, 512, 128),
                                         (200, 256, 64)])
def test_pertile_matches_pallas(q_split, n, npad, tile):
    q, dbp, dbn = _bf16_db(n, npad=npad)
    dbnh = 0.5 * dbn
    vals, idx = match.pertile_champions_queries(q, dbp, dbnh, tile, q_split)
    rv, ri = pm.pertile_champions_queries(
        _to_jax(q), _to_jax(dbp), _to_jax(dbnh)[None, :], tile_n=tile,
        q_split=q_split, interpret=True)
    assert vals.shape == (13, npad // tile)
    np.testing.assert_array_equal(idx.numpy(), _np(ri))
    np.testing.assert_allclose(vals.numpy(), _np(rv), **TOL)
    assert int(idx[0, 0]) == 2  # in-tile duplicate: first occurrence
    dead = np.arange(npad // tile) * tile >= n
    assert np.isneginf(vals.numpy()[:, dead]).all()


def _argmin2_ref(q, dbp, dbn, q_split, tile=512):
    mp = (q.shape[0] + 15) // 16 * 16
    qp = np.zeros((mp, dbp.shape[1]), np.float32)
    qp[:q.shape[0], :q.shape[1]] = q.numpy()
    return [_np(x)[:q.shape[0]] for x in pm.pallas_argmin2_l2_prepadded(
        jnp.asarray(qp), _to_jax(dbp), _to_jax(dbn)[None, :],
        tile_n=min(tile, dbp.shape[0]), q_split=q_split, interpret=True)]


@pytest.mark.parametrize("q_split", [False, True])
@pytest.mark.parametrize("n,npad", [(1300, 1536), (700, 1024), (1, 512)])
def test_argmin2_matches_pallas(q_split, n, npad):
    q, dbp, dbn = _bf16_db(n, npad=npad)
    i1, v1, i2, v2 = match.argmin2_l2(
        torch.cat([q, torch.zeros((13, 60))], dim=1), dbp, dbn, q_split)
    r1, rv1, r2, rv2 = _argmin2_ref(q, dbp, dbn, q_split)
    np.testing.assert_array_equal(i1.numpy(), r1)
    np.testing.assert_allclose(v1.numpy(), rv1, **TOL)
    np.testing.assert_allclose(v2.numpy(), rv2, **TOL)  # +inf == +inf
    # where no second row exists the index names no real row (it depends
    # on the TPU tile); callers mask it by isfinite(v2)
    has2 = np.isfinite(rv2)
    np.testing.assert_array_equal(i2.numpy()[has2], r2[has2])
    if n == 1:
        _, _, ok2 = match.prepadded_argmin2_queries(q, dbp, dbn, q_split)
        assert not ok2.any() and (i1.numpy() == 0).all()
    else:
        assert int(i1[0]) == 2 and int(i2[0]) == 5  # duplicates, in order
        assert has2.all() and int(i1.max()) < n


@pytest.mark.parametrize("trip", [(3, 250, 251), (0, 511, 512), (5, 6, 7)])
def test_argmin2_exact_ties_stay_lowest_index(trip):
    """Three identical best rows: the top-2 are the two lowest, in order,
    across a tile boundary too (tests/test_pallas_kernel.py's case)."""
    q, dbp, dbn = _bf16_db(700, npad=1024, seed=21)
    for r in trip:
        dbp[r] = dbp[2]
        dbn[r] = dbn[2]
    q[0] = dbp[2, :68].float()
    i1, _, i2, _ = match.argmin2_l2(
        torch.cat([q, torch.zeros((13, 60))], dim=1), dbp, dbn)
    r1, _, r2, _ = _argmin2_ref(q, dbp, dbn, False)
    a, b = sorted(set(trip) | {2})[:2]
    assert (int(i1[0]), int(i2[0])) == (a, b) == (r1[0], r2[0])


def test_scan_queries_round_where_jax_rounds():
    """The _1p query cast and the q_split lo half ROUND to bf16 (JAX
    .astype); the hi half is the exact truncation."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32))
    one = match._scan_queries(q, False)
    assert torch.equal(one, q.to(torch.bfloat16))
    two = match._scan_queries(q, True)
    hi, lo = match.bf16_split2(q)
    assert torch.equal(two[:8].float(), hi)
    assert torch.equal(two[8:], lo.to(torch.bfloat16))
    assert not torch.equal(two[:8], one)  # truncation differs from rounding


def test_new_wrappers_check_their_operands():
    bf = torch.bfloat16
    qa, w = torch.zeros((4, 128), dtype=bf), torch.zeros((64, 128), dtype=bf)
    with pytest.raises(ValueError, match="packed forms"):
        match.packed_best(qa, w, dbnh=torch.zeros(64))  # no such form
    with pytest.raises(ValueError, match="qb and w2"):
        match.packed_best(qa, w, w2=w)
    with pytest.raises(ValueError, match="dbnh"):
        match.packed_best(qa, w, dbnh=torch.zeros(10), fold_a=True)
    with pytest.raises(ValueError):
        match.pertile_champions(torch.zeros((4, 100)), w, torch.zeros(64),
                                64)
    with pytest.raises(ValueError):
        match.argmin2_l2(torch.zeros((4, 128)), w.float(), torch.zeros(64))
    with pytest.raises(ValueError, match="multiple of 64"):
        match._check_tile("pertile_champions", 96, 192)
