"""The port's CUDA kernels and main path on the card, held against their
plain PyTorch versions.

Every test here is marked ``cuda`` and skips where there is no card (CUDA
kernels have no CPU mode).  The file imports only torch, numpy and the
port, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch import AnalogyParams, create_image_analogy
from image_analogies_tpu_torch.backends.cuda import (
    CudaMatcher, pack_w12, pack_wk, packed_shift_and_halfnorm)
from image_analogies_tpu_torch.ops import match
from image_analogies_tpu_torch.utils.assets import make_structured
from image_analogies_tpu_torch.utils.ssim import ssim


def argmin_inputs(m=13, f=68, n=900, npad=1024, fp=128, seed=3,
                  dup=(40, 700)):
    """Seeded argmin operands: lane-padded DB with a duplicate row pair
    (``dup``, by default in different 512-row tiles), +inf-norm padding
    rows, and queries equal to (and near) the duplicated row."""
    rng = np.random.default_rng(seed)
    db = np.zeros((npad, fp), np.float32)
    db[:n, :f] = rng.standard_normal((n, f)).astype(np.float32)
    db[dup[1]] = db[dup[0]]
    q = rng.standard_normal((m, f)).astype(np.float32)
    q[0] = db[dup[0], :f]
    q[1:2] = db[dup[0], :f] + 1e-3
    dbn = np.full((npad,), np.inf, np.float32)
    dbn[:n] = (db[:n] ** 2).sum(1)
    return q, db, dbn


def packed_inputs(m=13, l=55, n=1000, seed=0, dup=(3, 600)):
    """Seeded live-dim rows (one exact duplicate pair, rows ``dup``) and
    queries, query min(2, m - 1) equal to the duplicated row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, l)) * 0.1).astype(np.float32)
    x[dup[1]] = x[dup[0]]
    q = (rng.standard_normal((m, l)) * 0.1).astype(np.float32)
    q[min(2, m - 1)] = x[dup[0]]
    return x, q


def query_rows(q1, q2, kp):
    """The packed query rows [q1|q1|1 1 1|q2|q1|0] (backends/cuda.py)."""
    m, l = q1.shape
    return torch.cat([
        q1, q1, torch.ones((m, 3), dtype=torch.bfloat16, device=q1.device),
        q2, q1, torch.zeros((m, kp - 4 * l - 3), dtype=torch.bfloat16,
                            device=q1.device)], dim=1).contiguous()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,npad,f,fp", [
    # every query-instance edge (1, 24 = level 4, 32, 33, 88 = level 2) and
    # two query chunks (130), against one partial tile, 4,096 rows (the
    # last 296 padding: all-padding DB chunks) and 65,536 rows (the last
    # 1,536 padding: all-padding chunks)
    *[(m, n, npad, 68, 128) for m in (1, 24, 32, 33, 88, 130)
      for n, npad in ((99, 99), (3800, 4096), (64000, 65536))],
    (2, 900, 1024, 68, 128),
    (37, 900, 1024, 68, 128),
    (33, 3800, 4096, 67, 128),  # F not a multiple of 4
    (130, 64000, 65536, 67, 128),
    (88, 3800, 4096, 300, 384),  # five k slabs per tile
    # two query chunks: shared memory caps a block at 72 queries
    (88, 3800, 4096, 520, 640),
])
def test_cuda_argmin_matches_plain(m, n, npad, f, fp):
    """The fp32 argmin kernel against its plain version: the same picks,
    scores within 1e-5; duplicate rows in different blocks go to the lower
    index; padding rows never win; a call right after one of another M and
    N (the merge workspace and ticket come back reset); ten repeated calls
    give the same bits."""
    dev = _card()
    dup = (40, n - 60) if n > 100 else (40, 80)
    args = [torch.from_numpy(a).to(dev) for a in argmin_inputs(
        m=m, f=f, n=n, npad=npad, fp=fp, dup=dup)]
    plan = match._argmin_plan(
        m, npad, match._sm_count(match._device_index(args[0])), f)
    if npad >= 4096:  # the kernel's blocks: dup rows apart, a padding chunk
        rows = plan.tiles_per_chunk * plan.rows
        assert dup[0] // rows != dup[1] // rows
        assert (plan.n_chunks - 1) * rows >= n
    other = [torch.from_numpy(a).to(dev) for a in argmin_inputs(
        m=m % 17 + 5, f=f, n=500, npad=640, fp=fp, seed=4, dup=(40, 400))]
    match.argmin_l2(*other)
    match.reset_launch_counts()
    idx, score = match.argmin_l2(*args)
    ref_i, ref_s = match.argmin_l2_plain(*args)
    assert match.LAUNCHES["argmin_l2"] == 1
    assert torch.equal(idx, ref_i) and int(idx[0]) == dup[0]
    assert int(idx.max()) < n
    torch.testing.assert_close(score, ref_s, rtol=1e-5, atol=1e-5)
    for _ in range(10):
        again_i, again_s = match.argmin_l2(*args)
        assert torch.equal(again_i, idx)
        assert torch.equal(again_s.view(torch.int32), score.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,npad", [
    (21, 1000, 1024), (200, 1000, 1088),
    # every warpgroup edge of the query tiles (up to three warpgroups of
    # 64 rows, 192 rows a tile; the later ones skipped where the tile has
    # no rows for them), the wavefront's widths (48-176 at level 1, 88-344
    # at level 0), against N past a 64-row tile edge (the box past the end
    # reads zeros, which would score 0 and win)
    *[(m, 1000, 1100) for m in (1, 48, 64, 65, 88, 128, 129, 176, 192, 193,
                                256, 344)],
    # many tiles a block, the duplicate rows in different chunks
    (48, 69000, 70000), (344, 69000, 70000),
])
def test_cuda_packed_best_matches_plain(m, n, npad):
    """The packed2k kernel against its plain version: the same picks,
    scores within 1e-6; the duplicate rows go to the lower index; padding
    rows and rows past N never win; ten repeated calls give the same
    bits."""
    dev = _card()
    dup = (3, 600) if n <= 1000 else (3, n - 60)
    x, qv = packed_inputs(m=m, n=n, dup=dup)
    l = qv.shape[1]
    xt = torch.from_numpy(x).to(dev)
    wk, _ = pack_wk(xt, torch.zeros(l, device=dev), 0.5 * (xt * xt).sum(1),
                    torch.arange(l, device=dev), npad)
    g1, g2, _ = match.bf16_split3(torch.from_numpy(qv).to(dev))
    qa = query_rows(g1.to(torch.bfloat16), g2.to(torch.bfloat16),
                    wk.shape[1])
    plan = match._packed2k_plan(m, npad, match._sm_count(
        match._device_index(qa)), 224)
    rows = plan.tiles_per_chunk * 64
    assert dup[0] // rows != dup[1] // rows  # in different blocks
    match.reset_launch_counts()
    idx, val = match.packed_best(qa, wk, 224)
    ref_i, ref_v = match.packed_best_plain(qa, wk, 224)
    assert match.LAUNCHES["packed_best"] == 1
    assert torch.equal(idx, ref_i) and int(idx[min(2, m - 1)]) == dup[0]
    assert int(idx.max()) < n
    torch.testing.assert_close(val, ref_v, rtol=0, atol=1e-6)
    for _ in range(10):
        again_i, again_v = match.packed_best(qa, wk, 224)
        assert torch.equal(again_i, idx)
        assert torch.equal(again_v.view(torch.int32), val.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("l", [13, 100, 127])
def test_cuda_packed_best_other_lane_widths(l):
    """The packed2k kernel at the other lane widths the level builds give:
    K = 128 (4 k steps, three warpgroups, a ring of 8 stages), K = 512
    with 26 k steps (two warpgroups, 2 stages) and with all 32 (two, 1
    stage: their resident queries leave room for one tile), against its
    plain version, four DB tiles a block.  Scores within 1e-5
    (chip_smoke.py's PACKED_ATOL): up to 512 products a score, summed by
    the tensor cores and by the plain fp32 product in other orders."""
    dev = _card()
    x, qv = packed_inputs(m=70, l=l, n=30000, dup=(3, 29900))
    xt = torch.from_numpy(x).to(dev)
    wk, _ = pack_wk(xt, torch.zeros(l, device=dev), 0.5 * (xt * xt).sum(1),
                    torch.arange(l, device=dev), 31000)
    g1, g2, _ = match.bf16_split3(torch.from_numpy(qv).to(dev))
    qa = query_rows(g1.to(torch.bfloat16), g2.to(torch.bfloat16),
                    wk.shape[1])
    k_used = (4 * l + 3 + 15) // 16 * 16
    plan = match._packed2k_plan(70, 31000, 132, k_used)
    assert plan.stages == {13: 8, 100: 2, 127: 1}[l]
    assert plan.consumers == {13: 3, 100: 2, 127: 2}[l]
    assert plan.tiles_per_chunk == 4
    match.reset_launch_counts()
    idx, val = match.packed_best(qa, wk, k_used)
    ref_i, ref_v = match.packed_best_plain(qa, wk, k_used)
    assert match.LAUNCHES["packed_best"] == 1
    assert torch.equal(idx, ref_i) and int(idx[2]) == 3
    assert int(idx.max()) < 30000
    torch.testing.assert_close(val, ref_v, rtol=0, atol=1e-5)


def _packed2k_case(dev, m, l, n, npad, dup):
    """Seeded packed2k operands on the card: (qa, wk, k_used).  The
    duplicate row gets its twin's half norm: the card's row sums of two
    equal rows of odd length may round apart (their alignments differ)."""
    x, qv = packed_inputs(m=m, l=l, n=n, dup=dup)
    xt = torch.from_numpy(x).to(dev)
    half_norm = 0.5 * (xt * xt).sum(1)
    half_norm[dup[1]] = half_norm[dup[0]]
    wk, _ = pack_wk(xt, torch.zeros(l, device=dev), half_norm,
                    torch.arange(l, device=dev), npad)
    g1, g2, _ = match.bf16_split3(torch.from_numpy(qv).to(dev))
    qa = query_rows(g1.to(torch.bfloat16), g2.to(torch.bfloat16),
                    wk.shape[1])
    return qa, wk, (4 * l + 3 + 15) // 16 * 16


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,npad,l", [
    (m, n, npad, l)
    # L = 148 (RGB sources with the temporal block: 608 lanes), 171 and
    # 207 (super_resolution on RGB sources: 688 at its coarsest level, 832)
    # and 256 (the same with the temporal block: 1,040, 32-row tiles)
    for l in (148, 171, 207, 256)
    # one query, a few; the second warpgroup of a block idle (63, 64), one
    # row of it live (65), some (70), all but one (127) or all (128) of it
    # live, a second query tile of one row (129); the widest level-0 batch
    # (352: three query tiles of 118 rows)
    for m in (1, 5, 63, 64, 65, 70, 127, 128, 129, 352)
    # N past a 32-row tile edge (a ragged last tile) with padding rows in
    # the last tiles, and many chunks with the duplicate rows in different
    # ones and all-padding last tiles
    for n, npad in ((1000, 1100), (69000, 72000))])
def test_cuda_packed2kw_matches_plain(m, n, npad, l):
    """packed2k past 512 lanes (packed2kw_best.cu, by the width rule)
    against its plain version on the card: one launch a call, scores within
    4e-5 (the tensor cores' fp32 sum over 38-65 k steps), picks equal
    outside that band; the duplicate rows go to the lower index; padding
    rows and rows past N never win; ten repeated calls give the same
    bits."""
    dev = _card()
    dup = (3, 600) if n <= 1000 else (3, n - 60)
    qa, wk, k_used = _packed2k_case(dev, m, l, n, npad, dup)
    assert match._packed2k_route(k_used) == "packed2kw_best"
    plan = match._packed2kw_plan(m, npad, match._sm_count(
        match._device_index(qa)), k_used)
    assert (plan.consumers, plan.rows) == (2, 32)
    if n > 10000:
        chunk = plan.tiles_per_chunk * plan.rows
        assert dup[0] // chunk != dup[1] // chunk
        assert npad - n >= plan.rows
    else:
        assert npad % plan.rows and npad - n >= plan.rows
    match.reset_launch_counts()
    idx, val = match.packed_best(qa, wk, k_used)
    assert match.LAUNCHES["packed2kw_best"] == 1
    assert sum(match.LAUNCHES.values()) == 1
    ref_i, ref_v = match.packed_best_plain(qa, wk, k_used)
    _assert_band("packed2kw_best", idx.cpu(), val.cpu(), ref_i.cpu(),
                 ref_v.cpu(), atol=4e-5, band=4e-5)
    if m > 2:
        assert int(idx[2]) == dup[0]
    assert int(idx.max()) < n
    for _ in range(10):
        again_i, again_v = match.packed_best(qa, wk, k_used)
        assert torch.equal(again_i, idx)
        assert torch.equal(again_v.view(torch.int32), val.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("l", [73, 80, 87, 91])
@pytest.mark.parametrize("m", [176, 344])
def test_cuda_packed2k_mode_widths_at_level_size(l, m):
    """The packed2k kernel at the widths the modes reach (super_resolution
    304 lanes at its coarsest level and 368 at level 0, the video preset's
    temporal block 336, texture_by_numbers' RGB labels 352) at a 512^2
    level's N = 2^18, against its plain version: scores within 1e-5, picks
    equal outside 2e-5, the duplicate rows (in different chunks) to the
    lower index, padding rows never win."""
    dev = _card()
    npad = 262144
    n = npad - 1000
    qa, wk, k_used = _packed2k_case(dev, m, l, n, npad, (3, n - 60))
    assert k_used in (304, 336, 352, 368)
    assert match._packed2k_route(k_used) == "packed_best"
    match.reset_launch_counts()
    idx, val = match.packed_best(qa, wk, k_used)
    assert match.LAUNCHES["packed_best"] == 1
    ref_i, ref_v = match.packed_best_plain(qa, wk, k_used)
    _assert_band("packed_best", idx.cpu(), val.cpu(), ref_i.cpu(),
                 ref_v.cpu(), atol=1e-5, band=2e-5)
    assert int(idx[2]) == 3 and int(idx.max()) < n


@pytest.mark.cuda
def test_cuda_packed2kw_refuses_what_it_does_not_take():
    """The C entry of packed2kw_best.cu refuses k_used at or below 512 or
    past 1,152, K past 1,152, a plan of one or three consumer warpgroups,
    register k steps other than the kernel's rule, and shared memory short
    of the plan's; the wrapper refuses K past 1,152 before any launch."""
    dev = _card()
    lib = match._build.load("packed2kw_best")
    m, n = 8, 256
    q = torch.zeros((m, 1152), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((n, 1152), dtype=torch.bfloat16, device=dev)
    part_val, out_val = (torch.empty((n, m), device=dev) for _ in range(2))
    part_idx, out_idx = (torch.empty((n, m), dtype=torch.int32, device=dev)
                         for _ in range(2))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(k, k_used, **change):
        plan = match._packed2kw_plan(m, n, 132, max(528, min(k_used, 1152)))
        plan = plan._replace(**change)
        return lib.ia_packed2kw_best(
            q.data_ptr(), w.data_ptr(), m, n, k, k_used, plan.reg_ksteps,
            plan.consumers, plan.bm, plan.stages, plan.tiles_per_chunk,
            plan.smem, plan.n_chunks, part_val.data_ptr(),
            part_idx.data_ptr(), out_idx.data_ptr(), out_val.data_ptr(),
            match._device_index(q), stream)

    assert call(1152, 528) == 0 and call(1152, 1040) == 0
    torch.cuda.synchronize()
    for k, k_used in ((1152, 512), (1152, 1168), (1280, 1040), (512, 528)):
        assert call(k, k_used) != 0, (k, k_used)
    reg = match._packed2kw_layout(832)[0]
    assert call(1152, 832) == 0
    for change in (dict(consumers=1), dict(consumers=3),
                   dict(reg_ksteps=reg - 1), dict(reg_ksteps=reg + 1),
                   dict(smem=match._packed2kw_smem(832, reg, 3) - 1024)):
        assert call(1152, 832, **change) != 0, change
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        match.packed_best(torch.zeros((m, 1280), dtype=torch.bfloat16,
                                      device=dev),
                          torch.zeros((n, 1280), dtype=torch.bfloat16,
                                      device=dev), 1040)


@pytest.mark.cuda
def test_cuda_rgb_superres_runs_packed2kw_on_its_path():
    """super_resolution on RGB sources with ``color_mode="source_rgb"`` and
    exact_hi2_2p at 48^2 (two levels: 832 and 688 lanes) on the card:
    packed2kw_best once per wavefront step, no other kernel, and the source
    map within the card-vs-CPU limits of the CPU run."""
    from image_analogies_tpu_torch import modes

    _card()
    gray = make_structured(48, 7)
    sharp, low = (np.stack([x, x * x, 1 - x], -1).astype(np.float32)
                  for x in (gray[1], gray[2]))
    kw = dict(color_mode="source_rgb", match_mode="exact_hi2_2p")
    match.reset_launch_counts()
    card = modes.super_resolution(sharp, low, **kw)
    steps = sum(4 * (h - 1) + h for h in (48, 24))
    assert match.LAUNCHES["packed2kw_best"] == steps
    assert sum(match.LAUNCHES.values()) == steps
    cpu = modes.super_resolution(sharp, low, device="cpu", **kw)
    assert float((card.source_map != cpu.source_map).mean()) < 0.02
    assert ssim(card.bp_y, cpu.bp_y) >= 0.99


@pytest.mark.cuda
def test_cuda_wrappers_refuse_mixed_devices():
    dev = _card()
    q, db, dbn = (torch.from_numpy(a) for a in argmin_inputs())
    with pytest.raises(ValueError):
        match.argmin_l2(q.to(dev), db, dbn.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("match_mode", ["exact_hi", "exact_hi2_2p"])
def test_cuda_main_path_matches_cpu_run(match_mode):
    """The whole slice on the card against the same slice on the CPU (the
    plain versions): same output up to fp ties."""
    _card()
    a, ap, b = make_structured(48, 7)
    params = AnalogyParams(levels=3, kappa=5.0, match_mode=match_mode)
    match.reset_launch_counts()
    gpu = create_image_analogy(a, ap, b, params)
    name = "packed_best" if match_mode == "exact_hi2_2p" else "argmin_l2"
    assert match.LAUNCHES[name] > 0
    cpu = create_image_analogy(a, ap, b, params, device="cpu")
    assert gpu.bp_y.shape == (48, 48) and np.isfinite(gpu.bp_y).all()
    assert (gpu.source_map != cpu.source_map).mean() < 0.02
    assert ssim(gpu.bp_y, cpu.bp_y) >= 0.99


# --------------------------------------- the bf16 scan template's entries


def _bf16(x):
    return x.to(torch.bfloat16)


def scan_case(n=1000, npad=1024, m=21, l=55, f=68, seed=5, dev="cpu",
              kp=128, fp=128, dup=600):
    """Seeded operands of every bf16 scan entry on ``dev``: packed weights
    W1 = [d1|d2], W2 = [d3|d1] / [d1|d3] of ``kp`` lanes, the K-wide wk,
    half norms with +inf padding rows, the bf16 centered DB of ``fp`` lanes
    with full norms, and queries — with an exact duplicate pair (rows 3 and
    ``dup``, or 2 and 5 in the bf16 DB) that query 2 (0) hits.  The bf16 DB
    and its queries are scaled so their norms do not grow with ``f``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, l), generator=g) * 0.1
    x[dup % n] = x[3 % n]
    q = torch.randn((m, l), generator=g) * 0.1
    q[2] = x[3 % n]
    d1, d2, d3 = (_bf16(v) for v in match.bf16_split3(x))
    q1, q2, q3 = (_bf16(v) for v in match.bf16_split3(q))
    scale = (68 / f) ** 0.5

    def pack(a, b):
        w = torch.zeros((npad, kp), dtype=torch.bfloat16)
        w[:n, :l], w[:n, l:2 * l] = a, b
        return w

    dbnh = torch.full((npad,), float("inf"))
    dbnh[:n] = 0.5 * (x * x).sum(1)
    db = torch.randn((n, f), generator=g) * scale
    db[5 % n] = db[2 % n]
    dbp = torch.zeros((npad, fp), dtype=torch.bfloat16)
    dbp[:n, :f] = _bf16(db)
    dbn = torch.full((npad,), float("inf"))
    dbn[:n] = (db * db).sum(1)
    qf = torch.zeros((m, fp))
    qf[:, :f] = torch.randn((m, f), generator=g) * scale
    qf[0, :f] = dbp[2 % n, :f].float()
    out = dict(q1=q1, q2=q2, q3=q3, w12=pack(d1, d2), w31=pack(d3, d1),
               w13=pack(d1, d3), dbnh=dbnh, dbp=dbp, dbn=dbn, qf=qf)
    if 2 * l + 3 <= kp:  # room for the norm lanes
        out["w12n"] = match.add_norm_lanes(pack(d1, d2), dbnh, l)
    return {k: v.to(dev) for k, v in out.items()}


def _form_call(form, c):
    q1, q2, q3 = c["q1"], c["q2"], c["q3"]
    return {
        "packed3_best": lambda: match.packed3_best(
            q1, q2, q3, c["w12"], c["w31"], c["dbnh"]),
        "packed2_best": lambda: match.packed2_best(
            q1, q2, c["w12"], c["w13"], c["dbnh"]),
        "packed1w_best": lambda: match.packed1w_best(
            q1, q2, c["w12"], c["dbnh"]),
        "packed2wn_best": lambda: match.packed2wn_best(
            q1, q2, c["w12n"], c["w13"]),
        "packed1wn_best": lambda: match.packed1wn_best(q1, q2, c["w12n"]),
    }[form]


def _assert_band(name, idx, val, ref_idx, ref_val, atol=1e-5, band=2e-5):
    """Scores within ``atol``; picks equal except where the kernel's pick
    scores within ``band`` of the plain version's best."""
    torch.testing.assert_close(val, ref_val, rtol=0, atol=atol)
    bad = (idx != ref_idx) & ((val - ref_val).abs() > band)
    assert not bool(bad.any()), name


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed3_best", "packed2_best",
                                  "packed1w_best", "packed2wn_best",
                                  "packed1wn_best"])
@pytest.mark.parametrize("m,n,npad", [(21, 1000, 1024), (200, 1000, 1088)])
def test_cuda_packed_forms_match_plain(form, m, n, npad):
    dev = _card()
    cpu = scan_case(n=n, npad=npad, m=m)
    card = {k: v.to(dev) for k, v in cpu.items()}
    match.reset_launch_counts()
    idx, val = _form_call(form, card)()
    assert match.LAUNCHES[form] == 1
    ref_i, ref_v = _form_call(form, cpu)()  # the plain version
    _assert_band(form, idx.cpu(), val.cpu(), ref_i, ref_v)
    assert int(idx[2]) == 3 and int(idx.max()) < n


@pytest.mark.cuda
@pytest.mark.parametrize("three", [False, True])
def test_cuda_packed_champions_match_plain(three):
    dev = _card()
    cpu = scan_case(n=700, npad=1024, m=37)
    card = {k: v.to(dev) for k, v in cpu.items()}

    def run(c):
        if three:
            return match.packed3_champions(c["q1"], c["q2"], c["q3"],
                                           c["w12"], c["w31"], c["dbnh"], 128)
        return match.packed2_champions(c["q1"], c["q2"], c["w12"], c["w13"],
                                       c["dbnh"], 128)

    match.reset_launch_counts()
    vals, idx = run(card)
    assert match.LAUNCHES["packed_champions"] == 1
    rv, ri = run(cpu)
    finite = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(vals.cpu()), finite)
    _assert_band("packed_champions", idx.cpu()[finite], vals.cpu()[finite],
                 ri[finite], rv[finite])
    assert torch.equal(idx.cpu()[~finite], ri[~finite])  # all-padding tiles


@pytest.mark.cuda
@pytest.mark.parametrize("q_split", [False, True])
@pytest.mark.parametrize("n,npad,tile", [(1000, 1024, 256), (700, 1024, 128),
                                         (200, 256, 64)])
def test_cuda_pertile_matches_plain(q_split, n, npad, tile):
    dev = _card()
    cpu = scan_case(n=n, npad=npad, m=45)
    args = [cpu[k] for k in ("qf", "dbp", "dbnh")]
    match.reset_launch_counts()
    vals, idx = match.pertile_champions(*[a.to(dev) for a in args], tile,
                                        q_split, 80)
    assert match.LAUNCHES["pertile_champions"] == 1
    rv, ri = match.pertile_champions(*args, tile, q_split, 80)
    finite = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(vals.cpu()), finite)
    _assert_band("pertile", idx.cpu()[finite], vals.cpu()[finite],
                 ri[finite], rv[finite], atol=1e-4, band=1e-4)
    assert torch.equal(idx.cpu()[~finite], ri[~finite])
    assert int(idx[0, 0]) == 2  # duplicate rows 2 and 5: first occurrence


@pytest.mark.cuda
@pytest.mark.parametrize("q_split", [False, True])
@pytest.mark.parametrize("m,n,npad,tile,f,fp", [
    # the widest wavefront segment of each of npr_1024's five levels at its
    # scan tile (``scan_tile_rows``), the last 100 rows padding: 256 scan
    # tiles in place at level 0, 16-64 split in parts at levels 1-3, 16 in
    # place at level 4
    (352, 1048476, 1048576, 4096, 68, 128),
    (176, 262044, 262144, 4096, 68, 128),
    (88, 65436, 65536, 4096, 68, 128), (48, 16284, 16384, 1024, 68, 128),
    (24, 3996, 4096, 256, 68, 128),
    # the shapes of test_cuda_pertile_matches_plain (the 64-row tile takes
    # the 64-row DB tiles)
    (45, 1000, 1024, 256, 68, 128), (45, 700, 1024, 128, 68, 128),
    (45, 200, 256, 64, 68, 128),
    # all-padding scan tiles: the last three (in place) and the last of 16
    # split in 8 parts, whose merge keeps (-inf, the tile's first row)
    (45, 600, 1024, 128, 68, 128), (88, 60000, 65536, 4096, 68, 128),
    # 256 lanes: 128-row DB tiles, and 64-row ones at a 192-row scan tile;
    # past 256 lanes (the wide bf16 scans' lanes) 64-row tiles, one
    # consumer warpgroup folded at 512
    (70, 3000, 3072, 1024, 256, 256), (70, 3000, 3072, 192, 250, 256),
    (45, 1000, 1024, 256, 300, 384), (45, 1000, 1024, 256, 450, 512)])
def test_cuda_pertile_hopper_matches_plain(q_split, m, n, npad, tile, f, fp):
    """pertile_champions on the Hopper core (pertile_champions.cu) against
    its plain version on the card: one launch a call, finite champions
    within 1e-4 of plain and their picks equal outside the 1e-4 band (the
    tolerance of the other pertile card tests), every all-padding tile
    -inf at its first row, duplicate rows in one thread and across threads
    go to the lower index in their tile, the pair across DB chunks each win
    their own tile, the same bits split in parts or not and whether the C
    entry or ``_scan_queries`` makes the bf16 query block, and ten
    repeated calls give the same bits."""
    dev = _card()
    q, dbp, dbn = (t.to(dev) for t in argmin2_case(m, n, npad, f, fp))
    dbnh = 0.5 * dbn
    k_used = (f + 15) // 16 * 16
    match.reset_launch_counts()
    vals, idx = match.pertile_champions(q, dbp, dbnh, tile, q_split, k_used)
    assert match.LAUNCHES["pertile_champions"] == 1
    for _ in range(10):
        again = match.pertile_champions(q, dbp, dbnh, tile, q_split, k_used)
        assert torch.equal(again[1], idx) and torch.equal(
            again[0].view(torch.int32), vals.view(torch.int32))
    plan = match._pertile_plan(m, npad, match._sm_count(
        match._device_index(q)), k_used, q_split, tile)
    whole = match._pertile_plan(m, npad, match._sm_count(
        match._device_index(q)), k_used, q_split, tile, parts=1)
    # the same bits whatever the split, and from the bf16 query block made
    # by the wrapper's plain split (``_scan_queries``) as from the entry's
    qk = match._scan_queries(q, q_split).contiguous()
    for other in {plan, whole}:
        got = match._pertile_launch(q, dbp, dbnh, tile, k_used, q_split,
                                    other)
        assert torch.equal(got[1], idx) and torch.equal(
            got[0].view(torch.int32), vals.view(torch.int32))
    got = match._pertile_launch(qk, dbp, dbnh, tile, k_used, q_split, plan)
    assert torch.equal(got[1], idx) and torch.equal(
        got[0].view(torch.int32), vals.view(torch.int32))
    rv, ri = (t.cpu() for t in match.pertile_champions_plain(
        q, dbp, dbnh, tile, q_split, k_used))
    vals, idx = vals.cpu(), idx.cpu()
    finite = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(vals), finite)
    _assert_band("pertile", idx[finite], vals[finite], ri[finite],
                 rv[finite], atol=1e-4, band=1e-4)
    first = torch.arange(0, npad, tile, dtype=torch.int32)[:, None]
    pad = ~finite
    assert bool((vals[pad] == float("-inf")).all())
    assert torch.equal(idx[pad], first.expand_as(idx)[pad])
    assert bool(pad.any()) == (npad - n >= tile)
    assert bool(((idx >= first) & (idx < first + tile)).all())
    assert int(idx[finite].max()) < n
    # queries 0, 1, 2 equal rows 2 (twin 10), 3 (twin 5) and 1 (twin
    # n - 1, in the last real tile)
    assert [int(idx[0, r]) for r in range(3)] == [2, 3, 1]
    assert int(idx[(n - 1) // tile, 2]) == n - 1


@pytest.mark.cuda
@pytest.mark.parametrize("q_split", [False, True])
@pytest.mark.parametrize("n,npad", [(1000, 1024), (700, 1088), (1, 256)])
def test_cuda_argmin2_matches_plain(q_split, n, npad):
    dev = _card()
    cpu = scan_case(n=n, npad=npad, m=45)
    args = [cpu[k] for k in ("qf", "dbp", "dbn")]
    match.reset_launch_counts()
    i1, v1, i2, v2 = (t.cpu() for t in match.argmin2_l2(
        *[a.to(dev) for a in args], q_split, 80))
    assert match.LAUNCHES["argmin2_l2"] == 1
    r1, rv1, r2, rv2 = match.argmin2_l2(*args, q_split, 80)
    _assert_band("argmin2 first", i1, v1, r1, rv1, atol=1e-4, band=1e-4)
    has2 = torch.isfinite(rv2)
    assert torch.equal(torch.isfinite(v2), has2)
    _assert_band("argmin2 second", i2[has2], v2[has2], r2[has2], rv2[has2],
                 atol=1e-4, band=1e-4)
    if n > 5:
        assert (int(i1[0]), int(i2[0])) == (2, 5)
    else:
        assert not bool(has2.any()) and int(i1.max()) == 0
        # no second real row: the lowest padding row takes second place
        assert bool((i2 == n).all())


def argmin2_case(m, n, npad, f=68, fp=128, seed=9):
    """Seeded operands of ``argmin2_l2`` at any size: the bf16 DB of ``fp``
    lanes (``f`` used, rows [n, npad) padding with +inf norms) with full
    norms of the unrounded rows, and queries.  Exact duplicate pairs: rows
    2 and 10 (one thread's columns of a tile), 3 and 5 (two threads'), 1
    and n - 1 (different DB chunks once n spans chunks); queries 0, 1 and 2
    equal the bf16 rows 2, 3 and 1.  Scaled so the norms do not grow with
    ``f``."""
    g = torch.Generator().manual_seed(seed)
    scale = (68 / f) ** 0.5
    db = torch.randn((n, f), generator=g) * scale
    q = torch.zeros((m, fp))
    q[:, :f] = torch.randn((m, f), generator=g) * scale
    if n > 10:
        for lo, hi in ((2, 10), (3, 5), (1, n - 1)):
            db[hi] = db[lo]
    dbp = torch.zeros((npad, fp), dtype=torch.bfloat16)
    dbp[:n, :f] = _bf16(db)
    dbn = torch.full((npad,), float("inf"))
    dbn[:n] = (db * db).sum(1)
    if n > 10:
        for row, src in enumerate((2, 3, 1)[:m]):
            q[row, :f] = dbp[src, :f].float()
    return q, dbp, dbn


@pytest.mark.cuda
@pytest.mark.parametrize("q_split", [False, True])
@pytest.mark.parametrize("m,n,npad,f,fp", [
    # the widest wavefront segment of each of npr_1024's five levels, the
    # last 100 rows padding
    (344, 1048476, 1048576, 68, 128), (176, 262044, 262144, 68, 128),
    (88, 65436, 65536, 68, 128), (48, 16284, 16384, 68, 128),
    (24, 3996, 4096, 68, 128),
    # N not a multiple of 64 (the ragged last tile reads its norms from
    # global memory), at every lane width the wrapper takes: one consumer
    # warpgroup and one or two stages at 384 and 512 folded lanes
    (45, 1000, 1000, 68, 128), (200, 3001, 3041, 200, 256),
    (130, 2000, 2003, 300, 384), (70, 1500, 1500, 450, 512),
    # one real row: the second place is (+inf, the lowest padding row)
    (45, 1, 256, 68, 128), (3, 1, 5000, 68, 128)])
def test_cuda_argmin2_hopper_matches_plain(q_split, m, n, npad, f, fp):
    """argmin2_l2 on the Hopper core against its plain version on the card:
    scores within 1e-4, picks equal outside the 1e-4 band, duplicate rows
    in one thread, across threads and across DB chunks go to the lower
    index, padding rows never place unless no real row is left, and ten
    repeated calls give the same bits."""
    dev = _card()
    q, dbp, dbn = (t.to(dev) for t in argmin2_case(m, n, npad, f, fp))
    k_used = (f + 15) // 16 * 16
    match.reset_launch_counts()
    got = match.argmin2_l2(q, dbp, dbn, q_split, k_used)
    assert match.LAUNCHES["argmin2_l2"] == 1
    for _ in range(10):
        again = match.argmin2_l2(q, dbp, dbn, q_split, k_used)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    i1, v1, i2, v2 = (t.cpu() for t in got)
    r1, rv1, r2, rv2 = (t.cpu() for t in match.argmin2_l2_plain(
        q, dbp, dbn, q_split, k_used))
    _assert_band("argmin2 first", i1, v1, r1, rv1, atol=1e-4, band=1e-4)
    has2 = torch.isfinite(rv2)
    assert torch.equal(torch.isfinite(v2), has2)
    _assert_band("argmin2 second", i2[has2], v2[has2], r2[has2], rv2[has2],
                 atol=1e-4, band=1e-4)
    if n > 10:
        assert int(torch.maximum(i1, i2).max()) < n
        assert [(int(i1[r]), int(i2[r])) for r in range(3)] == [
            (2, 10), (3, 5), (1, n - 1)]
    else:
        assert int(i1.max()) == 0 and not bool(has2.any())
        assert bool((i2 == n).all())


_P3_DUPS = ((2, 10), (3, 5), (1, -1))


def packed3_case(m, n, npad, l=55, seed=7, dups=_P3_DUPS):
    """Seeded packed3 operands as the exact_hi2 level build makes them
    (``pack_w12``: W1 = [d1|d2], W2 = [d3|d1] of 2L rounded up to 128
    lanes, half norms with +inf on rows [n, npad)), on the CPU: live-dim
    rows with exact duplicate pairs (``dups``; -1 is row n - 1), by default
    2 and 10 (one thread's columns of a tile), 3 and 5 (two threads') and 1
    and n - 1 (different DB chunks once n spans chunks); queries centered
    by the DB's shift and split in three bf16 parts, query i equal to the
    lower row of pair i (rows 2, 3 and 1 by default).  Returns (q1, q2,
    q3, w1, w2, dbnh)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, l), generator=g) * 0.1
    q = torch.randn((m, l), generator=g) * 0.1
    for lo, hi in dups:
        x[hi % n] = x[lo]
    for row, (src, _) in enumerate(dups[:m]):
        q[row] = x[src]
    live = torch.arange(l)
    shift, half_norm = packed_shift_and_halfnorm(x, live)
    w1, w2, dbnh = pack_w12(x, shift, half_norm, live, npad)
    return (*(_bf16(v) for v in match.bf16_split3(q - shift)), w1, w2, dbnh)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,npad,l", [
    (m, n, npad, l)
    # 2L = 110 of 128 lanes (luminance) and 256 of 256 (RGB sources)
    for l in (55, 128)
    # one query, every warpgroup edge, level 1's and level 0's widest
    for m in (1, 63, 64, 65, 176, 352)
    # N ragged (the box past N reads zeros, the last tile's norms come from
    # global memory), an all-padding last tile, and many chunks with an
    # all-padding last chunk
    for n, npad in ((1000, 1000), (1000, 1100), (69000, 72000))])
def test_cuda_packed3_hopper_matches_plain(m, n, npad, l):
    """packed3_best on the Hopper core (packed3_best.cu) against its plain
    version on the card: one launch a call, scores within 1e-5, picks
    equal outside the 2e-5 band, duplicate rows in one thread, across
    threads and across DB chunks go to the lower index, padding rows never
    win, and ten repeated calls give the same bits."""
    dev = _card()
    q1, q2, q3, w1, w2, dbnh = (t.to(dev) for t in packed3_case(m, n, npad,
                                                                l))
    k_used = (2 * l + 15) // 16 * 16
    assert match._packed3_route(k_used) == "packed3_best"
    plan = match._packed3_plan(
        m, npad, match._sm_count(match._device_index(w1)), k_used)
    if n > 10000:  # rows 1 and n - 1 in different blocks, a padding chunk
        chunk = plan.tiles_per_chunk * 64
        assert 1 // chunk != (n - 1) // chunk
        assert (plan.n_chunks - 1) * chunk >= n
    match.reset_launch_counts()
    idx, val = match.packed3_best(q1, q2, q3, w1, w2, dbnh)
    assert match.LAUNCHES["packed3_best"] == 1
    qa, qb = match._packed3_rows(q1, q2, q3, w1.shape[1])
    ref_i, ref_v = match.packed_best_plain(qa, w1, k_used, qb=qb, w2=w2,
                                           dbnh=dbnh, fold_a=True)
    _assert_band("packed3_best", idx.cpu(), val.cpu(), ref_i.cpu(),
                 ref_v.cpu())
    assert [int(i) for i in idx[:3]] == [2, 3, 1][:m]
    assert int(idx.max()) < n
    for _ in range(10):
        again_i, again_v = match.packed3_best(q1, q2, q3, w1, w2, dbnh)
        assert torch.equal(again_i, idx)
        assert torch.equal(again_v.view(torch.int32), val.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,l", [(70, 150), (3, 200)])
def test_cuda_packed3_wide_route_matches_plain(m, l):
    """Past 256 lanes (2L = 300 and 400 of 384 and 512) the width rule
    sends packed3 to packed3w_best.cu: one launch a call (counted as
    ``packed3w_best``), picks equal to the
    plain version's outside the band.  Scores within 4e-5: at these widths
    the tensor cores' fp32 accumulation over 3 x 19-25 k steps differs from
    the plain fp32 product by up to 2.8e-5 (scores ~1;
    ``test_cuda_packed3_scores_against_float64`` shows which of the two
    strays from the exact sum).  Separate qa and qb operands (not one
    tensor) are taken too."""
    dev = _card()
    q1, q2, q3, w1, w2, dbnh = (t.to(dev) for t in packed3_case(
        m, 1000, 1088, l))
    k_used = (2 * l + 15) // 16 * 16
    assert match._packed3_route(k_used) == "packed3w_best"
    match.reset_launch_counts()
    idx, val = match.packed3_best(q1, q2, q3, w1, w2, dbnh)
    assert match.LAUNCHES["packed3w_best"] == 1
    assert match.LAUNCHES["packed3_best"] == 0
    qa, qb = (t.clone() for t in match._packed3_rows(q1, q2, q3,
                                                      w1.shape[1]))
    ref_i, ref_v = match.packed_best_plain(qa, w1, k_used, qb=qb, w2=w2,
                                           dbnh=dbnh, fold_a=True)
    _assert_band("packed3_best", idx.cpu(), val.cpu(), ref_i.cpu(),
                 ref_v.cpu(), atol=4e-5, band=4e-5)
    assert [int(i) for i in idx[:3]] == [2, 3, 1][:m]
    assert int(idx.max()) < 1000
    # the Hopper kernel with qa and qb apart: the wrapper joins them
    if m > 1:
        k2 = 112
        c = [t.to(dev) for t in packed3_case(m, 1000, 1088, 55)]
        qa, qb = (t.clone() for t in match._packed3_rows(*c[:3], 128))
        got = match.packed_best(qa, c[3], k2, qb=qb, w2=c[4], dbnh=c[5],
                                fold_a=True)
        want = match.packed3_best(*c)
        assert torch.equal(got[0], want[0]) and torch.equal(
            got[1].view(torch.int32), want[1].view(torch.int32))


# duplicate pairs across a 32-row and a 64-row DB-tile boundary, within
# one 32-row tile, and far apart (different DB chunks at the larger N)
_P3W_DUPS = ((2, 10), (31, 32), (63, 64), (40, 100), (1, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,npad,l", [
    (m, n, npad, l)
    # 2L = 296 (the video preset's block on RGB sources: Kp 384), 300, 400
    # and 414 (super_resolution on RGB sources: Kp 512), two query sets in
    # registers and two warpgroups; 440 (one set, one warpgroup) and 500
    # (a single ring stage)
    for l in (148, 150, 200, 207, 220, 250)
    # one query, a warpgroup's edge, two warpgroups' edge, two query tiles
    for m in (5, 64, 129, 300)
    # N ragged (the box past N reads zeros, the last tile's norms come from
    # global memory), an all-padding last tile, and many chunks with an
    # all-padding last chunk
    for n, npad in ((1000, 1000), (1000, 1100), (69000, 72000))])
def test_cuda_packed3w_matches_plain(m, n, npad, l):
    """packed3 past 256 lanes (packed3w_best.cu) against its plain version
    on the card: one launch a call, scores within 4e-5 (the tensor cores'
    fp32 sum over 3 x 19-32 k steps, ``test_cuda_packed3_scores_against_
    float64``), picks equal outside that band; exact ties inside a 32-row
    DB tile, across 32- and 64-row tile boundaries and across DB chunks go
    to the lowest index; padding rows never win; ten repeated calls give
    the same bits."""
    dev = _card()
    q1, q2, q3, w1, w2, dbnh = (t.to(dev) for t in packed3_case(
        m, n, npad, l, dups=_P3W_DUPS))
    k_used = (2 * l + 15) // 16 * 16
    assert match._packed3_route(k_used) == "packed3w_best"
    plan = match._packed3w_plan(
        m, npad, match._sm_count(match._device_index(w1)), k_used)
    if n > 10000:  # rows 1 and n - 1 in different blocks, a padding chunk
        chunk = plan.tiles_per_chunk * plan.rows
        assert 1 // chunk != (n - 1) // chunk
        assert (plan.n_chunks - 1) * chunk >= n
    match.reset_launch_counts()
    idx, val = match.packed3_best(q1, q2, q3, w1, w2, dbnh)
    assert match.LAUNCHES["packed3w_best"] == 1
    assert sum(match.LAUNCHES.values()) == 1
    qa, qb = match._packed3_rows(q1, q2, q3, w1.shape[1])
    ref_i, ref_v = match.packed_best_plain(qa, w1, k_used, qb=qb, w2=w2,
                                           dbnh=dbnh, fold_a=True)
    _assert_band("packed3w_best", idx.cpu(), val.cpu(), ref_i.cpu(),
                 ref_v.cpu(), atol=4e-5, band=4e-5)
    want = [lo for lo, _ in _P3W_DUPS][:m]
    assert [int(i) for i in idx[:len(want)]] == want
    assert int(idx.max()) < n
    for _ in range(10):
        again_i, again_v = match.packed3_best(q1, q2, q3, w1, w2, dbnh)
        assert torch.equal(again_i, idx)
        assert torch.equal(again_v.view(torch.int32), val.view(torch.int32))


@pytest.mark.cuda
def test_cuda_packed3w_refuses_what_it_does_not_take():
    """The C entry of packed3w_best.cu refuses k_used at or below 256 or
    past 512, K outside {384, 512}, and a plan outside its limits (two
    warpgroups past 416 lanes, where the instance runs one); the wrapper
    refuses K past 512 before any launch."""
    dev = _card()
    lib = match._build.load("packed3w_best")
    m, n = 8, 256
    q = torch.zeros((3 * m, 512), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((n, 512), dtype=torch.bfloat16, device=dev)
    dbnh = torch.zeros((n,), device=dev)
    part_val, out_val = (torch.empty((n, m), device=dev) for _ in range(2))
    part_idx, out_idx = (torch.empty((n, m), dtype=torch.int32, device=dev)
                         for _ in range(2))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(k, k_used, consumers=None):
        plan = match._packed3w_plan(m, n, 132, max(272, min(k_used, 512)))
        return lib.ia_packed3w_best(
            q.data_ptr(), w.data_ptr(), w.data_ptr(), dbnh.data_ptr(), m, n,
            k, k_used, consumers or plan.consumers, plan.bm, plan.stages,
            plan.tiles_per_chunk, plan.smem, plan.n_chunks,
            part_val.data_ptr(), part_idx.data_ptr(), out_idx.data_ptr(),
            out_val.data_ptr(), match._device_index(q), stream)

    assert call(512, 416) == 0 and call(512, 512) == 0
    torch.cuda.synchronize()
    for k, k_used in ((512, 256), (512, 528), (256, 272), (640, 416),
                      (384, 400)):
        assert call(k, k_used) != 0, (k, k_used)
    assert call(512, 448, consumers=2) != 0
    with pytest.raises(ValueError):
        match.packed_best(q[:2 * m], torch.zeros((n, 640),
                                                 dtype=torch.bfloat16,
                                                 device=dev), 528,
                          qb=q[2 * m:], w2=w, dbnh=dbnh, fold_a=True)


@pytest.mark.cuda
@pytest.mark.parametrize("l,atol", [(55, 1e-5), (128, 1e-5), (148, 4e-5),
                                    (150, 4e-5), (200, 4e-5), (207, 4e-5)])
def test_cuda_packed3_scores_against_float64(l, atol):
    """The packed3 scores of both routes (the Hopper core up to 256 lanes,
    packed3w_best.cu past them) against a float64 sum of the same six bf16
    products: the tensor cores' fp32 accumulation over 3 x 7-26 k steps
    strays by up to ``atol`` (scores ~1), further than the plain fp32
    product, which stays within 1e-6 -- so the plain version is the
    reference the kernels are held to within these tolerances."""
    dev = _card()
    c = packed3_case(70, 1000, 1088, l)
    k_used = (2 * l + 15) // 16 * 16
    idx, val = match.packed3_best(*(t.to(dev) for t in c))
    qa, qb = match._packed3_rows(*c[:3], c[3].shape[1])
    w1, w2, dbnh = c[3:]
    f64 = lambda a, b: a[:, :k_used].double() @ b[:, :k_used].double().T
    exact = (f64(qa[:70], w1) + f64(qa[70:], w1) + f64(qb, w2)
             - dbnh.double())
    ref_i, ref_v = match.packed_best_plain(
        *(t.to(dev) for t in (qa, w1)), k_used, qb=qb.to(dev),
        w2=w2.to(dev), dbnh=dbnh.to(dev), fold_a=True)
    at = lambda i: exact.gather(1, i.cpu().long()[:, None])[:, 0]
    assert float((val.cpu().double() - at(idx)).abs().max()) <= atol
    assert float((ref_v.cpu().double() - at(ref_i)).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("form,l,kp", [
    ("packed3_best", 123, 256),    # 3 passes x 16 k-steps (the Hopper core)
    ("packed2_best", 200, 512),    # 2 x 32, two streams single-buffered
    ("packed1w_best", 150, 384),   # 2 x 24, one stream
    ("packed2wn_best", 120, 256),  # 2 x 16: fragments in registers
])
def test_cuda_wide_packed_forms_match_plain(form, l, kp):
    """The core's instances at wide lanes: three passes of 256 lanes
    (exact_hi2 on RGB sources, K = 256), two streams of 400 lanes of 512
    (two query sets and a ring stage of both streams: 64-row tiles, one
    warpgroup), one stream of 300 of 384, and the per-tile champions of
    three passes at 256 lanes."""
    dev = _card()
    cpu = scan_case(n=1000, npad=1088, m=150, l=l, kp=kp)
    card = {k: v.to(dev) for k, v in cpu.items()}
    match.reset_launch_counts()
    idx, val = _form_call(form, card)()
    assert match.LAUNCHES[form] == 1
    ref_i, ref_v = _form_call(form, cpu)()
    _assert_band(form, idx.cpu(), val.cpu(), ref_i, ref_v)
    assert int(idx[2]) == 3 and int(idx.max()) < 1000
    if form == "packed3_best":
        match.reset_launch_counts()
        c = card
        vals, tidx = match.packed3_champions(c["q1"], c["q2"], c["q3"],
                                             c["w12"], c["w31"], c["dbnh"],
                                             64)
        assert match.LAUNCHES["packed_champions"] == 1
        rv, ri = match.packed3_champions(cpu["q1"], cpu["q2"], cpu["q3"],
                                         cpu["w12"], cpu["w31"], cpu["dbnh"],
                                         64)
        finite = torch.isfinite(rv)
        assert torch.equal(torch.isfinite(vals.cpu()), finite)
        _assert_band("packed3_champions", tidx.cpu()[finite],
                     vals.cpu()[finite], ri[finite], rv[finite])
        assert torch.equal(tidx.cpu()[~finite], ri[~finite])


@pytest.mark.cuda
@pytest.mark.parametrize("f,fp", [(300, 384), (450, 512)])
def test_cuda_wide_bf16_db_scans_match_plain(f, fp):
    """pertile_champions and argmin2_l2 under q_split at 384 and 512 lanes:
    two passes past the register budget for the query fragments."""
    dev = _card()
    cpu = scan_case(n=1000, npad=1024, m=45, f=f, fp=fp)
    match.reset_launch_counts()
    vals, idx = match.pertile_champions(
        *[cpu[k].to(dev) for k in ("qf", "dbp", "dbnh")], 256, True,
        (f + 15) // 16 * 16)
    i1, v1, i2, v2 = (t.cpu() for t in match.argmin2_l2(
        *[cpu[k].to(dev) for k in ("qf", "dbp", "dbn")], True))
    assert match.LAUNCHES["pertile_champions"] == 1
    assert match.LAUNCHES["argmin2_l2"] == 1
    rv, ri = match.pertile_champions(cpu["qf"], cpu["dbp"], cpu["dbnh"], 256,
                                     True, (f + 15) // 16 * 16)
    finite = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(vals.cpu()), finite)
    _assert_band("pertile", idx.cpu()[finite], vals.cpu()[finite],
                 ri[finite], rv[finite], atol=1e-4, band=1e-4)
    assert int(idx[0, 0]) == 2
    r1, rv1, r2, rv2 = match.argmin2_l2(cpu["qf"], cpu["dbp"], cpu["dbn"],
                                        True)
    _assert_band("argmin2 first", i1, v1, r1, rv1, atol=1e-4, band=1e-4)
    _assert_band("argmin2 second", i2, v2, r2, rv2, atol=1e-4, band=1e-4)
    assert (int(i1[0]), int(i2[0])) == (2, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,npad", [(13, 900, 1024), (130, 1000, 1088),
                                      (1024, 3000, 3072), (5, 1, 256)])
def test_cuda_argmin_l2_bf16_matches_plain(m, n, npad):
    """The single-bf16-pass argmin (batched/rowwise) against its plain
    version: duplicate rows 2 and 5 go to 2, padding rows never win, and a
    one-row DB gives that row."""
    dev = _card()
    cpu = scan_case(n=n, npad=npad, m=m)
    args = [cpu[k] for k in ("qf", "dbp", "dbn")]
    match.reset_launch_counts()
    idx, val = (t.cpu() for t in match.argmin_l2_bf16(
        *[a.to(dev) for a in args], 80))
    assert match.LAUNCHES["argmin_l2_bf16"] == 1
    ref_i, ref_v = match.argmin_l2_bf16(*args, 80)
    _assert_band("argmin_l2_bf16", idx, val, ref_i, ref_v, atol=1e-4,
                 band=1e-4)
    assert int(idx.max()) < n and int(idx[0]) == (2 if n > 5 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,npad,f,fp", [
    # batched npr_1024's five levels (one scan row of 1024 >> l pixels; F =
    # 50 at level 4, which has no coarse block), N cut to at most 65,536
    # rows, the last 100 padding
    (1024, 65436, 65536, 68, 128), (512, 65436, 65536, 68, 128),
    (256, 65436, 65536, 68, 128), (128, 16284, 16384, 68, 128),
    (64, 3996, 4096, 50, 128),
    # k_used 16, 80, 256 (the widest 128-row tiles), 272 and 512 (64-row
    # tiles; two and one consumer warpgroups)
    (45, 5000, 5120, 13, 128), (45, 5000, 5120, 68, 128),
    (45, 5000, 5120, 250, 256), (45, 5000, 5120, 270, 384),
    (45, 5000, 5120, 500, 512),
    # M at the warpgroup and query-tile edges: one row, a warpgroup's 64
    # either side, 171 (a level-0 tile), six tiles of 171
    (1, 5000, 5120, 68, 128), (63, 5000, 5120, 68, 128),
    (65, 5000, 5120, 68, 128), (171, 5000, 5120, 68, 128),
    (1024, 5000, 5120, 68, 128),
    # ragged last tiles (N not a multiple of 128, or of 64 past 256 lanes;
    # their norms read from global memory), and DB chunks of padding rows
    # only (3,000 real rows of 65,536: 122 of 128 chunks), which keep
    # (-inf, INT_MAX) and lose every merge
    (45, 1000, 1000, 68, 128), (200, 3001, 3041, 300, 384),
    (45, 3000, 65536, 68, 128)])
def test_cuda_argmin_l2_bf16_hopper_matches_plain(m, n, npad, f, fp):
    """argmin_l2_bf16 on the Hopper core against its plain version on the
    card: scores within 1e-4, picks equal outside the 1e-4 band; duplicate
    rows in one thread's columns, across threads and across DB chunks go
    to the lower index, padding rows never win; repeated calls with the
    fp32 queries (rounded by the entry) and with their bf16 rounding give
    the same bits."""
    dev = _card()
    q, dbp, dbn = (t.to(dev) for t in argmin2_case(m, n, npad, f, fp))
    k_used = (f + 15) // 16 * 16
    plan = match._argmin_bf16_plan(
        m, npad, match._sm_count(match._device_index(q)), k_used)
    if npad == 65536 and n == 3000:  # chunks past the real rows
        rows = plan.tiles_per_chunk * (128 if k_used <= 256 else 64)
        assert (plan.n_chunks - 1) * rows >= n
    match.reset_launch_counts()
    idx, val = match.argmin_l2_bf16(q, dbp, dbn, k_used)
    assert match.LAUNCHES["argmin_l2_bf16"] == 1
    for qq in (q, q.to(torch.bfloat16), q, q.to(torch.bfloat16)):
        again = match.argmin_l2_bf16(qq, dbp, dbn, k_used)
        assert torch.equal(again[0], idx)
        assert torch.equal(again[1].view(torch.int32), val.view(torch.int32))
    ref_i, ref_v = match.argmin_l2_bf16_plain(q, dbp, dbn, k_used)
    idx, val, ref_i, ref_v = (t.cpu() for t in (idx, val, ref_i, ref_v))
    _assert_band("argmin_l2_bf16", idx, val, ref_i, ref_v, atol=1e-4,
                 band=1e-4)
    assert int(idx.max()) < n
    assert [int(i) for i in idx[:3]] == [2, 3, 1][:m]


@pytest.mark.cuda
@pytest.mark.parametrize("f,fp", [(68, 128), (250, 256), (500, 512)])
def test_cuda_argmin_l2_bf16_scores_against_float64(f, fp):
    """The argmin_l2_bf16 scores at the kernel's picks against a float64
    sum of the same bf16 products (dbn - 2 q.db, scores near -1): the
    tensor cores' fp32 accumulation over 5-32 k steps stays within 1e-5,
    and so does the plain fp32 product; the picks score within 1e-5 of the
    float64 minimum."""
    dev = _card()
    q, dbp, dbn = argmin2_case(200, 3001, 3041, f, fp)
    # scaled by powers of two (exact): norms near 1
    q, dbp, dbn = q / 8, (dbp.float() / 8).to(torch.bfloat16), dbn / 64
    k_used = (f + 15) // 16 * 16
    idx, val = (t.cpu() for t in match.argmin_l2_bf16(
        *(t.to(dev) for t in (q, dbp, dbn)), k_used))
    ref_i, ref_v = (t.cpu() for t in match.argmin_l2_bf16_plain(
        *(t.to(dev) for t in (q, dbp, dbn)), k_used))
    qb = q.to(torch.bfloat16)[:, :k_used].double()
    exact = dbn.double()[None, :] - 2.0 * (qb @ dbp[:, :k_used].double().T)
    at = lambda i: exact.gather(1, i.long()[:, None])[:, 0]
    assert float((val.double() - at(idx)).abs().max()) <= 1e-5
    assert float((ref_v.double() - at(ref_i)).abs().max()) <= 1e-5
    assert float((at(idx) - exact.min(dim=1).values).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,size", [("batched", 48), ("rowwise", 48),
                                           ("exact", 32)])
def test_cuda_strategies_match_cpu_run(strategy, size):
    """Each non-wavefront strategy on the card against the CPU: batched and
    rowwise against a CPU run of the same bf16 approximate match (the
    kernel's plain version), exact against the CPU's fp32 scan.  Only the
    bf16 argmin launches, once per scan row of the approximate
    strategies."""
    _card()
    a, ap, b = make_structured(size, 7)
    params = AnalogyParams(levels=3, kappa=5.0, strategy=strategy)
    match.reset_launch_counts()
    gpu = create_image_analogy(a, ap, b, params)
    rows = 0 if strategy == "exact" else size + size // 2 + size // 4
    assert {k: v for k, v in match.LAUNCHES.items() if v} == (
        {"argmin_l2_bf16": rows} if rows else {})
    cpu = create_image_analogy(a, ap, b, params, backend=CudaMatcher(
        params, "cpu", bf16_approx=strategy != "exact"))
    assert gpu.bp_y.shape == (size, size) and np.isfinite(gpu.bp_y).all()
    assert (gpu.source_map != cpu.source_map).mean() < 0.02
    assert ssim(gpu.bp_y, cpu.bp_y) >= 0.99
    if strategy == "batched":
        assert all(0.0 <= st["refined_ratio"] <= 1.0 for st in gpu.stats)


def _rgb(x):
    return np.stack([x, x * x, 1 - x], -1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("match_mode,rgb", [
    ("exact_hi2", False), ("scan_rescue", False), ("scan_rescue_1p", False),
    ("two_pass", False), ("two_pass_1p", False),
    # RGB sources: exact_hi2 scans K = 256 lanes in three passes
    ("exact_hi2", True), ("scan_rescue", True)])
def test_cuda_new_modes_match_cpu_run(match_mode, rgb, monkeypatch):
    """Each new anchor mode's 48^2 path on the card against the same path
    on the CPU (the plain versions), on grayscale and on RGB sources."""
    _card()
    monkeypatch.setenv("IA_EXPERIMENTAL", "1")
    a, ap, b = make_structured(48, 7)
    kw = {}
    if rgb:
        a, ap, b = _rgb(a), _rgb(ap), _rgb(b)
        kw = dict(color_mode="source_rgb")
    params = AnalogyParams(levels=3, kappa=5.0, match_mode=match_mode, **kw)
    name = {"exact_hi2": "packed3_best", "scan_rescue": "pertile_champions",
            "scan_rescue_1p": "pertile_champions", "two_pass": "argmin2_l2",
            "two_pass_1p": "argmin2_l2"}[match_mode]
    match.reset_launch_counts()
    gpu = create_image_analogy(a, ap, b, params)
    assert match.LAUNCHES[name] > 0
    cpu = create_image_analogy(a, ap, b, params, device="cpu")
    assert gpu.bp_y.shape == (48, 48) and np.isfinite(gpu.bp_y).all()
    assert (gpu.source_map != cpu.source_map).mean() < 0.02
    assert ssim(gpu.bp_y, cpu.bp_y) >= 0.99
    if rgb:
        assert gpu.bp.shape == (48, 48, 3) and np.isfinite(gpu.bp).all()


@pytest.mark.cuda
def test_cuda_bf16_scoring_gate_runs_on_the_card():
    """bf16_scoring probes once on the card, caches the verdict under the
    card's name, and runs the levels on the mode the verdict allows."""
    from image_analogies_tpu_torch.backends import gate

    dev = _card()
    gate.reset_bf16_gate()
    a, ap, b = make_structured(48, 7)
    res = create_image_analogy(a, ap, b, AnalogyParams(levels=2,
                                                       bf16_scoring=True))
    verdict = gate.bf16_gate_verdict(dev)
    assert verdict is not None and gate.device_key(dev) != "cpu"
    want = "scan_rescue" if verdict["ok"] else "exact_hi"
    assert {st["match_mode"] for st in res.stats} == {want}
    gate.reset_bf16_gate()


# the lane widths every superseded form and both champion forms take on the
# card: one k step, the luminance width, 256 (the core's widest folded
# champion), past it (the folded champions go to packed3w_best.cu), and
# around 448, past which two query sets and two streams take 32-row tiles
_EVERY_K = (16, 112, 256, 288, 400, 448, 464, 512)
_NORM_FORMS = ("packed2wn_best", "packed1wn_best")


def _form_lanes(form, k_used):
    """(L, Kp) of a form whose packed lanes (2L, or 2L + 3 with the norm in
    W's lanes) round up to ``k_used``."""
    l = (k_used - 3) // 2 if form in _NORM_FORMS else k_used // 2
    return l, -(-k_used // 128) * 128


def _champions_call(three, c, tile):
    if three:
        return match.packed3_champions(c["q1"], c["q2"], c["q3"], c["w12"],
                                       c["w31"], c["dbnh"], tile)
    return match.packed2_champions(c["q1"], c["q2"], c["w12"], c["w13"],
                                   c["dbnh"], tile)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed2_best", "packed1w_best",
                                  "packed2wn_best", "packed1wn_best",
                                  "packed2_champions", "packed3_champions"])
@pytest.mark.parametrize("k_used", _EVERY_K)
def test_cuda_packed_forms_every_width(form, k_used):
    """Every superseded form and both champion forms on the Hopper core (the
    folded champions past 256 lanes on packed3w_best.cu) at every lane
    width class, against the plain version: one launch a call, scores
    within 1e-5 (4e-5 past 256 lanes: the tensor cores' fp32 sum, as for
    packed3w), picks equal outside that band.  N = 65,000 real rows of
    69,632: the duplicate rows 3 and 40,000 in different DB chunks of the
    global forms and different tiles of the champions (query 2 equals row
    3), padding rows never win, and the champions' last tile of 4,096 rows
    is all padding (-inf at its first row)."""
    dev = _card()
    l, kp = _form_lanes(form, k_used)
    n, npad, dup = 65000, 69632, 40000
    cpu = scan_case(n=n, npad=npad, m=70, l=l, kp=kp, dup=dup)
    card = {k: v.to(dev) for k, v in cpu.items()}
    atol = 1e-5 if k_used <= 256 else 4e-5
    match.reset_launch_counts()
    if form.endswith("champions"):
        three = form == "packed3_champions"
        vals, idx = _champions_call(three, card, 4096)
        assert match.LAUNCHES["packed_champions"] == 1
        assert sum(match.LAUNCHES.values()) == 1
        rv, ri = _champions_call(three, cpu, 4096)
        finite = torch.isfinite(rv)
        assert not bool(finite[:, -1].any())  # the all-padding tile
        assert torch.equal(torch.isfinite(vals.cpu()), finite)
        _assert_band(form, idx.cpu()[finite], vals.cpu()[finite],
                     ri[finite], rv[finite], atol=atol, band=atol)
        assert torch.equal(idx.cpu()[~finite], ri[~finite])
        assert (int(idx[2, 0]), int(idx[2, dup // 4096])) == (3, dup)
        return
    plan = match._packed_form_plan(form, 70, npad, match._sm_count(
        match._device_index(card["w12"])), k_used)
    rows = plan.tiles_per_chunk * match._core_rows(
        k_used, 2, 2 if form in ("packed2_best", "packed2wn_best") else 1,
        form not in _NORM_FORMS)
    assert 3 // rows != dup // rows  # the duplicates in different chunks
    idx, val = _form_call(form, card)()
    assert match.LAUNCHES[form] == 1 and sum(match.LAUNCHES.values()) == 1
    ref_i, ref_v = _form_call(form, cpu)()
    _assert_band(form, idx.cpu(), val.cpu(), ref_i, ref_v, atol=atol,
                 band=atol)
    assert int(idx[2]) == 3 and int(idx.max()) < n


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["packed2_best", "packed1w_best",
                                  "packed2wn_best", "packed1wn_best"])
def test_cuda_packed_forms_scores_against_float64(form, monkeypatch):
    """At 512 lanes (32 k steps a pass; 32-row DB tiles for the two-stream
    forms) each form's scores against a float64 sum of the same bf16
    products: the tensor cores' fp32 accumulation strays by at most 4e-5
    (scores ~1), the bound the card tests hold these widths to."""
    dev = _card()
    l, kp = _form_lanes(form, 512)
    c = scan_case(n=1000, npad=1088, m=70, l=l, kp=kp)
    seen = {}
    packed_best = match.packed_best

    def spy(qa, w1, k_used=0, **kw):
        seen.update(qa=qa, w1=w1, k_used=k_used, **kw)
        return packed_best(qa, w1, k_used, **kw)

    monkeypatch.setattr(match, "packed_best", spy)
    idx, val = _form_call(form, {k: v.to(dev) for k, v in c.items()})()
    k_used = seen["k_used"]
    assert k_used == 512
    f64 = lambda a, b: (a[:, :k_used].double().cpu()
                        @ b[:, :k_used].double().cpu().T)
    qa, w1 = seen["qa"], seen["w1"]
    if seen.get("fold_a"):
        exact = f64(qa[:70], w1) + f64(qa[70:], w1)
    else:
        exact = f64(qa, w1)
    if seen.get("w2") is not None:
        exact += f64(seen["qb"], seen["w2"])
    if seen.get("dbnh") is not None:
        exact -= seen["dbnh"].double().cpu()
    got = exact.gather(1, idx.cpu().long()[:, None])[:, 0]
    assert float((val.cpu().double() - got).abs().max()) <= 4e-5



# ------------------------------------------------- the driver's surroundings


def _driver_pair(size=64, seed=7):
    return make_structured(size, seed)


def _same_run(res, ref):
    assert np.array_equal(res.bp_y, ref.bp_y)
    assert np.array_equal(res.source_map, ref.source_map)


@pytest.mark.cuda
def test_cuda_devcache_hit_on_another_stream_waits_for_the_upload():
    """The prefetch handshake: an upload queued on a side stream behind a
    long kernel, then a hit on the main stream.  The hit waits on the
    upload's event, so what the main stream reads is the host bytes."""
    from image_analogies_tpu_torch.utils import devcache

    dev = _card()
    devcache.clear()
    host = np.random.default_rng(0).standard_normal(
        (1024, 1024)).astype(np.float32)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # ~0.1 s ahead of the copy
        devcache.device_put_cached(host, dev)
    hit = devcache.device_put_cached(host, dev)  # main stream
    got = (hit * 1.0).cpu().numpy()
    assert np.array_equal(got, host)
    devcache.clear()


@pytest.mark.cuda
def test_cuda_watchdog_attempts_run_on_their_own_streams(monkeypatch):
    """A level's first attempt wedges (a spin kernel longer than the
    deadline) and is abandoned; the retry runs on another stream, with
    its own argmin_l2 workspace, and its picks equal a clean run's."""
    from image_analogies_tpu_torch.utils import failure

    _card()
    a, ap, b = _driver_pair()
    params = AnalogyParams(levels=3)
    clean = create_image_analogy(a, ap, b, params)
    streams, spun = [], []
    orig = CudaMatcher.synthesize_level

    def wedged(self, db, job):
        streams.append((job.level, torch.cuda.current_stream().cuda_stream))
        if job.level == 0 and not spun:
            spun.append(1)
            torch.cuda._sleep(4_000_000_000)  # ~2 s, past the deadline
        return orig(self, db, job)

    monkeypatch.setattr(CudaMatcher, "synthesize_level", wedged)
    res = create_image_analogy(
        a, ap, b, params.replace(level_retries=1, dispatch_timeout_s=1.0))
    _same_run(res, clean)
    level0 = [s for lv, s in streams if lv == 0]
    assert len(level0) == 2 and level0[0] != level0[1]
    default = torch.cuda.default_stream().cuda_stream
    assert all(s != default for _, s in streams)
    import threading

    for t in threading.enumerate():  # the abandoned attempt runs on
        if t.name == "ia-watchdog-body":
            t.join(timeout=60)
            assert not t.is_alive()
    torch.cuda.synchronize()
    assert failure._INJECT["n"] == 0


@pytest.mark.cuda
def test_cuda_out_of_memory_is_retried(monkeypatch):
    """A real ``torch.cuda.OutOfMemoryError`` in a level's first attempt
    is transient: the level is retried and the run equals a clean one."""
    _card()
    a, ap, b = _driver_pair()
    params = AnalogyParams(levels=2)
    clean = create_image_analogy(a, ap, b, params)
    orig = CudaMatcher.build_features
    raised = []

    def greedy(self, job):
        if not raised:
            raised.append(1)
            torch.empty((1 << 46,), dtype=torch.uint8, device=self.device)
        return orig(self, job)

    monkeypatch.setattr(CudaMatcher, "build_features", greedy)
    res = create_image_analogy(a, ap, b, params.replace(level_retries=1))
    assert raised
    _same_run(res, clean)


@pytest.mark.cuda
def test_cuda_pipelined_run_equals_lock_step():
    """``level_sync=False`` (the pipeline and donation on by auto) at
    64^2: the same bits and launches as the lock-step run."""
    from image_analogies_tpu_torch.ops import match

    _card()
    a, ap, b = _driver_pair()
    params = AnalogyParams(levels=4)
    match.reset_launch_counts()
    clean = create_image_analogy(a, ap, b, params)
    want = dict(match.LAUNCHES)
    match.reset_launch_counts()
    pipe = create_image_analogy(a, ap, b, params.replace(level_sync=False))
    assert dict(match.LAUNCHES) == want and want["argmin_l2"] > 0
    _same_run(pipe, clean)
    levels = len(pipe.stats)
    assert pipe.timing["prepped_levels"] == levels - 1
    assert pipe.timing["donated_levels"] == levels - 1
    assert pipe.timing["prefetch_errors"] == 0
    assert all("enqueue_ms" in st for st in pipe.stats)


# ------------------------------------------------------------ the lane engine


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,match_mode,heights", [
    ("wavefront", "auto", (40, 40, 40, 40)),
    ("wavefront", "exact_hi2_2p", (40, 40, 40, 40)),
    ("batched", "auto", (40, 40, 40, 40)),
    # one query bucket at both levels (2,048 and 512 rows), four heights
    ("batched", "auto", (40, 44, 42, 40))])
def test_cuda_lanes_bit_identical_to_singletons(strategy, match_mode,
                                                heights):
    """Four lanes on the card against four singleton runs, at an odd width
    (45: batched rows of 48 columns a lane) and F = 50 at the coarsest
    level (no coarse block): every lane's B', source map and ratios are
    its singleton's bits, and the lane run launches what the singleton of
    the tallest target does (one kernel call a step or row for all
    lanes)."""
    from image_analogies_tpu_torch import create_image_analogy_batch

    _card()
    rng = np.random.RandomState(7)
    a = rng.rand(48, 45).astype(np.float32)
    ap = np.clip(0.8 * a + 0.2 * rng.rand(48, 45), 0, 1).astype(np.float32)
    targets = [rng.rand(h, 45).astype(np.float32) for h in heights]
    params = AnalogyParams(levels=2, remap_luminance=False,
                           strategy=strategy, match_mode=match_mode,
                           shape_buckets=len(set(heights)) > 1)
    match.reset_launch_counts()
    results = create_image_analogy_batch(a, ap, targets, params)
    lanes = {k: v for k, v in match.LAUNCHES.items() if v}
    for b, res in zip(targets, results):
        assert not isinstance(res, Exception), res
        match.reset_launch_counts()
        ref = create_image_analogy(a, ap, b, params)
        if b.shape[0] == max(heights):  # the lanes run to the tallest
            assert lanes == {k: v for k, v in match.LAUNCHES.items() if v}
        assert np.array_equal(res.bp_y, ref.bp_y)
        assert np.array_equal(res.source_map, ref.source_map)
        for st, st_ref in zip(res.stats, ref.stats):
            assert st["lanes"] == 4
            assert st["coherence_ratio"] == st_ref["coherence_ratio"]
            assert st.get("refined_ratio") == st_ref.get("refined_ratio")


def _rows_of_singletons(fn, q, k):
    """``fn`` on each of the k lanes' row blocks of ``q``, concatenated."""
    outs = [fn(part) for part in q.chunk(k)]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m", [("packed_best", 352),
                                      ("argmin_l2", 88),
                                      ("argmin_l2_bf16", 1024)])
def test_cuda_lane_width_calls_equal_singleton_calls(kernel, m):
    """Each kernel of the lane path at four lanes' rows (packed2k at M =
    1,408, argmin_l2 at 352, argmin_l2_bf16 at 4,096) gives every row the
    pick and score bits of the same row in a singleton-sized call of M
    rows, one launch a call, and agrees with its plain version as the
    single-call cases above do."""
    dev = _card()
    k = 4
    if kernel == "packed_best":
        x, qv = packed_inputs(m=k * m, n=69000, dup=(3, 68940))
        l = qv.shape[1]
        xt = torch.from_numpy(x).to(dev)
        wk, _ = pack_wk(xt, torch.zeros(l, device=dev),
                        0.5 * (xt * xt).sum(1), torch.arange(l, device=dev),
                        70000)
        g1, g2, _ = match.bf16_split3(torch.from_numpy(qv).to(dev))
        q = query_rows(g1.to(torch.bfloat16), g2.to(torch.bfloat16),
                       wk.shape[1])
        call = lambda qq: match.packed_best(qq, wk, 224)
        plain = lambda qq: match.packed_best_plain(qq, wk, 224)
        n, atol, band = 69000, 1e-6, 1e-6
    elif kernel == "argmin_l2":
        q, db, dbn = (torch.from_numpy(t).to(dev) for t in argmin_inputs(
            m=k * m, n=64000, npad=65536, dup=(40, 63940)))
        call = lambda qq: match.argmin_l2(qq, db, dbn)
        plain = lambda qq: match.argmin_l2_plain(qq, db, dbn)
        n, atol, band = 64000, 1e-5, 0.0  # the same picks
    else:
        q, dbp, dbn = (t.to(dev) for t in argmin2_case(k * m, 65436, 65536))
        call = lambda qq: match.argmin_l2_bf16(qq, dbp, dbn, 80)
        plain = lambda qq: match.argmin_l2_bf16_plain(qq, dbp, dbn, 80)
        n, atol, band = 65436, 1e-4, 1e-4
    match.reset_launch_counts()
    idx, val = call(q)
    assert match.LAUNCHES[kernel] == 1
    one_i, one_v = _rows_of_singletons(call, q, k)
    assert match.LAUNCHES[kernel] == 1 + k
    assert torch.equal(idx, one_i)
    assert torch.equal(val.view(torch.int32), one_v.view(torch.int32))
    ref_i, ref_v = plain(q)
    _assert_band(kernel, idx.cpu(), val.cpu(), ref_i.cpu(), ref_v.cpu(),
                 atol=atol, band=band)
    if not band:
        assert torch.equal(idx, ref_i.to(idx.device))
    assert int(idx.max()) < n


# ------------------------------------------- launch geometry (tune/, obs/)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 88, 352])
@pytest.mark.parametrize("n,npad", [(100, 128), (8400, 8447),
                                    (70000, 70037)])
@pytest.mark.parametrize("kernel", ["packed_best", "argmin_l2"])
def test_cuda_tune_chunks_and_stages_keep_the_bits(kernel, m, n, npad):
    """Every candidate plan of ``ia tune``'s sweeps (chunks_per_sm 1, 2, 4;
    for packed2k ring_stages 2 up to the deepest) gives the default plan's
    idx and val bits, at ragged N, N under the SM count's rows and M from 1
    to the headline 352; the duplicated rows go to the lower index."""
    dev = _card()
    if kernel == "packed_best":
        dup = (3, n - 60) if n > 100 else (3, 60)
        x, qv = packed_inputs(m=m, n=n, dup=dup)
        l = qv.shape[1]
        xt = torch.from_numpy(x).to(dev)
        wk, _ = pack_wk(xt, torch.zeros(l, device=dev),
                        0.5 * (xt * xt).sum(1), torch.arange(l, device=dev),
                        npad)
        g1, g2, _ = match.bf16_split3(torch.from_numpy(qv).to(dev))
        q = query_rows(g1.to(torch.bfloat16), g2.to(torch.bfloat16),
                       wk.shape[1])
        deepest = match._packed2k_plan(m, npad, 132, 224).stages
        cands = [dict(chunks_per_sm=c, ring_stages=s) for c in (1, 2, 4)
                 for s in range(2, deepest + 1)]
        call = lambda kw: match.packed_best(q, wk, 224, **kw)
        pick = min(2, m - 1)
    else:
        dup = (40, n - 60) if n > 100 else (40, 80)
        q, db, dbn = (torch.from_numpy(t).to(dev) for t in argmin_inputs(
            m=m, n=n, npad=npad, dup=dup))
        cands = [dict(chunks_per_sm=c) for c in (1, 2, 4)]
        call = lambda kw: match.argmin_l2(q, db, dbn, **kw)
        pick = 0
    ref_i, ref_v = call({})
    assert int(ref_i[pick]) == dup[0]
    for kw in cands:
        match.reset_launch_counts()
        idx, val = call(kw)
        assert match.LAUNCHES[kernel] == 1
        assert torch.equal(idx, ref_i), kw
        assert torch.equal(val.view(torch.int32), ref_v.view(torch.int32)), kw


@pytest.mark.cuda
def test_cuda_tune_metrics_run_counts_its_launches_and_memory():
    """A metrics run on the card: its bits are the plain run's, its
    launch.* counters equal LAUNCHES, its hbm.peak_bytes.d0 gauge equals
    max_memory_allocated, and its kernel work counts are those of the
    calls it made."""
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.obs import trace as obs_trace

    _card()
    a, ap, b = make_structured(64, 7)
    params = AnalogyParams(levels=2, match_mode="exact_hi")
    ref = create_image_analogy(a, ap, b, params)
    match.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with obs_trace.run_scope(params.replace(metrics=True)):
        res = create_image_analogy(a, ap, b, params.replace(metrics=True))
        snap = obs_metrics.snapshot()
    torch.cuda.synchronize()
    assert np.array_equal(res.bp_y.view(np.int32), ref.bp_y.view(np.int32))
    assert np.array_equal(res.source_map, ref.source_map)
    launches = {k: v for k, v in match.LAUNCHES.items() if v}
    counted = {k[len("launch."):]: v for k, v in snap["counters"].items()
               if k.startswith("launch.")}
    assert counted == launches and launches["argmin_l2"] > 0
    assert snap["gauges"]["hbm.peak_bytes.d0"] == float(
        torch.cuda.max_memory_allocated())
    assert snap["counters"]["kernel.flops"] > 0


# ------------------------------------------------ two-stage ANN matcher


def ann_level0_inputs(m=352, n=1 << 20, f=68, kp=32, seed=5, dups=7):
    """Stage-1 operands at npr_1024's level-0 wavefront shape (M = 352
    queries, N = 2^20 rows, F = 68, Kp = 32): a random PCA-like basis and
    DB, ``dups`` exact duplicates of one projected row (with its half norm
    copied: the card's row sums of equal rows may round apart) spread over
    the DB, and the first 8 queries projecting exactly onto it, so their
    slab boundary falls inside the duplicates' tie for top_m < dups."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((m, f)).astype(np.float32)
    proj = np.linalg.qr(rng.standard_normal((f, kp)))[0].astype(np.float32)
    mean = (0.1 * rng.standard_normal(f)).astype(np.float32)
    dbp = rng.standard_normal((n, kp)).astype(np.float32)
    rows = np.sort(rng.choice(n, dups, replace=False))[::-1]
    dbp[rows] = dbp[rows[0]]
    dbnh = (0.5 * (dbp.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    dbnh[rows] = dbnh[rows[0]]
    q[:8] = mean + proj @ dbp[rows[0]]
    return q, proj, mean, dbp, dbnh, np.sort(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("top_m,n_valid", [(4, 1 << 20), (64, 1 << 20),
                                           (64, (1 << 20) - 1000)])
def test_cuda_ann_stages_against_cpu(top_m, n_valid):
    """Stage 1 on the card against the CPU at the level-0 shape: equal
    candidate sets on >= 99.9% of the query rows (two fp32 products may
    round a near-tie at the slab boundary apart) and on every row of the
    constructed boundary tie (the lowest duplicate indices); no candidate
    past ``n_valid``.  Stage 2 on the card's candidates against the CPU on
    the same candidates: equal picks, d within 1e-5 relative."""
    from image_analogies_tpu_torch.ops import ann

    dev = _card()
    q, proj, mean, dbp, dbnh, dups = ann_level0_inputs()
    host = [torch.from_numpy(x) for x in (q, proj, mean, dbp, dbnh)]
    card = [x.to(dev) for x in host]
    c_cpu = ann.ann_topm_candidates(*host, n_valid, top_m).numpy()
    c_dev = ann.ann_topm_candidates(*card, n_valid, top_m)
    same = (np.sort(c_cpu, 1) == np.sort(c_dev.cpu().numpy(), 1)).all(1)
    assert same.mean() >= 0.999, same.mean()
    assert same[:8].all()
    want = set(dups[:top_m]) if top_m < len(dups) else set(dups)
    assert want <= set(c_dev[0].cpu().numpy())
    assert int(c_dev.max()) < n_valid
    rng = np.random.default_rng(6)
    db = rng.standard_normal((1 << 20, 68)).astype(np.float32)
    i_dev, d_dev = ann.ann_rescore_slab(card[0], torch.from_numpy(db).to(dev),
                                        c_dev, n_valid)
    i_cpu, d_cpu = ann.ann_rescore_slab(host[0], torch.from_numpy(db),
                                        c_dev.cpu(), n_valid)
    np.testing.assert_array_equal(i_dev.cpu().numpy(), i_cpu.numpy())
    np.testing.assert_allclose(d_dev.cpu().numpy(), d_cpu.numpy(),
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["wavefront", "batched"])
def test_cuda_ann_synthesis_against_cpu(strategy):
    """ANN at 64^2 on the card against the CPU (gate bypassed): no kernel
    launches, and the card_vs_cpu limits (source maps differ on < 2% of
    pixels, SSIM >= 0.99)."""
    from image_analogies_tpu_torch.backends import gate

    dev = _card()
    a, ap, b = make_structured(64, 7)
    p = AnalogyParams(levels=3, strategy=strategy, ann_prefilter=True)
    with gate.ann_gate_bypass():
        match.reset_launch_counts()
        card = create_image_analogy(a, ap, b, p, device=dev)
        torch.cuda.synchronize()
        launched = {k: v for k, v in match.LAUNCHES.items() if v}
        cpu = create_image_analogy(a, ap, b, p, device="cpu")
    assert launched == {}
    if strategy == "wavefront":
        assert {st["match_mode"] for st in card.stats} == {"ann_rescue"}
    assert (card.source_map != cpu.source_map).mean() < 0.02
    assert ssim(card.bp_y, cpu.bp_y) >= 0.99


# ----------------------------------------------------------------- the mesh


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,npad", [(88, 64000, 65536),
                                      (352, (1 << 20) - 100, 1 << 20)])
def test_cuda_mesh_nccl_world_of_one_picks(m, n, npad):
    """NCCL in a world of one: the sharded argmin (both precisions) and the
    ring pick what the single-card kernels pick on the same inputs,
    through real NCCL collectives."""
    import torch.distributed as dist

    from image_analogies_tpu_torch.parallel import sharded_match as sm
    from image_analogies_tpu_torch.parallel.launch import _free_port
    from torch_mesh_workers import seeded_argmin

    dev = _card()
    q, db, dbn = (torch.from_numpy(x).to(dev)
                  for x in seeded_argmin(m, n, npad))
    ref, _ = match.argmin_l2(q, db, dbn)
    ref_h, _ = match.prepadded_argmin_queries(q, db.to(torch.bfloat16), dbn)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        g = dist.group.WORLD
        idx, _ = sm.local_argmin_allreduce(q, db, dbn, g)
        idx_h, _ = sm.local_argmin_allreduce(q, db.to(torch.bfloat16), dbn,
                                             g, precision="default")
        ring, _ = sm.make_ring_argmin(g)(q, db, dbn)
    finally:
        dist.destroy_process_group()
    assert torch.equal(idx, ref) and torch.equal(ring, ref)
    assert torch.equal(idx_h, ref_h)
    assert int(idx[0]) == n // 7  # the duplicate pair: the lowest row


@pytest.mark.cuda
def test_cuda_mesh_two_gloo_ranks_on_one_card():
    """Two ranks on cuda:0 over gloo (the caller names the device and the
    backend) at the main path's level-0 shape: each rank scans its half
    of the DB with the single-card kernel and the all-reduce, staged
    through the host, gives the single card's picks."""
    from image_analogies_tpu_torch.parallel.launch import spawn_local
    from torch_mesh_workers import gloo_card_rank, seeded_argmin

    dev = _card()
    shape = (352, (1 << 20) - 100, 1 << 20)
    q, db, dbn = (torch.from_numpy(x).to(dev) for x in seeded_argmin(*shape))
    ref, _ = match.argmin_l2(q, db, dbn)
    ref_h, _ = match.prepadded_argmin_queries(q, db.to(torch.bfloat16), dbn)
    del db
    outs = spawn_local(gloo_card_rank, 2, backend="gloo", device="cuda:0",
                       args=(shape,))
    for idx, idx_h, staged in outs:
        np.testing.assert_array_equal(idx, ref.cpu().numpy())
        np.testing.assert_array_equal(idx_h, ref_h.cpu().numpy())
        assert staged > 0
