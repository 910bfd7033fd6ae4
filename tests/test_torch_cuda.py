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
from image_analogies_tpu_torch.backends.cuda import pack_wk
from image_analogies_tpu_torch.ops import match
from image_analogies_tpu_torch.utils.assets import make_structured
from image_analogies_tpu_torch.utils.ssim import ssim


def argmin_inputs(m=13, f=68, n=900, npad=1024, fp=128, seed=3):
    """Seeded argmin operands: lane-padded DB with a duplicate row pair in
    different 512-row tiles, +inf-norm padding rows, and queries equal to
    (and near) the duplicated row."""
    rng = np.random.default_rng(seed)
    db = np.zeros((npad, fp), np.float32)
    db[:n, :f] = rng.standard_normal((n, f)).astype(np.float32)
    db[700] = db[40]
    q = rng.standard_normal((m, f)).astype(np.float32)
    q[0] = db[40, :f]
    q[1] = db[40, :f] + 1e-3
    dbn = np.full((npad,), np.inf, np.float32)
    dbn[:n] = (db[:n] ** 2).sum(1)
    return q, db, dbn


def packed_inputs(m=13, l=55, n=1000, seed=0):
    """Seeded live-dim rows (one exact duplicate pair) and queries, one of
    them equal to the duplicated row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, l)) * 0.1).astype(np.float32)
    x[600] = x[3]
    q = (rng.standard_normal((m, l)) * 0.1).astype(np.float32)
    q[2] = x[3]
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
@pytest.mark.parametrize("m", [2, 37, 130])
def test_cuda_argmin_matches_plain(m):
    dev = _card()
    args = [torch.from_numpy(a).to(dev)
            for a in argmin_inputs(m=m, n=900, npad=1024)]
    match.reset_launch_counts()
    idx, score = match.argmin_l2(*args)
    ref_i, ref_s = match.argmin_l2_plain(*args)
    assert match.LAUNCHES["argmin_l2"] == 1
    assert torch.equal(idx, ref_i) and int(idx[0]) == 40
    assert int(idx.max()) < 900
    torch.testing.assert_close(score, ref_s, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,npad", [(21, 1024), (200, 1088)])
def test_cuda_packed_best_matches_plain(m, npad):
    dev = _card()
    x, qv = packed_inputs(m=m, n=1000)
    l = qv.shape[1]
    xt = torch.from_numpy(x).to(dev)
    wk, _ = pack_wk(xt, torch.zeros(l, device=dev), 0.5 * (xt * xt).sum(1),
                    torch.arange(l, device=dev), npad)
    g1, g2, _ = match.bf16_split3(torch.from_numpy(qv).to(dev))
    qa = query_rows(g1.to(torch.bfloat16), g2.to(torch.bfloat16),
                    wk.shape[1])
    match.reset_launch_counts()
    idx, val = match.packed_best(qa, wk, 224)
    ref_i, ref_v = match.packed_best_plain(qa, wk, 224)
    assert match.LAUNCHES["packed_best"] == 1
    assert torch.equal(idx, ref_i) and int(idx[2]) == 3
    assert int(idx.max()) < 1000
    torch.testing.assert_close(val, ref_v, rtol=0, atol=1e-6)


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
