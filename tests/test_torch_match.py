"""The port's matching kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the Pallas kernels
run in interpret mode, as tests/test_pallas_kernel.py runs them.  The same
NumPy-seeded inputs go to both.  tests/test_torch_cuda.py holds the CUDA
kernels against the same plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_analogies_tpu.ops import pallas_match as pm
from image_analogies_tpu_torch.backends.cuda import pack_wk
from image_analogies_tpu_torch.ops import match
from tests.test_torch_cuda import argmin_inputs, packed_inputs, query_rows

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
