"""Matching kernels of the port — the counterpart of the JAX package's
``ops/pallas_match.py`` for the two kernels on the main path:

- ``argmin_l2``: per query, the lexicographic (score, index) minimum over DB
  rows of ``dbn[n] - 2 q.db[n]`` in exact fp32 (replaces ``_argmin_kernel``;
  CUDA source ``csrc/argmin_l2.cu``).
- ``packed_best``: per query, the lexicographic (score, lowest index)
  maximum of one K-wide bf16 dot with fp32 accumulation against the
  lane-packed DB (replaces ``_packed_best_kernel`` in its shipping
  ``packed2k_best`` form; CUDA source ``csrc/packed_best.cu``).

Every kernel wrapper follows one contract: a CPU tensor runs the plain
PyTorch version in this module; a CUDA tensor launches the hand-written
kernel or raises — there is no fallback.  ``LAUNCHES`` counts kernel
launches (one per wrapper call that launched), so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from image_analogies_tpu_torch.ops import _build

# launches of each CUDA kernel since the last reset (plain-version calls on
# CPU tensors do not count)
LAUNCHES = {"argmin_l2": 0, "packed_best": 0}

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


def _chunks(n_tiles: int, q_tiles: int, device_index: int) -> int:
    """DB chunks per launch: about four blocks per SM in all, never more
    chunks than DB tiles."""
    target = 4 * _sm_count(device_index)
    return max(1, min(n_tiles, target // max(q_tiles, 1)))


def _check_cuda(name: str, **tensors) -> None:
    dev = None
    for arg, t in tensors.items():
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


def argmin_l2(q: torch.Tensor, dbp: torch.Tensor, dbn: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query m: (idx, score) = the lexicographic minimum over DB rows n
    of ``dbn[n] - 2 q[m].dbp[n]``, exact fp32, lowest index on ties.

    ``q`` (M, F) fp32; ``dbp`` (Npad, Fp >= F) fp32 (only the first F
    columns are read — the rest is lane padding); ``dbn`` (Npad,) fp32 row
    norms, +inf on padding rows so they never win.  The caller adds
    ||q||^2.  Returns (idx (M,) int32, score (M,) fp32)."""
    if q.dim() != 2 or dbp.dim() != 2 or dbn.dim() != 1:
        raise ValueError("argmin_l2: q (M,F), dbp (N,Fp), dbn (N,)")
    m, f = q.shape
    n, fp = dbp.shape
    if f > fp or dbn.shape[0] != n or m == 0 or n == 0:
        raise ValueError(f"argmin_l2: shapes q {tuple(q.shape)}, dbp "
                         f"{tuple(dbp.shape)}, dbn {tuple(dbn.shape)}")
    if not (q.dtype == dbp.dtype == dbn.dtype == torch.float32):
        raise ValueError("argmin_l2: operands must be float32")
    if q.device.type == "cpu" and dbp.device.type == "cpu" \
            and dbn.device.type == "cpu":
        return argmin_l2_plain(q, dbp, dbn)
    _check_cuda("argmin_l2", q=q, dbp=dbp, dbn=dbn)
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    lib = _build.load("argmin_l2")
    n_chunks = _chunks((n + 127) // 128, (m + 31) // 32, dev)
    part_val = torch.empty((n_chunks, m), dtype=torch.float32,
                           device=q.device)
    part_idx = torch.empty((n_chunks, m), dtype=torch.int32, device=q.device)
    out_idx = torch.empty((m,), dtype=torch.int32, device=q.device)
    out_val = torch.empty((m,), dtype=torch.float32, device=q.device)
    err = lib.ia_argmin_l2(
        q.data_ptr(), m, f, dbp.data_ptr(), n, fp, f, dbn.data_ptr(),
        n_chunks, part_val.data_ptr(), part_idx.data_ptr(),
        out_idx.data_ptr(), out_val.data_ptr(), dev,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "argmin_l2 launch")
    LAUNCHES["argmin_l2"] += 1
    return out_idx, out_val


# ------------------------------------------------------------ packed_best


def packed_best_plain(qa: torch.Tensor, wk: torch.Tensor, k_used: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``packed_best``: ``qa.float() @ wk.float().T`` over
    the first ``k_used`` lanes, then the first (lowest-index) maximum."""
    scores = qa[:, :k_used].float() @ wk[:, :k_used].float().T
    idx = torch.argmax(scores, dim=1)
    val = scores.gather(1, idx[:, None])[:, 0]
    return idx.to(torch.int32), val


def packed_best(qa: torch.Tensor, wk: torch.Tensor, k_used: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query row m: (idx, val) = the lexicographic maximum over DB rows
    n of ``qa[m] . wk[n]`` (bf16 operands, fp32 accumulation), lowest index
    on ties.

    ``qa`` (M, K) bf16 query rows ``[q1|q1|1 1 1|q2|q1|0]``; ``wk`` (Npad,
    K) bf16 packed DB ``[d1|d2|n1 n2 n3|d1|d3|0]`` (``pack_wk`` in
    backends/cuda.py), K in {128, 256, 384, 512}.  Lanes at and past
    ``k_used`` (a multiple of 16; 0 means K) must be zero in ``qa``; the
    kernel skips them.  Returns (idx (M,) int32, val (M,) fp32)."""
    if qa.dim() != 2 or wk.dim() != 2 or qa.shape[1] != wk.shape[1]:
        raise ValueError(f"packed_best: qa {tuple(qa.shape)} and wk "
                         f"{tuple(wk.shape)} must be (M,K) and (N,K)")
    m, k = qa.shape
    n = wk.shape[0]
    k_used = k if k_used == 0 else k_used
    if k not in (128, 256, 384, 512) or k_used % 16 or not 0 < k_used <= k:
        raise ValueError(f"packed_best: K={k} must be 128/256/384/512 and "
                         f"k_used={k_used} a multiple of 16 in (0, K]")
    if m == 0 or n == 0:
        raise ValueError("packed_best: empty operand")
    if not (qa.dtype == wk.dtype == torch.bfloat16):
        raise ValueError("packed_best: operands must be bfloat16")
    if qa.device.type == "cpu" and wk.device.type == "cpu":
        return packed_best_plain(qa, wk, k_used)
    _check_cuda("packed_best", qa=qa, wk=wk)
    dev = qa.device.index if qa.device.index is not None else \
        torch.cuda.current_device()
    lib = _build.load("packed_best")
    n_chunks = _chunks((n + 63) // 64, (m + 127) // 128, dev)
    part_val = torch.empty((n_chunks, m), dtype=torch.float32,
                           device=qa.device)
    part_idx = torch.empty((n_chunks, m), dtype=torch.int32, device=qa.device)
    out_idx = torch.empty((m,), dtype=torch.int32, device=qa.device)
    out_val = torch.empty((m,), dtype=torch.float32, device=qa.device)
    err = lib.ia_packed_best(
        qa.data_ptr(), m, wk.data_ptr(), n, k, k_used, n_chunks,
        part_val.data_ptr(), part_idx.data_ptr(), out_idx.data_ptr(),
        out_val.data_ptr(), dev,
        torch.cuda.current_stream(qa.device).cuda_stream)
    _build.check(lib, err, "packed_best launch")
    LAUNCHES["packed_best"] += 1
    return out_idx, out_val
