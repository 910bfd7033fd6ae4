"""Carry state across the two packages.

The system has no weights; its state is the per-level DB that
``build_features`` produces.  ``level_db_from_numpy`` turns the arrays the
JAX package builds (the NumPy copy of each leaf of its
``_prepare_level_arrays`` output plus the level template's ``diag``,
``off``, ``fine_sqrtw``, ``live_idx`` and, for the other strategies, the
gather maps and ``rowsafe``) into the port's ``LevelDB``, so the port's
scan can run on exactly the state the JAX package built.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from image_analogies_tpu_torch.backends.cuda import LevelDB, PAD_MODES
from image_analogies_tpu_torch.config import STRATEGIES


def _tensor(x: Optional[np.ndarray], device, dtype=None):
    if x is None:
        return None
    x = np.array(x)  # a writable, contiguous host copy
    if x.dtype.name == "bfloat16":
        # NumPy has no native bf16: move the raw 16-bit patterns
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(
            device)
    t = torch.from_numpy(x)
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def level_db_from_numpy(arrays: Mapping[str, Any], meta: Mapping[str, Any],
                        device) -> LevelDB:
    """Build a ``LevelDB`` on ``device`` from NumPy arrays.

    ``arrays``: ``db``, ``static_q``, ``a_filt_flat``, ``db_pad``,
    ``db_pad2`` (exact_hi2's W2), ``dbn_pad`` / ``dbnh_pad`` (norms, any
    shape of Npad elements), ``feat_mean``, ``live_idx``, ``db_live``
    (None where the pad mode has none), ``fine_sqrtw``, ``off``, ``diag``
    (a sequence of schedule segments; wavefront only), and the optional
    ``db_sqnorm``, ``db_rowsafe``, ``db_rowsafe_sqnorm``, ``flat_idx``,
    ``valid``, ``written`` and ``rowsafe`` (the other strategies).
    ``meta``: the static ints ``ha``, ``wa``, ``hb``, ``wb``,
    ``fine_start``, the resolved ``match_mode`` (a key of
    ``backends.cuda.PAD_MODES``), for scan_rescue the per-tile scan tile
    ``scan_tile`` (the JAX side's tile, so the rescue set is the same), and
    ``strategy`` (default "wavefront"), ``n_rowsafe`` and
    ``refine_passes``.  For batched and rowwise ``db_pad`` is the bf16
    scan copy of ``pad_bf16_uncentered`` (or None: the fp32 form)."""
    mode = meta["match_mode"]
    strategy = meta.get("strategy", "wavefront")
    if strategy not in STRATEGIES or strategy == "auto":
        raise ValueError(f"unknown resolved strategy {strategy!r}")
    if mode not in PAD_MODES:
        raise ValueError(f"unknown match_mode {mode!r}")
    i64 = torch.int64

    def norms(name):
        x = arrays.get(name)
        return None if x is None else _tensor(np.asarray(x).reshape(-1),
                                              device, torch.float32)

    def f32(name):
        return _tensor(arrays.get(name), device, torch.float32)

    return LevelDB(
        db=f32("db"), static_q=f32("static_q"),
        a_filt_flat=_tensor(np.asarray(arrays["a_filt_flat"]).reshape(-1),
                            device, torch.float32),
        fine_sqrtw=f32("fine_sqrtw"),
        off=_tensor(arrays["off"], device, i64),
        diag=tuple(_tensor(sg, device, i64) for sg in arrays.get("diag", ())),
        db_pad=_tensor(arrays["db_pad"], device), dbn_pad=norms("dbn_pad"),
        feat_mean=f32("feat_mean"),
        live_idx=_tensor(arrays.get("live_idx"), device, i64),
        db_live=f32("db_live"),
        ha=int(meta["ha"]), wa=int(meta["wa"]), hb=int(meta["hb"]),
        wb=int(meta["wb"]), fine_start=int(meta["fine_start"]),
        match_mode=mode, db_pad2=_tensor(arrays.get("db_pad2"), device),
        dbnh_pad=norms("dbnh_pad"), scan_tile=int(meta.get("scan_tile", 0)),
        strategy=strategy, db_sqnorm=norms("db_sqnorm"),
        db_rowsafe=f32("db_rowsafe"),
        db_rowsafe_sqnorm=norms("db_rowsafe_sqnorm"),
        flat_idx=_tensor(arrays.get("flat_idx"), device, i64),
        valid=f32("valid"), written=f32("written"), rowsafe=f32("rowsafe"),
        n_rowsafe=int(meta.get("n_rowsafe", 0)),
        refine_passes=int(meta.get("refine_passes", 3)))
