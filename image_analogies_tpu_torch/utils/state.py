"""Carry state across the two packages.

The system has no weights; its state is the per-level DB that
``build_features`` produces.  ``level_db_from_numpy`` turns the arrays the
JAX package builds (the NumPy copy of each leaf of its
``_prepare_level_arrays`` output plus the level template's ``diag``,
``off``, ``fine_sqrtw`` and ``live_idx``) into the port's ``LevelDB``, so
the port's scan can run on exactly the state the JAX package built.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from image_analogies_tpu_torch.backends.cuda import LevelDB


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
    ``dbn_pad`` (f32 pads, any shape of Npad elements), ``feat_mean``,
    ``live_idx``, ``db_live`` (packed pads; None otherwise), ``fine_sqrtw``,
    ``off`` and ``diag`` (a sequence of schedule segments).  ``meta``: the
    static ints ``ha``, ``wa``, ``hb``, ``wb``, ``fine_start`` and the
    resolved ``match_mode`` ("exact_hi" or "exact_hi2_2p")."""
    mode = meta["match_mode"]
    if mode not in ("exact_hi", "exact_hi2_2p"):
        raise NotImplementedError(f"match_mode {mode!r} is not ported")
    dbn = arrays.get("dbn_pad")
    i64 = torch.int64
    return LevelDB(
        db=_tensor(arrays["db"], device, torch.float32),
        static_q=_tensor(arrays["static_q"], device, torch.float32),
        a_filt_flat=_tensor(np.asarray(arrays["a_filt_flat"]).reshape(-1),
                            device, torch.float32),
        fine_sqrtw=_tensor(arrays["fine_sqrtw"], device, torch.float32),
        off=_tensor(arrays["off"], device, i64),
        diag=tuple(_tensor(sg, device, i64) for sg in arrays["diag"]),
        db_pad=_tensor(arrays["db_pad"], device),
        dbn_pad=(None if dbn is None else
                 _tensor(np.asarray(dbn).reshape(-1), device, torch.float32)),
        feat_mean=_tensor(arrays.get("feat_mean"), device, torch.float32),
        live_idx=_tensor(arrays.get("live_idx"), device, i64),
        db_live=_tensor(arrays.get("db_live"), device, torch.float32),
        ha=int(meta["ha"]), wa=int(meta["wa"]), hb=int(meta["hb"]),
        wb=int(meta["wb"]), fine_start=int(meta["fine_start"]),
        match_mode=mode)

