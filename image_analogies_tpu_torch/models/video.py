"""Video analogies (counterpart of the single-device part of the JAX
package's ``models/video.py``).

One training pair A -> A' applied to a sequence of B frames with a
temporal term: each frame's feature vectors carry windows of the PREVIOUS
output frame (matched against A' windows on the DB side), weighted by
``params.temporal_weight``, so the synthesis prefers sources consistent
with where it looked last frame.

- ``scheme="sequential"``: frame t consumes frame t-1's actual output.
- ``scheme="two_phase"`` (default): phase 1 synthesizes every frame
  without the temporal term; phase 2 re-synthesizes frames 1.. with the
  term fed by phase 1's output of the frame before (a Jacobi step of the
  sequential recurrence).  Frame 0 keeps its phase-1 output.

Every frame's luminance remap is anchored on the clip's first frame, so
the A mapping is one for the whole clip, and one matcher serves the whole
clip.

**Frame sharding** (the JAX package's mesh path): with
``params.data_shards > 1`` the two_phase scheme advances every frame of a
phase one pyramid level per ``parallel.step.multichip_level_step`` call
on the (data, db) mesh of a running world (``parallel/``): the frames
shard over ``data`` (padded to its width by repeating the last frame; the
padded outputs are dropped), the A/A' DB is built once per level, sharded
over ``db``, and only the per-frame query sides differ.  Each level's
stacked (frames, Nb) planes reach every rank, so a checkpoint is one npz
per (phase, level) under a clip digest (rank 0 writes, then a barrier;
every rank reads a resume), and every rank returns the same clip, equal to
the serial clip's frames.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

import torch
import torch.distributed as dist

from image_analogies_tpu_torch.backends import get_backend
from image_analogies_tpu_torch.backends.base import LevelJob
from image_analogies_tpu_torch.backends.cuda import (
    CudaMatcher,
    prepare_query_arrays,
    slim_for_mesh,
)
from image_analogies_tpu_torch.config import AnalogyParams
from image_analogies_tpu_torch.models.analogy import (
    AnalogyResult,
    _color_output,
    _prep_planes,
    create_image_analogy,
)
from image_analogies_tpu_torch.obs import device as obs_device
from image_analogies_tpu_torch.obs import metrics as obs_metrics
from image_analogies_tpu_torch.obs import trace as obs_trace
from image_analogies_tpu_torch.ops.features import spec_for_level
from image_analogies_tpu_torch.ops.pyramid import (
    build_pyramid_np,
    num_feasible_levels,
)
from image_analogies_tpu_torch.parallel import distributed
from image_analogies_tpu_torch.parallel.mesh import make_mesh
from image_analogies_tpu_torch.tune import resolve as tune_resolve
from image_analogies_tpu_torch.utils import checkpoint as ckpt
from image_analogies_tpu_torch.utils import failure
from image_analogies_tpu_torch.utils import logging as ialog
from image_analogies_tpu_torch.utils.ssim import ssim

SCHEMES = ("sequential", "two_phase")


@dataclass
class VideoResult:
    frames: List[np.ndarray]  # synthesized B' frames
    frames_y: List[np.ndarray]  # synthesized luminance planes
    stats: List[Dict[str, Any]] = field(default_factory=list)
    # each frame's (H,W) int32 flat indices into A (the port's addition:
    # what a card run is held to against its CPU run)
    source_maps: List[np.ndarray] = field(default_factory=list)

    def flicker(self) -> List[float]:
        """Temporal stability: SSIM between consecutive output frames
        (higher = less flicker, the quantity the temporal term exists to
        raise).  len == n_frames - 1."""
        return [float(ssim(self.frames_y[t], self.frames_y[t + 1]))
                for t in range(len(self.frames_y) - 1)]


def video_analogy(
    a: np.ndarray,
    ap: np.ndarray,
    frames: Sequence[np.ndarray],
    params: AnalogyParams = AnalogyParams(temporal_weight=1.0),
    scheme: str = "two_phase",
    backend: Optional[CudaMatcher] = None,
) -> VideoResult:
    """Synthesize every frame of ``frames`` by the analogy A : A'.

    The clip runs on ``params.device`` ("cuda" by default, which raises
    where there is no card); ``backend`` replaces the clip's one matcher.
    Each level record of ``stats`` carries ``frame`` and ``phase`` ("seq",
    "phase1" or "phase2"), and with ``data_shards`` > 1 (frame sharding,
    two_phase only; every rank of the world calls this alike) ``mesh``
    {"data": d, "db": b}."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}")
    frames = list(frames)
    if not frames:
        return VideoResult(frames=[], frames_y=[])
    if params.data_shards > 1:
        if scheme != "two_phase":
            raise ValueError(
                "frame sharding (data_shards > 1) requires the "
                "data-parallel two_phase scheme; the sequential recurrence "
                "cannot shard")
        if backend is not None:
            raise ValueError("data_shards > 1 runs the mesh path; a custom "
                             "backend cannot be injected")
        if params.backend != "cuda":
            raise ValueError(
                "data_shards > 1 requires backend='cuda' (the mesh path); "
                f"got backend={params.backend!r}")
        if params.strategy in ("exact", "rowwise"):
            raise ValueError(
                f"strategy {params.strategy!r} has no mesh scan core; frame "
                "sharding supports 'wavefront' (oracle parity), 'batched', "
                "or 'auto'")
        if not distributed.is_writer():
            params = params.replace(log_path=None, profile_dir=None,
                                    save_levels_dir=None)
    if backend is None:
        backend = get_backend(params)
    # one obs run (the frames' syntheses join it) and one geometry
    # resolution a key for the whole clip, as in the JAX package
    with obs_trace.run_scope(params, manifest_extra=dict(
            tune_resolve.manifest_info(),
            device=str(getattr(backend, "device", None)))):
        with tune_resolve.pin_scope():
            return _clip(a, ap, frames, params, scheme, backend)


def _clip(a, ap, frames, params, scheme, backend) -> VideoResult:
    stats: List[Dict[str, Any]] = []
    if params.data_shards > 1:
        mesh = make_mesh(db_shards=params.db_shards,
                         data_shards=params.data_shards)
        with obs_trace.span("phase", phase="phase1"):
            outs = _sharded_phase(a, ap, frames, params, mesh, backend,
                                  None, stats, "phase1")
        if len(frames) > 1:
            prevs = [outs[t - 1].bp_y for t in range(1, len(frames))]
            with obs_trace.span("phase", phase="phase2"):
                outs = outs[:1] + _sharded_phase(
                    a, ap, frames, params, mesh, backend, prevs, stats,
                    "phase2", first=1)
        return VideoResult(frames=[r.bp for r in outs],
                           frames_y=[r.bp_y for r in outs], stats=stats,
                           source_maps=[r.source_map for r in outs])

    def synth(b, prev_y, tag, idx):
        res = create_image_analogy(a, ap, b, params, backend=backend,
                                   temporal_prev=prev_y,
                                   remap_anchor=frames[0])
        for st in res.stats:
            st.update(frame=idx, phase=tag)
            stats.append(st)
        return res

    if scheme == "sequential":
        outs, prev_y = [], None
        for t, b in enumerate(frames):
            res = synth(b, prev_y, "seq", t)
            prev_y = res.bp_y
            outs.append(res)
    else:
        phase1 = [synth(b, None, "phase1", t) for t, b in enumerate(frames)]
        outs = [phase1[0]] + [
            synth(frames[t], phase1[t - 1].bp_y, "phase2", t)
            for t in range(1, len(frames))]
    return VideoResult(frames=[r.bp for r in outs],
                       frames_y=[r.bp_y for r in outs], stats=stats,
                       source_maps=[r.source_map for r in outs])


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _load_stack(ck_dir: str, level: int, digest: str):
    """A level's stacked checkpoint on every rank: rank 0 reads first (a
    damaged file is quarantined once), then the others."""
    got = None
    if distributed.is_writer():
        got = ckpt.load_level(ck_dir, level, digest=digest)
    _barrier()
    if not distributed.is_writer():
        got = ckpt.load_level(ck_dir, level, digest=digest)
    return got


def _sharded_phase(a, ap, frames, params: AnalogyParams, mesh,
                   matcher: CudaMatcher, temporal_prevs, stats, tag: str,
                   first: int = 0) -> List[AnalogyResult]:
    """Frames ``frames[first:]`` level-lockstep on the (data, db) mesh (the
    JAX ``_sharded_phase``): every frame advances one pyramid level per
    ``multichip_level_step`` call; the A/A' DB is built once per level
    (``CudaMatcher.build_mesh_level``, remapped against the clip's first
    frame, as the serial clip does) and each frame's query side beside it.
    ``temporal_prevs`` (phase 2) are the previous frames' phase-1 planes.
    Returns the frames' results; level records go to ``stats``."""
    from image_analogies_tpu_torch.parallel.step import multichip_level_step

    clip = frames[first:]
    t_real = len(clip)
    data = mesh.shape["data"]
    t_pad = -(-t_real // data) * data
    idx = list(range(t_real)) + [t_real - 1] * (t_pad - t_real)
    # the A side is the clip's: remapped against its first frame
    a_src, _, a_filt, ap_rgb, _ = _prep_planes(a, ap, frames[0], params,
                                               remap_anchor=frames[0])
    preps = [_prep_planes(a, ap, f, params, remap_anchor=frames[0])
             for f in clip]
    b_srcs = [preps[i][1] for i in idx]
    min_shape = (min(a_src.shape[0], min(b.shape[0] for b in b_srcs)),
                 min(a_src.shape[1], min(b.shape[1] for b in b_srcs)))
    levels = num_feasible_levels(min_shape, params.levels, params.patch_size)
    src_channels = 1 if a_src.ndim == 2 else a_src.shape[-1]
    temporal = params.temporal_weight > 0 and temporal_prevs is not None
    a_src_pyr = build_pyramid_np(a_src, levels)
    a_filt_pyr = build_pyramid_np(a_filt, levels)
    b_pyrs = [build_pyramid_np(b, levels) for b in b_srcs]
    t_pyrs = ([build_pyramid_np(np.asarray(temporal_prevs[i], np.float32),
                                levels) for i in idx] if temporal else None)
    ck_dir = digest = None
    if params.checkpoint_dir:
        ck_dir = os.path.join(params.checkpoint_dir, tag)
        digest = ckpt.clip_digest(params, a_src.shape[:2],
                                  b_srcs[0].shape[:2], t_real, tag)
    bp_stack = s_stack = None  # (t_pad, Nb) planes of the level before
    counts, recs = [], []
    for level in range(levels - 1, -1, -1):
        coarse = level + 1 < levels
        hb, wb = b_pyrs[0][level].shape[:2]

        def job(t: int) -> LevelJob:
            h2, w2 = b_pyrs[0][level + 1].shape[:2] if coarse else (0, 0)
            return LevelJob(
                level=level,
                spec=spec_for_level(params, level, levels, src_channels,
                                    temporal=temporal),
                kappa_mult=params.kappa_factor(level) ** 2,
                a_src=a_src_pyr[level], a_filt=a_filt_pyr[level],
                b_src=b_pyrs[t][level],
                a_src_coarse=a_src_pyr[level + 1] if coarse else None,
                a_filt_coarse=a_filt_pyr[level + 1] if coarse else None,
                b_src_coarse=b_pyrs[t][level + 1] if coarse else None,
                b_filt_coarse=(bp_stack[t].reshape(h2, w2) if coarse
                               else None),
                a_temporal=a_filt_pyr[level] if temporal else None,
                b_temporal=t_pyrs[t][level] if temporal else None)

        if (ck_dir and params.resume_from_level is not None
                and level > params.resume_from_level):
            loaded = _load_stack(ck_dir, level, digest)
            if loaded is not None:
                bp_stack = torch.from_numpy(loaded[0]).to(matcher.device)
                s_stack = torch.from_numpy(loaded[1]).to(matcher.device)
                ialog.emit({"event": "resume_level", "level": level,
                            "phase": tag}, params.log_path)
                continue

        def _level():
            # the whole level's device work, so a retry rebuilds it all
            job0 = job(0)
            lvl = matcher.build_mesh_level(job0)
            fq = torch.stack([lvl.static_q] + [
                prepare_query_arrays(
                    job0.spec, matcher._t(jt.b_src),
                    matcher._t(jt.b_src_coarse),
                    matcher._t(jt.b_filt_coarse), matcher._t(jt.b_temporal))
                for jt in (job(t) for t in range(1, t_pad))])
            return multichip_level_step(
                mesh, fq, lvl.db_sharded, lvl.dbn_sharded, lvl.afilt_sharded,
                slim_for_mesh(lvl), job0.kappa_mult, wk_shard=lvl.db_pad,
                dbl_shard=lvl.dblive_sharded, bf16_approx=matcher.bf16_approx)

        with obs_trace.span("level", level=level, phase=tag):
            bp_stack, s_stack, n = failure.run_with_retry(
                _level, retries=params.level_retries,
                context={"level": level, "phase": tag},
                log_path=params.log_path)
            obs_device.record_memory(level, params.log_path)
        if ck_dir:
            if distributed.is_writer():
                ckpt.save_level(ck_dir, level,
                                bp_stack.cpu().numpy().astype(np.float32),
                                s_stack.cpu().numpy().astype(np.int32),
                                digest=digest)
            _barrier()
        counts.append(n[:, 0])
        for i in range(t_real):
            rec = {"level": level, "frame": first + i, "phase": tag,
                   "db_rows": a_src_pyr[level].shape[0]
                   * a_src_pyr[level].shape[1],
                   "pixels": hb * wb, "backend": matcher.device.type,
                   "strategy": matcher._strategy, "mesh": dict(mesh.shape)}
            recs.append((rec, len(counts) - 1, i))
            ialog.emit(rec, params.log_path)

    # ONE fetch for the finest planes and every level's counts
    with obs_trace.span("fetch", phase=tag):
        n_all = (torch.stack(counts).cpu().numpy() if counts else None)
        bp0 = bp_stack.cpu().numpy().astype(np.float32)
        s0 = s_stack.cpu().numpy().astype(np.int32)
    obs_metrics.inc("fetch.bytes", int(bp0.nbytes) + int(s0.nbytes))
    ratios = {}
    for rec, lv, i in recs:
        rec["coherence_ratio"] = float(n_all[lv, i]) / max(rec["pixels"], 1)
        ratios[f"l{rec['level']}_f{rec['frame']}"] = round(
            rec["coherence_ratio"], 4)
        stats.append(rec)
        if obs_metrics._ACTIVE:
            obs_metrics.inc("kappa.coherence_px",
                            rec["coherence_ratio"] * rec["pixels"])
            obs_metrics.inc("kappa.total_px", rec["pixels"])
    ialog.emit({"event": "coherence_ratios", "phase": tag,
                "ratios": ratios}, params.log_path)
    hb, wb = b_pyrs[0][0].shape[:2]
    out = []
    for i in range(t_real):
        bp_y = bp0[i].reshape(hb, wb)
        s_map = s0[i].reshape(hb, wb)
        out.append(AnalogyResult(
            bp=_color_output(bp_y, s_map, params, ap_rgb, preps[i][4]),
            bp_y=bp_y, source_map_raw=s_map))
    return out
