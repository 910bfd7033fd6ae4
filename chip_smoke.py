#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port (``image_analogies_tpu_torch``) builds
and runs its paths on one NVIDIA card, and that what comes out is right.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, one line each (a failing phase exits non-zero; nothing is caught
and carried on):

1. env        — torch/CUDA versions, the card, and the build of every CUDA
                kernel from the sources in this checkout (one nvcc per
                source, all started together).
2. kernels    — each kernel against its plain PyTorch version on the card
                at the shapes its path gives it (seeded inputs with
                duplicate rows, padding rows and, for the per-tile scans, an
                all-padding tile): picks equal except inside the stated
                score band, scores within the stated tolerance; CUDA-event
                times of the kernel, the plain version, a PyTorch yardstick
                and the bound the card's peak rates allow for the function
                (its own width: F = 68 features, 2L = 110 or 4L + 3 = 223
                packed lanes, not the kernel's lanes rounded up to 16).
                ``argmin_l2`` also at each wavefront segment shape of
                npr_1024's argmin levels 2-4 (padded batch M, DB of the
                level's N), and ``packed_best`` (packed2k) at each segment
                shape of levels 0-1 beside its headline M = 352: held
                against the plain version, timed beside the yardstick and
                bound, device ms weighted by the segments' steps per level
                and in all.  ``argmin2_l2`` (two_pass's top-2 scan, q_split)
                the same way at every segment shape of all five levels and
                at the M = 352 headline, ``pertile_champions``
                (scan_rescue's per-tile scan, q_split, each level's scan
                tile, the last tile all padding; the launch timed at every
                split of a level's few scan tiles in parts) and
                ``packed3_best`` (exact_hi2's three-pass scan, 2L = 110 of
                128 lanes) too; packed3 also once at the RGB width (256
                lanes) at M = 352, N = 2^20, and past 256 lanes (the width
                rule's packed3w_best.cu, its launch plan printed) at a small
                shape and at M = 352, N = 2^20 (2L = 288, 296, 384 and
                414).  With ``--parent DIR`` also the
                six level-phase kernels of the checkout in DIR on the same
                inputs (a child process each): argmin_l2's (idx, val) must
                be the same bits, argmin2_l2's (i1, i2), pertile's and
                packed3_best's picks >= 99.9% equal; equal picks and val
                bits of argmin2_l2, pertile_champions, packed3_best and
                packed_best are counted.
                ``argmin_l2_bf16`` (the batched/rowwise approximate match)
                at each of batched npr_1024's five levels (one scan row of
                M = 1024 >> l queries against the level's bf16 rows-above
                DB; level 0, M = 1024 against 1,048,576 rows, is its row in
                the table), launches and weighted ms per level and in all;
                with ``--parent`` its picks >= 99.9% equal to the parent's,
                equal picks and val bits counted.  ``packed_champions``
                (the per-tile witness of packed3, on no path) at M = 352,
                N = 2^20, tile 4,096: folded at 2L = 110 (its row in the
                table) and 414 (past 256 lanes: packed3w_best.cu), and
                unfolded at 110.  The four superseded packed forms (on no
                path) at M = 64, N = 65,536 (their rows in the table) and
                at M = 352, N = 2^20.  Both have launches 0 in the table;
                with ``--parent`` their picks >= 99.9% equal to the
                parent's, equal picks and val bits counted.
3. main       — ``create_image_analogy`` with ``PRESETS["npr_1024"]`` on the
                1024^2 structured inputs of the cached oracle, cold then
                warm: per-level scan and build ms, wall-clock, kernel launch
                counts (each kernel launched once per wavefront step of its
                levels, no other kernel launched).
4. oracle     — SSIM of B' and the tie-audit of all five levels' source maps
                against ``bench_cache/oracle_1024_seed7.npz``; then one
                main-path run on the seed-13 inputs, held to the same
                limits against ``bench_cache/oracle_1024_seed13.npz``.
5. exact_hi2  — the same run, cold then warm, with
                ``match_mode="exact_hi2"`` (the packed3 scan at every
                level), held to the main path's oracle limits.
6. rescue     — ``match_mode="scan_rescue"`` (IA_EXPERIMENTAL=1) at 1024^2,
                cold then warm: one per-tile launch per step, B' finite,
                SSIM vs the oracle >= 0.90 (a wiring check: the mode is not
                a parity mode); then one run of ``scan_rescue_1p`` at 256^2.
7. two_pass   — the same for ``two_pass`` and ``two_pass_1p``.
8. batched    — ``strategy="batched"`` with the npr_1024 preset on the
                oracle inputs, cold then warm: per-level ms, wall-clock,
                peak memory, coherence and refined ratios, SSIM vs the
                oracle (printed: batched is not a parity mode);
                ``argmin_l2_bf16`` launched exactly once per scan row (1,984)
                and no other kernel; then the self-analogy B = A at 256^2
                (3 levels; SSIM of B' vs A' >= 0.9 and identity source map
                >= 0.8, the JAX package's floors) and at 1024^2 (printed).
9. gate       — ``bf16_scoring=True`` at 64^2: the parity gate's verdict on
                this card (printed, not asserted), the mode each level ran.
10. card_vs_cpu — exact_hi2, scan_rescue[_1p] and two_pass[_1p] at 96^2
                (3 levels) on the card and on the CPU, exact_hi2 and
                scan_rescue on RGB sources (``color_mode="source_rgb"``:
                exact_hi2 scans 256 lanes in three passes), exact_hi2 on
                RGB sources at patch 7 (64^2, 2 levels: 414 and 342 lanes,
                packed3w_best.cu at every wavefront step), then batched at
                96^2 and rowwise at 64^2 against a CPU run of the same bf16
                approximate match (the kernel's plain version) and exact at
                48^2 against the CPU's fp32 scan: source maps differ on < 2%
                of pixels, SSIM >= 0.99.
11. modes_small — the five golden configs (``examples/make_golden.py``)
                at their sizes, on the port's rebuilt golden inputs, through
                ``modes.*`` and ``video_analogy`` on the card and on the CPU
                (card_vs_cpu's limits), then super_resolution on RGB
                sources with ``source_rgb`` and exact_hi2_2p at 64^2 (832
                and 688 lanes: packed2kw_best.cu).
12. modes      — each application at 1024^2 (texture_by_numbers, the oil
                filter, super_resolution, texture_synthesis), cold then
                warm, and super_resolution on RGB sources once (packed2kw at
                832 and 688 lanes): per-level mode, ms and coherence, wall,
                peak memory, launches held to each level's wavefront steps
                on the kernel its lane width routes to.
13. video      — ``video_analogy`` with the video preset on three 512^2
                frames: two_phase cold then warm, sequential once, each
                frame's stats, ``flicker()`` and the launch counts.

The kernels phase also runs packed_best at the widths the applications
reach (M = 352, N = 2^20: 304-368 lanes on packed2k_best.cu, 608-1,040 on
packed2kw_best.cu, its row in the table at 832 lanes, its launches from
the modes phase's RGB run).

``--phases main,profile`` adds one more warm run under torch.profiler
(device time by kernel, device busy share); ``--phases batched_profile``
profiles one warm batched run at 1024^2 (5 levels) the same way; ``--ptxas``
prints each kernel's registers, shared memory and spills.

Then the kernel table as one JSON line (each kernel's launches from the run
of its path), the card's name and power limit, and, as the last line,
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "kernels", "main", "oracle", "exact_hi2", "rescue",
          "two_pass", "batched", "gate", "card_vs_cpu", "modes_small",
          "modes", "video")

# cycles of the spin kernel ahead of each timed call (~0.5 ms at the
# H100's clocks, longer than any wrapper's host work)
SPIN_CYCLES = 1_000_000

# peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_HBM_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12

# main-path shapes (npr_1024): the widest anti-diagonal batch of each
# kernel's levels and the DB rows it scans
ARGMIN_SHAPE = dict(m=88, npad=65536, f=68, fp=128)  # level 2 (256^2)
ARGMIN_LEVELS = (2, 3, 4)  # the fp32 argmin's levels (256^2 to 64^2)
PACKED_SHAPE = dict(m=352, npad=1048576, lw=55)  # level 0 (1024^2)
PACKED_LEVELS = (0, 1)  # the packed2k scan's levels (1024^2, 512^2)
# level 0 of the new modes: the bf16 centered DB (F = 68 of Fp = 128) and
# the packed3 arrays (2L = 110 of Kp = 128)
SCAN_SHAPE = dict(m=352, npad=1048576, f=68, fp=128, lw=55)
# packed3 at the RGB width (exact_hi2 on RGB and source_rgb sources at
# patch 5: 2L = 256 of Kp = 256) and past 256 lanes (packed3w_best.cu): 2L
# = 300 of 384 at a small shape, and at the level-0 headline 2L = 288, 296
# (L = 148: the video preset's temporal block on RGB sources), 384 and 414
# (L = 207: super_resolution's patch 7 on RGB sources, the shape of the
# kernel's row in the table)
P3_RGB_SHAPE = dict(m=352, npad=1048576, lw=128)
P3_WIDE_SHAPE = dict(m=64, npad=65536, lw=150)
P3_PAST256_SHAPES = (dict(m=352, npad=1048576, lw=144),
                     dict(m=352, npad=1048576, lw=148),
                     dict(m=352, npad=1048576, lw=192),
                     dict(m=352, npad=1048576, lw=207))
P3W_ROW_LW = 207
# packed2k at the widths the modes reach, M = 352 against N = 2^20 (4L + 3
# lanes, rounded to 16): L = 73, 80, 87, 91 (super_resolution's coarsest
# level 304, the video preset's temporal block 336, texture_by_numbers'
# RGB labels 352, super_resolution 368: packed2k_best.cu) and past 512
# lanes (packed2kw_best.cu) L = 148, 171, 207, 256 (RGB sources with
# color_mode="source_rgb": the video preset's block 608, super_resolution
# 688 and 832, with the temporal block 1,040); 832 lanes is the wide
# instance's row in the table
P2K_WIDTHS = (73, 80, 87, 91, 148, 171, 207, 256)
P2KW_ROW_LW = 207
# the superseded packed forms: the row in the table (M = 64, N = 65,536),
# then the shape of the other packed rows (M = 352, N = 2^20), L = 55
FORMS_SHAPES = (dict(m=64, npad=65536), dict(m=352, npad=1048576))
FORMS_LW = 55

# the kernel (launch-count key) each resolved anchor mode runs
ANCHOR_KERNEL = {"exact_hi": "argmin_l2", "exact_hi2_2p": "packed_best",
                 "exact_hi2": "packed3_best",
                 "scan_rescue": "pertile_champions",
                 "scan_rescue_1p": "pertile_champions",
                 "two_pass": "argmin2_l2", "two_pass_1p": "argmin2_l2"}
NEW_MODES = ("exact_hi2", "scan_rescue", "scan_rescue_1p", "two_pass",
             "two_pass_1p")

# tolerances of kernel vs plain on the card: both are fp32 sums of the
# same terms in different orders; picks may differ only where the plain
# version's best two scores lie within SCORE_BAND of each other
ARGMIN_ATOL = 1e-5
PACKED_ATOL = 1e-5
SCORE_BAND = 2e-5
# past 256 lanes the tensor cores' fp32 sum strays further from the exact
# one (tests/test_torch_cuda.py test_cuda_packed3_scores_against_float64)
P3W_ATOL = 4e-5

SSIM_MIN = 0.98
UNEXPLAINED_MAX = 1e-4
# the probe modes are not parity modes: this floor catches wiring faults
PROBE_SSIM_MIN = 0.90
# the JAX package's self-analogy floors for the fast strategies
# (tests/test_backend_equivalence.py)
SELF_SSIM_MIN = 0.9
SELF_IDENTITY_MIN = 0.8
# card against CPU (tests/test_torch_cuda.py's limits)
CARD_CPU_MISMATCH_MAX = 0.02
CARD_CPU_SSIM_MIN = 0.99
# input digests of the cached 1024^2 CPU oracles, by make_structured seed
ORACLE_DIGESTS = {7: "8512fc90ebcc2781", 13: "8f8cccf9bd2128a6"}


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, sort_keys=False), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exit {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warm: int = 2, flush=None) -> float:
    """Median device ms per call by CUDA events around each call (warmed;
    ``flush`` runs between calls, outside the timed window).  A spin kernel
    queued before the start event keeps the card busy while the host
    issues the call, so the window holds the call's device work and not
    the wrapper's Python time; the median drops the calls a stalled host
    thread still let the card idle through."""
    import statistics

    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / PEAK_HBM_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_picks(name, idx, val, ref_idx, ref_val, second, atol,
                band=SCORE_BAND):
    """Scores within ``atol``; picks equal except where the plain
    version's best two scores are within ``band`` (SCORE_BAND)."""
    import torch

    err = float((val - ref_val).abs().max())
    if not err <= atol:
        fail(f"{name}: max |score - plain| {err:.3g} > {atol}")
    diff = idx != ref_idx
    gap = (ref_val - second).abs()
    bad = diff & (gap > band)
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} picks differ from the plain "
             f"version outside the {band} band")
    return err, int(diff.sum())


def check_tiles(name, vals, idx, ref_vals, ref_idx, second, atol):
    """``check_picks`` over the finite per-tile champions; all-padding tiles
    (-inf) must match the plain version's value and index exactly."""
    import torch

    fin = torch.isfinite(ref_vals)
    if not torch.equal(torch.isfinite(vals), fin) or not torch.equal(
            idx[~fin], ref_idx[~fin]):
        fail(f"{name}: all-padding tiles differ from the plain version")
    return check_picks(name, idx[fin], vals[fin], ref_idx[fin],
                       ref_vals[fin], second[fin], atol)


def flusher(dev):
    """A call that overwrites a buffer larger than the 50 MB L2, so no
    timed call finds the previous one's tail resident."""
    import torch

    scratch = torch.empty((256 << 20,), dtype=torch.uint8, device=dev)
    return lambda: scratch.fill_(1)


def kernel_row(name, source, replaces, err, k_ms, p_ms, l_ms, b):
    return dict(
        name=name, route="cuda",
        source=f"image_analogies_tpu_torch/ops/csrc/{source}",
        replaces=f"image_analogies_tpu/ops/pallas_match.py:{replaces}",
        launches=0, max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b[0],
        bound_by=b[1], library_ms=l_ms)


def phase_env(ptxas: bool):
    import torch

    from image_analogies_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build(ptxas_info=ptxas)
    secs = time.perf_counter() - t0
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, card=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=nvidia_smi(),
        build_s=round(secs, 3),
        nvcc_s={k: round(v[0], 3) for k, v in built.items()})
    if ptxas:
        for name, (_, log) in built.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    print(f"[ptxas {name}] {line.strip()}", flush=True)


def level_shapes(levels):
    """[(level, npad, m, steps)]: every wavefront segment of npr_1024's
    ``levels``, its padded batch M and its step count
    (``_diag_schedule_np``, skew patch // 2 + 1), against the level's DB of
    h^2 rows."""
    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.backends.cuda import _diag_schedule_np

    c = PRESETS["npr_1024"].patch_size // 2 + 1
    out = []
    for level in levels:
        h = 1024 >> level
        out += [(level, h * h, int(sg.shape[1]), int(sg.shape[0]))
                for sg in _diag_schedule_np(h, h, c)]
    return out


def merge_repeats(shapes):
    """``shapes`` with each repeated (level, npad, m) once, in order of
    first appearance, its steps summed: a level's batch width ramps up and
    down again, so a segment shape may come more than once."""
    steps = {}
    for level, npad, m, st in shapes:
        steps[(level, npad, m)] = steps.get((level, npad, m), 0) + st
    return [(*key, st) for key, st in steps.items()]


def argmin_operands(m, npad, f=68, fp=128, seed=11, dup=None):
    """Seeded numpy operands of ``argmin_l2``: DB rows uniform in [0, 0.2)
    in the first f of fp lanes, the last 100 rows padding (zero features,
    +inf norms), row dup[1] a copy of row dup[0] (default N/64 and 15N/16:
    different DB chunks) and query 0 equal to it.  Returns (q, db, dbn,
    n_real, dup[0])."""
    import numpy as np

    n_real = npad - 100
    lo, hi = dup or (npad // 64, npad * 15 // 16)
    rng = np.random.default_rng(seed)
    db = np.zeros((npad, fp), np.float32)
    db[:n_real, :f] = rng.uniform(0, 1, (n_real, f)).astype(np.float32) * .2
    db[hi] = db[lo]  # duplicate rows: ties go to the lowest index
    q = rng.uniform(0, 1, (m, f)).astype(np.float32) * 0.2
    q[0] = db[lo, :f]
    dbn = np.full((npad,), np.inf, np.float32)
    dbn[:n_real] = (db[:n_real] ** 2).sum(1)
    return q, db, dbn, n_real, lo


def argmin_bound(m, npad, f):
    """Bound of one fp32 argmin call: q, the F used DB columns and the norms
    read once, (idx, val) written once; 2 M N F operations."""
    return bound(4 * (m * f + npad * f + npad) + 8 * m, 2 * m * npad * f,
                 PEAK_FP32_FLOP_S)


def run_argmin_shapes(match, shapes):
    """``match.argmin_l2`` on the seeded operands of each (level, npad, m,
    steps): {"npad/m": (idx, val, device ms, operands on the card, real
    rows, duplicated row)}."""
    import torch

    out = {}
    for _, npad, m, _ in shapes:
        q, db, dbn, n_real, lo = argmin_operands(m, npad, seed=npad + m)
        args = tuple(torch.from_numpy(x).cuda() for x in (q, db, dbn))
        idx, val = match.argmin_l2(*args)
        ms = cuda_time_ms(lambda: match.argmin_l2(*args), reps=50)
        out[f"{npad}/{m}"] = (idx.cpu().numpy(), val.cpu().numpy(), ms, args,
                              n_real, lo)
    return out


def phase_argmin_kernel(rows):
    """argmin_l2 (the exact_hi scan) at its headline shape: level 2 of
    npr_1024, M = 88, Npad = 65,536, F = 68 of Fp = 128 lanes."""
    import torch

    from image_analogies_tpu_torch.ops import match

    s = ARGMIN_SHAPE
    m, npad, f, fp = s["m"], s["npad"], s["f"], s["fp"]
    arrays = argmin_operands(m, npad, f, fp, seed=11, dup=(1000, 64000))
    n_real = arrays[3]
    qd, dbd, dbnd = (torch.from_numpy(x).cuda() for x in arrays[:3])
    match.reset_launch_counts()
    idx, val = match.argmin_l2(qd, dbd, dbnd)
    torch.cuda.synchronize()
    scores = dbnd[None, :] - 2.0 * (qd @ dbd[:, :f].T)
    ref_idx, ref_val = match.argmin_l2_plain(qd, dbd, dbnd)
    second = torch.topk(scores, 2, dim=1, largest=False).values[:, 1]
    err, ndiff = check_picks("argmin_l2", idx, val, ref_idx, ref_val,
                             second, ARGMIN_ATOL)
    if int(idx[0]) != 1000 or int(idx.max()) >= n_real:
        fail(f"argmin_l2: duplicate/padding rule broken (idx[0]="
             f"{int(idx[0])}, max {int(idx.max())})")
    k_ms = cuda_time_ms(lambda: match.argmin_l2(qd, dbd, dbnd), reps=50)
    p_ms = cuda_time_ms(lambda: match.argmin_l2_plain(qd, dbd, dbnd),
                        reps=20)
    dbt = dbd[:, :f].T
    l_ms = cuda_time_ms(
        lambda: torch.addmm(dbnd, qd, dbt, alpha=-2.0).min(dim=1), reps=20)
    # the same window around one empty launch: what any single kernel
    # call pays between the two events before it does any work
    floor_ms = cuda_time_ms(lambda: torch.cuda._sleep(1), reps=50)
    b_ms, b_by = argmin_bound(m, npad, f)
    rows["argmin_l2"] = kernel_row("argmin_l2", "argmin_l2.cu", 51, err,
                                   k_ms, p_ms, l_ms, (b_ms, b_by))
    say("kernels", kernel="argmin_l2", m=m, npad=npad, f=f,
        max_abs_err=err, picks_differing_in_band=ndiff, ms=k_ms,
        plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
        launch_floor_ms=floor_ms)


def phase_argmin_levels(parent):
    """argmin_l2 at every wavefront segment shape of npr_1024's argmin
    levels (2-4), each on a DB of its level's N: held against its plain
    version (scores within ARGMIN_ATOL, picks equal outside SCORE_BAND,
    the duplicate and padding rules), timed beside the addmm + min
    yardstick and the bound; device ms weighted by each segment's steps,
    per level and in all.  With ``parent`` (a checkout of another commit,
    e.g. the parent): that tree's argmin_l2 on the same inputs in a child
    process, whose picks and scores must be the same bits, and its times."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.ops import match

    shapes = level_shapes(ARGMIN_LEVELS)
    got = run_argmin_shapes(match, shapes)
    theirs = None
    if parent:
        theirs, parent_ms = parent_bits("argmin", parent, shapes)
    total = dict(ms=0.0, library_ms=0.0, bound_ms=0.0, parent_ms=0.0)
    for level in ARGMIN_LEVELS:
        segs, tot = [], dict.fromkeys(total, 0.0)
        for _, npad, m, steps in (s for s in shapes if s[0] == level):
            key = f"{npad}/{m}"
            idx, val, k_ms, (qd, dbd, dbnd), n_real, lo = got[key]
            f = qd.shape[1]
            scores = dbnd[None, :] - 2.0 * (qd @ dbd[:, :f].T)
            ref_idx, ref_val = match.argmin_l2_plain(qd, dbd, dbnd)
            second = torch.topk(scores, 2, dim=1, largest=False).values[:, 1]
            del scores
            name = f"argmin_l2 level {level} M={m}"
            err, ndiff = check_picks(name, torch.from_numpy(idx).cuda(),
                                     torch.from_numpy(val).cuda(), ref_idx,
                                     ref_val, second, ARGMIN_ATOL)
            if int(idx[0]) != lo or int(idx.max()) >= n_real:
                fail(f"{name}: duplicate/padding rule broken")
            dbt = dbd[:, :f].T
            l_ms = cuda_time_ms(lambda: torch.addmm(
                dbnd, qd, dbt, alpha=-2.0).min(dim=1), reps=20)
            seg = dict(m=m, steps=steps, ms=k_ms, library_ms=l_ms,
                       bound_ms=argmin_bound(m, npad, f)[0],
                       max_abs_err=err, picks_differing_in_band=ndiff)
            if theirs is not None:
                same = bool(np.array_equal(theirs[f"idx/{key}"], idx)
                            and np.array_equal(
                                theirs[f"val/{key}"].view(np.int32),
                                val.view(np.int32)))
                seg.update(parent_ms=parent_ms[key], bits_equal_parent=same)
                if not same:
                    say("kernels", kernel="argmin_l2", level=level, **seg)
                    fail(f"{name}: (idx, val) differ from {parent}'s kernel")
            for k in tot:
                tot[k] += steps * seg.get(k, 0.0)
            segs.append(seg)
            del qd, dbd, dbnd, dbt, got[key]
        for k in total:
            total[k] += tot[k]
        say("kernels", kernel="argmin_l2", level=level, npad=1024 ** 2 >> (
            2 * level), segments=segs, launches=sum(s["steps"] for s in segs),
            **{f"weighted_{k}": v for k, v in tot.items()
               if theirs is not None or k != "parent_ms"})
    say("kernels", kernel="argmin_l2", levels=list(ARGMIN_LEVELS),
        launches=sum(s[3] for s in shapes),
        **{f"weighted_{k}": v for k, v in total.items()
           if theirs is not None or k != "parent_ms"})
    torch.cuda.empty_cache()


def argmin2_cases(shapes, f=68, fp=128,
                  pad=lambda npad: max(64, npad >> 10), center=True):
    """Yield (level, npad, m, steps, q, dbp, dbn, n_real, lo, hi) for each
    (level, npad, m, steps[, F]), one DB per N at a time, built on the card
    as the two_pass level builds it: the bf16 centered DB of rows uniform
    in [0, 0.2) (F = the shape's own or ``f`` of Fp = 128 lanes), full
    fp32 norms of the unrounded rows, the last ``pad(npad)`` rows (by
    default npad / 1024, at least 64) padding with +inf norms, row ``hi`` a
    copy of row ``lo`` in another DB chunk (12,345 and 900,000 at N = 2^20,
    scaled with N); M queries near seeded DB rows, query 0 equal to the
    bf16 row lo.  Without ``center`` the rows are not centered, as the
    batched level builds its scan copy (``pad_bf16_uncentered``).  Torch
    only: the --parent child builds the same operands for the other tree's
    kernel."""
    import torch

    dev = torch.device("cuda", 0)
    db = None
    for level, npad, m, steps, *width in shapes:
        fs = width[0] if width else f
        if db is None or db[0] != (npad, fs):
            db = None
            torch.cuda.empty_cache()
            n_real = npad - pad(npad)
            lo, hi = 12345 * npad >> 20, 900000 * npad >> 20
            gen = torch.Generator(device=dev).manual_seed(31)
            x = torch.rand((n_real, fs), generator=gen, device=dev) * 0.2
            x[hi] = x[lo]  # duplicate rows: ties go to the lowest index
            xc = x - x.mean(dim=0)[None, :] if center else x
            del x
            dbp = torch.zeros((npad, fp), dtype=torch.bfloat16, device=dev)
            dbp[:n_real, :fs] = xc.to(torch.bfloat16)
            dbn = torch.full((npad,), float("inf"), device=dev)
            dbn[:n_real] = (xc * xc).sum(dim=1)
            db = ((npad, fs), xc, dbp, dbn, n_real, lo, hi)
        _, xc, dbp, dbn, n_real, lo, hi = db
        gen = torch.Generator(device=dev).manual_seed(m)
        q = torch.zeros((m, fp), device=dev)
        q[:, :fs] = xc[torch.randint(0, n_real, (m,), generator=gen,
                                     device=dev)] \
            + torch.randn((m, fs), generator=gen, device=dev) * 0.02
        q[0, :fs] = dbp[lo, :fs].float()
        yield level, npad, m, steps, q, dbp, dbn, n_real, lo, hi


def run_argmin2_shapes(match, shapes):
    """``match.argmin2_l2`` (q_split, 80 lanes) on the seeded operands of
    each (level, npad, m, steps): {"npad/m": (idx (2, M) = (i1; i2),
    val (2, M) = (v1; v2), device ms)}, timed from a cold L2."""
    import numpy as np
    import torch

    flush = flusher(torch.device("cuda", 0))
    out = {}
    for _, npad, m, _, q, dbp, dbn, *_ in argmin2_cases(shapes):
        i1, v1, i2, v2 = match.argmin2_l2(q, dbp, dbn, True, 80)
        ms = cuda_time_ms(lambda: match.argmin2_l2(q, dbp, dbn, True, 80),
                          reps=20, flush=flush)
        out[f"{npad}/{m}"] = (np.stack([i1.cpu().numpy(), i2.cpu().numpy()]),
                              np.stack([v1.cpu().numpy(), v2.cpu().numpy()]),
                              ms)
    return out


def phase_argmin2_levels(parent):
    """argmin2_l2 (two_pass's scan, q_split) at every wavefront segment
    shape of npr_1024's five levels (two_pass runs it at all of them), each
    on a DB of its level's N, and at the headline M = 352 of level 0: held
    against its plain version (scores within PACKED_ATOL, picks equal
    outside SCORE_BAND, the duplicate and padding rules), timed from a cold
    L2 beside the ``topk(dbn - 2 (mm hi + mm lo), 2)`` yardstick and the
    bound; device ms weighted by each segment's steps, per level and in
    all.  With ``parent``: that tree's argmin2_l2 on the same inputs (a
    child process), its ms and the counts of equal (i1, i2) picks and equal
    (v1, v2) val bits; fewer than 99.9% equal picks at a shape fails."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.ops import match

    f, k_used = SCAN_SHAPE["f"], 80
    levels = (0, 1, 2, 3, 4)
    shapes = merge_repeats(level_shapes(levels)) + [
        ("headline", SCAN_SHAPE["npad"], SCAN_SHAPE["m"], 0)]
    theirs = None
    if parent:
        theirs, parent_ms = parent_bits("argmin2", parent, shapes)
    flush = flusher(torch.device("cuda", 0))
    segs = []
    for level, npad, m, steps, q, dbp, dbn, n_real, lo, hi in argmin2_cases(
            shapes):
        name = f"argmin2_l2 level {level} M={m}"
        match.reset_launch_counts()
        got = match.argmin2_l2(q, dbp, dbn, True, k_used)
        torch.cuda.synchronize()
        if match.LAUNCHES["argmin2_l2"] != 1:
            fail(f"{name}: {match.LAUNCHES['argmin2_l2']} launches")
        i1, v1, i2, v2 = got
        qk = match._scan_queries(q, True)
        dbt = dbp.T

        def library_dots():
            return (torch.mm(qk[:m], dbt, out_dtype=torch.float32)
                    + torch.mm(qk[m:], dbt, out_dtype=torch.float32))

        top3 = torch.topk(dbn[None, :] - 2.0 * library_dots(), 3, dim=1,
                          largest=False).values
        r1, rv1, r2, rv2 = match.argmin2_l2_plain(q, dbp, dbn, True, k_used)
        e1, d1 = check_picks(f"{name} first", i1, v1, r1, rv1, top3[:, 1],
                             PACKED_ATOL)
        e2, d2 = check_picks(f"{name} second", i2, v2, r2, rv2, top3[:, 2],
                             PACKED_ATOL)
        del top3, r1, rv1, r2, rv2
        if (int(i1[0]), int(i2[0])) != (lo, hi) or \
                int(torch.maximum(i1, i2).max()) >= n_real:
            fail(f"{name}: duplicate/padding rule broken (i1[0]="
                 f"{int(i1[0])}, i2[0]={int(i2[0])})")
        k_ms = cuda_time_ms(lambda: match.argmin2_l2(q, dbp, dbn, True,
                                                     k_used),
                            reps=20, flush=flush)
        l_ms = cuda_time_ms(lambda: torch.topk(
            dbn[None, :] - 2.0 * library_dots(), 2, dim=1, largest=False),
            reps=10, flush=flush)
        seg = dict(m=m, steps=steps, ms=k_ms, library_ms=l_ms,
                   bound_ms=argmin2_bound(m, npad, f)[0],
                   max_abs_err=max(e1, e2), picks_differing_in_band=d1 + d2)
        if theirs is not None:
            key = f"{npad}/{m}"
            ti, tv = theirs[f"idx/{key}"], theirs[f"val/{key}"]
            mine_i = np.stack([i1.cpu().numpy(), i2.cpu().numpy()])
            mine_v = np.stack([v1.cpu().numpy(), v2.cpu().numpy()])
            picks = int((ti == mine_i).all(axis=0).sum())
            seg.update(parent_ms=parent_ms[key], picks_equal_parent=picks,
                       val_bits_equal_parent=int(
                           (tv.view(np.int32) == mine_v.view(np.int32)).all(
                               axis=0).sum()))
            if picks < 0.999 * m:
                say("kernels", kernel="argmin2_l2", level=level, **seg)
                fail(f"{name}: {picks} of {m} (i1, i2) picks equal to "
                     f"{parent}'s kernel, fewer than 99.9%")
        segs.append((level, seg))
        del q, qk, dbt, got, i1, v1, i2, v2
    torch.cuda.empty_cache()
    total = dict.fromkeys(("ms", "library_ms", "bound_ms", "parent_ms"), 0.0)
    for level in levels:
        lsegs = [sg for lv, sg in segs if lv == level]
        tot = {k: sum(sg["steps"] * sg.get(k, 0.0) for sg in lsegs)
               for k in total}
        for k in total:
            total[k] += tot[k]
        say("kernels", kernel="argmin2_l2", level=level,
            npad=1024 ** 2 >> (2 * level), segments=lsegs,
            launches=sum(sg["steps"] for sg in lsegs),
            **{f"weighted_{k}": v for k, v in tot.items()
               if theirs is not None or k != "parent_ms"})
    say("kernels", kernel="argmin2_l2", levels=list(levels),
        launches=sum(sh[3] for sh in shapes),
        **{f"weighted_{k}": v for k, v in total.items()
           if theirs is not None or k != "parent_ms"})
    say("kernels", kernel="argmin2_l2", npad=SCAN_SHAPE["npad"], f=f,
        k_used=k_used, **segs[-1][1])


def argmin2_bound(m, npad, f):
    """Bound of one argmin2 call (q_split) at the function's own width F:
    the F used DB lanes, the norms and the hi and lo query rows read once,
    (i1, v1, i2, v2) written once; hi and lo passes of 2 M N F bf16
    operations."""
    return bound(2 * npad * f + 4 * npad + 2 * 2 * m * f + 16 * m,
                 2 * 2 * m * npad * f, PEAK_BF16_FLOP_S)


def pertile_pad(npad):
    """Padding rows of the pertile level cases: the last scan tile
    (``scan_tile_rows``) all padding, and 64 rows of the one before."""
    from image_analogies_tpu_torch.backends.cuda import scan_tile_rows

    return scan_tile_rows(npad) + 64


def run_pertile_shapes(match, shapes):
    """``match.pertile_champions`` (q_split, 80 lanes, the level's scan
    tile) on the seeded operands of each (level, npad, m, steps)
    (``argmin2_cases`` with ``pertile_pad``, half norms): {"npad/m": (idx
    (ntiles, M), vals (ntiles, M), device ms)}, timed from a cold L2."""
    import torch

    from image_analogies_tpu_torch.backends.cuda import scan_tile_rows

    flush = flusher(torch.device("cuda", 0))
    out = {}
    for _, npad, m, _, q, dbp, dbn, *_ in argmin2_cases(shapes,
                                                       pad=pertile_pad):
        tile, dbnh = scan_tile_rows(npad), 0.5 * dbn
        vals, idx = match.pertile_champions(q, dbp, dbnh, tile, True, 80)
        ms = cuda_time_ms(lambda: match.pertile_champions(
            q, dbp, dbnh, tile, True, 80), reps=20, flush=flush)
        out[f"{npad}/{m}"] = (idx.cpu().numpy(), vals.cpu().numpy(), ms)
    return out


def pertile_bound(m, npad, f, ntiles):
    """Bound of one pertile call (q_split) at the function's own width F:
    the F used DB lanes, the half norms and the hi and lo query rows read
    once, (val, idx) written once per (scan tile, query); hi and lo passes
    of 2 M N F bf16 operations."""
    return bound(2 * npad * f + 4 * npad + 2 * 2 * m * f + 8 * m * ntiles,
                 2 * 2 * m * npad * f, PEAK_BF16_FLOP_S)


def phase_pertile_levels(parent):
    """pertile_champions (scan_rescue's scan, q_split, 80 lanes) at every
    wavefront segment shape of npr_1024's five levels (scan_rescue runs it
    at all of them), each on a DB of its level's N cut into the level's scan
    tiles (``scan_tile_rows``), and at the headline M = 352 of level 0:
    held against its plain version (``check_tiles``: finite champions
    within PACKED_ATOL, picks equal outside SCORE_BAND, all-padding tiles
    exact), the duplicate rule (query 0's row and its twin each win their
    tile) and the all-padding tile rule (the last tile: -inf at its first
    row); timed from a cold L2 beside the ``mm`` hi + ``mm`` lo - dbnh,
    per-tile ``max`` yardstick and the bound, device ms weighted by each
    segment's steps, per level and in all.  Where the card holds more than
    one split of the scan tiles in parts, the kernel launch alone is timed
    at each power of two (the same bits required).  With ``parent``: that tree's pertile_champions on the
    same inputs (a child process), its ms and the counts of equal picks
    and equal val bits over every (scan tile, query); fewer than 99.9%
    equal picks at a shape fails."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.backends.cuda import scan_tile_rows
    from image_analogies_tpu_torch.ops import match

    f, k_used = SCAN_SHAPE["f"], 80
    levels = (0, 1, 2, 3, 4)
    shapes = merge_repeats(level_shapes(levels)) + [
        ("headline", SCAN_SHAPE["npad"], SCAN_SHAPE["m"], 0)]
    theirs = None
    if parent:
        theirs, parent_ms = parent_bits("pertile", parent, shapes)
    dev = torch.device("cuda", 0)
    flush = flusher(dev)
    segs = []
    for level, npad, m, steps, q, dbp, dbn, n_real, lo, hi in argmin2_cases(
            shapes, pad=pertile_pad):
        name = f"pertile_champions level {level} M={m}"
        tile = scan_tile_rows(npad)
        ntiles = npad // tile
        dbnh = 0.5 * dbn
        match.reset_launch_counts()
        vals, idx = match.pertile_champions(q, dbp, dbnh, tile, True, k_used)
        torch.cuda.synchronize()
        if match.LAUNCHES["pertile_champions"] != 1:
            fail(f"{name}: {match.LAUNCHES['pertile_champions']} launches")
        qk = match._scan_queries(q, True)
        dbt = dbp.T

        def library_s2():
            return (torch.mm(qk[:m], dbt, out_dtype=torch.float32)
                    + torch.mm(qk[m:], dbt, out_dtype=torch.float32)) - dbnh

        s2 = library_s2()
        second = torch.topk(s2.view(m, ntiles, tile), 2,
                            dim=2).values[..., 1].T
        del s2
        rv, ri = match.pertile_champions_plain(q, dbp, dbnh, tile, True,
                                               k_used)
        err, ndiff = check_tiles(name, vals, idx, rv, ri, second,
                                 PACKED_ATOL)
        del rv, ri, second
        if (int(idx[lo // tile, 0]), int(idx[hi // tile, 0])) != (lo, hi) \
                or not bool(torch.isneginf(vals[-1]).all()) \
                or not bool((idx[-1] == npad - tile).all()) \
                or int(idx[:-1].max()) >= n_real:
            fail(f"{name}: duplicate/all-padding tile rule broken")
        k_ms = cuda_time_ms(lambda: match.pertile_champions(
            q, dbp, dbnh, tile, True, k_used), reps=20, flush=flush)
        l_ms = cuda_time_ms(lambda: library_s2().view(m, ntiles, tile).max(
            dim=2), reps=10, flush=flush)
        plan = match._pertile_plan(m, npad, match._sm_count(0), k_used, True,
                                   tile)
        seg = dict(m=m, steps=steps, tile=tile, parts=plan.parts, ms=k_ms,
                   library_ms=l_ms,
                   bound_ms=pertile_bound(m, npad, f, ntiles)[0],
                   max_abs_err=err, picks_differing_in_band=ndiff)
        # the C entry alone (no wrapper) at every power-of-two split of the
        # scan tiles that the card holds, the plan's among them: the same
        # bits required
        room = max(1, match._sm_count(0) // plan.q_tiles)
        sub = tile // plan.rows
        splits = [p for p in (1, 2, 4, 8, 16, 32)
                  if sub % p == 0 and (p == 1 or ntiles * p <= room)]
        if len(splits) > 1:
            seg["launch_ms_by_parts"] = {}
            for p in splits:
                alt = match._pertile_plan(m, npad, match._sm_count(0),
                                          k_used, True, tile, parts=p)
                av, ai = match._pertile_launch(q, dbp, dbnh, tile, k_used,
                                               True, alt)
                if not (torch.equal(ai, idx) and torch.equal(
                        av.view(torch.int32), vals.view(torch.int32))):
                    fail(f"{name}: {p} parts give other bits than "
                         f"{plan.parts}")
                seg["launch_ms_by_parts"][p] = cuda_time_ms(
                    lambda: match._pertile_launch(q, dbp, dbnh, tile, k_used,
                                                  True, alt),
                    reps=20, flush=flush)
        if theirs is not None:
            key = f"{npad}/{m}"
            ti, tv = theirs[f"idx/{key}"], theirs[f"val/{key}"]
            picks = int((ti == idx.cpu().numpy()).sum())
            seg.update(parent_ms=parent_ms[key], picks_equal_parent=picks,
                       val_bits_equal_parent=int(
                           (tv.view(np.int32) == vals.cpu().numpy().view(
                               np.int32)).sum()),
                       champions=ntiles * m)
            if picks < 0.999 * ntiles * m:
                say("kernels", kernel="pertile_champions", level=level,
                    **seg)
                fail(f"{name}: {picks} of {ntiles * m} picks equal to "
                     f"{parent}'s kernel, fewer than 99.9%")
        segs.append((level, seg))
        del q, qk, dbt, dbnh, vals, idx
    torch.cuda.empty_cache()
    total = dict.fromkeys(("ms", "library_ms", "bound_ms", "parent_ms"), 0.0)
    for level in levels:
        lsegs = [sg for lv, sg in segs if lv == level]
        tot = {k: sum(sg["steps"] * sg.get(k, 0.0) for sg in lsegs)
               for k in total}
        for k in total:
            total[k] += tot[k]
        say("kernels", kernel="pertile_champions", level=level,
            npad=1024 ** 2 >> (2 * level), segments=lsegs,
            launches=sum(sg["steps"] for sg in lsegs),
            **{f"weighted_{k}": v for k, v in tot.items()
               if theirs is not None or k != "parent_ms"})
    say("kernels", kernel="pertile_champions", levels=list(levels),
        launches=sum(sh[3] for sh in shapes),
        **{f"weighted_{k}": v for k, v in total.items()
           if theirs is not None or k != "parent_ms"})
    say("kernels", kernel="pertile_champions", npad=SCAN_SHAPE["npad"], f=f,
        k_used=k_used, **segs[-1][1])


def packed3_key(npad, m, lw=55):
    """The --parent key of a packed3 shape: "npad/m", with "/lw" past the
    luminance width."""
    return f"{npad}/{m}" + (f"/{lw}" if lw != 55 else "")


def packed3_cases(match, shapes, lw=55):
    """Yield (level, npad, m, steps, L, qa, qb, w1, w2, dbnh, k_used,
    n_real, lo) for each (level, npad, m, steps[, lane width L, default
    ``lw``]), one DB per (N, L) at a time, built on the card as the
    exact_hi2 level build makes it (``pack_w12``: W1 = [d1|d2], W2 =
    [d3|d1], 2L = 110 of Kp = 128 lanes at L = 55, half norms): live-dim
    rows uniform in [0, 0.2), the last npad / 1024 rows (at least 64)
    padding with +inf half norms, row ``hi`` a copy of row ``lo`` (its
    half norm too) in another DB chunk (12,345 and 900,000 at N = 2^20,
    scaled with N); M
    queries near seeded DB rows, centered by the DB's shift and split in
    three bf16 parts (``_packed3_rows``), query 0 equal to row lo.  Torch
    and the imported tree's match module only: the --parent child builds
    the same operands for the other tree's kernel."""
    import torch

    from image_analogies_tpu_torch.backends.cuda import (
        pack_w12, packed_shift_and_halfnorm)

    dev = torch.device("cuda", 0)
    db = None
    for level, npad, m, steps, *width in shapes:
        lw_s = width[0] if width else lw
        k_used = (2 * lw_s + 15) // 16 * 16
        if db is None or db[0] != (npad, lw_s):
            db = None
            torch.cuda.empty_cache()
            n_real = npad - max(64, npad >> 10)
            lo, hi = 12345 * npad >> 20, 900000 * npad >> 20
            gen = torch.Generator(device=dev).manual_seed(37)
            x = torch.rand((n_real, lw_s), generator=gen, device=dev) * 0.2
            x[hi] = x[lo]  # duplicate rows: ties go to the lowest index
            live = torch.arange(lw_s, device=dev)
            shift, half_norm = packed_shift_and_halfnorm(x, live)
            w1, w2, dbnh = pack_w12(x, shift, half_norm, live, npad)
            # the card's row sums may round a copied row's half norm apart
            # from its source's (seen at L = 207): make the copy exact
            dbnh[hi] = dbnh[lo]
            db = ((npad, lw_s), x, shift, w1, w2, dbnh, n_real, lo)
        _, x, shift, w1, w2, dbnh, n_real, lo = db
        gen = torch.Generator(device=dev).manual_seed(m)
        qv = x[torch.randint(0, n_real, (m,), generator=gen, device=dev)] \
            + torch.randn((m, lw_s), generator=gen, device=dev) * 0.02
        qv[0] = x[lo]
        q1, q2, q3 = (t.to(torch.bfloat16)
                      for t in match.bf16_split3(qv - shift))
        qa, qb = match._packed3_rows(q1, q2, q3, w1.shape[1])
        yield (level, npad, m, steps, lw_s, qa, qb, w1, w2, dbnh, k_used,
               n_real, lo)


def run_packed3_shapes(match, shapes):
    """``match.packed_best``'s packed3 form on the seeded operands of each
    (level, npad, m, steps[, L]): {``packed3_key``: (idx, val, device
    ms)}, timed from a cold L2."""
    import torch

    flush = flusher(torch.device("cuda", 0))
    out = {}
    for _, npad, m, _, lw, qa, qb, w1, w2, dbnh, k_used, *_ in \
            packed3_cases(match, shapes):
        kw = dict(qb=qb, w2=w2, dbnh=dbnh, fold_a=True)
        idx, val = match.packed_best(qa, w1, k_used, **kw)
        ms = cuda_time_ms(lambda: match.packed_best(qa, w1, k_used, **kw),
                          reps=20, flush=flush)
        out[packed3_key(npad, m, lw)] = (idx.cpu().numpy(),
                                         val.cpu().numpy(), ms)
    return out


def packed3_bound(m, npad, width, tiles=1):
    """Bound of one packed3 call at the function's own width 2L (the
    kernel rounds its lanes up to a multiple of 16): both weight arrays'
    2L lanes, the half norms and the three query sets read once, (idx,
    val) written once per query (and DB tile: ``tiles``, the per-tile
    witness); three passes of 2 M N 2L bf16 operations."""
    return bound(2 * 2 * npad * width + 4 * npad + 2 * 3 * m * width
                 + 8 * m * tiles, 2 * 3 * m * npad * width,
                 PEAK_BF16_FLOP_S)


def packed2_bound(m, npad, width, tiles=1):
    """Bound of one two-stream, two-set packed call (packed2's passes) at
    the function's own width 2L: both weight arrays' 2L lanes, the half
    norms and the two query sets read once, (idx, val) written once per
    query (and DB tile: ``tiles``); two passes of 2 M N 2L bf16
    operations."""
    return bound(2 * 2 * npad * width + 4 * npad + 2 * 2 * m * width
                 + 8 * m * tiles, 2 * 2 * m * npad * width,
                 PEAK_BF16_FLOP_S)


def packed3_library(qa, qb, w1, w2, dbnh, m):
    """The yardstick of packed3: three bf16 ``mm``s into fp32, minus the
    half norms, then ``max``."""
    import torch

    w1t, w2t = w1.T, w2.T

    def call():
        d = torch.mm(qa[:m], w1t, out_dtype=torch.float32)
        d += torch.mm(qa[m:], w1t, out_dtype=torch.float32)
        d += torch.mm(qb, w2t, out_dtype=torch.float32)
        return (d - dbnh).max(dim=1)

    return call


def check_packed3(name, match, qa, qb, w1, w2, dbnh, k_used, n_real, lo):
    """packed3 (the packed_best wrapper, one launch) against its plain
    version on the card: scores within PACKED_ATOL, picks equal outside
    SCORE_BAND, the duplicate and padding rules.  Returns (idx, val,
    max |score - plain|, picks differing in the band)."""
    import torch

    m = qb.shape[0]
    kw = dict(qb=qb, w2=w2, dbnh=dbnh, fold_a=True)
    match.reset_launch_counts()
    idx, val = match.packed_best(qa, w1, k_used, **kw)
    torch.cuda.synchronize()
    route = match._packed3_route(k_used)
    if match.LAUNCHES[route] != 1 or sum(match.LAUNCHES.values()) != 1:
        fail(f"{name}: launches {match.LAUNCHES}, expected one {route}")
    scores = match._packed_scores_plain(qa, w1, k_used, qb, w2, dbnh, True)
    ref_idx, ref_val = match._first_max(scores)
    second = torch.topk(scores, 2, dim=1).values[:, 1]
    del scores
    err, ndiff = check_picks(name, idx, val, ref_idx, ref_val, second,
                             PACKED_ATOL)
    if int(idx[0]) != lo or int(idx.max()) >= n_real or m != idx.shape[0]:
        fail(f"{name}: duplicate/padding rule broken (idx[0]="
             f"{int(idx[0])}, max {int(idx.max())})")
    return idx, val, err, ndiff


def phase_packed3_levels(rows, parent):
    """packed3_best (exact_hi2's scan: [q1|q1].W1 + [q2|q2].W1 +
    [q1|q3].W2 - dbnh, 2L = 110 of 128 lanes) at every wavefront segment
    shape of npr_1024's five levels (exact_hi2 runs it at all of them), each
    on a DB of its level's N, and at the headline M = 352 of level 0: held
    against its plain version (``check_packed3``), timed from a cold L2
    beside the ``3 mm + max`` yardstick and the bound; device ms weighted by
    each segment's steps, per level and in all.  Then the RGB width (2L =
    256 of 256 lanes) once at M = 352, N = 2^20, and the width rule's
    packed3w_best.cu past 256 lanes (2L = 300) at M = 64, N = 65,536 and (2L
    = 288, 296, 384 and 414) at M = 352, N = 2^20, each held against plain
    and timed beside it, with its launch plan; the 2L = 414 shape is
    packed3w_best's row in ``rows``.  With ``parent``: that tree's packed3 on
    the same inputs at every one of these shapes (a child process), its ms
    and the counts of equal picks and equal val bits; fewer than 99.9%
    equal picks at a shape fails."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.ops import match

    lw = SCAN_SHAPE["lw"]
    width = 2 * lw
    levels = (0, 1, 2, 3, 4)
    shapes = merge_repeats(level_shapes(levels)) + [
        ("headline", SCAN_SHAPE["npad"], SCAN_SHAPE["m"], 0)]
    wide = [(label, sh["npad"], sh["m"], 0, sh["lw"])
            for label, sh in (("rgb", P3_RGB_SHAPE), ("wide", P3_WIDE_SHAPE),
                              *(("past256", sh) for sh in P3_PAST256_SHAPES))]
    theirs = None
    if parent:
        theirs, parent_ms = parent_bits("packed3", parent, shapes + wide)
    flush = flusher(torch.device("cuda", 0))
    segs = []
    for (level, npad, m, steps, lw_s, qa, qb, w1, w2, dbnh, k_used, n_real,
         lo) in packed3_cases(match, shapes + wide, lw):
        route = match._packed3_route(k_used)
        name = f"packed3_best {route} level {level} M={m} k_used={k_used}"
        idx, val, err, ndiff = check_packed3(name, match, qa, qb, w1, w2,
                                             dbnh, k_used, n_real, lo)
        kw = dict(qb=qb, w2=w2, dbnh=dbnh, fold_a=True)
        k_ms = cuda_time_ms(lambda: match.packed_best(qa, w1, k_used, **kw),
                            reps=20, flush=flush)
        l_ms = cuda_time_ms(packed3_library(qa, qb, w1, w2, dbnh, m),
                            reps=10, flush=flush)
        b = packed3_bound(m, npad, 2 * lw_s)
        seg = dict(m=m, steps=steps, ms=k_ms, library_ms=l_ms,
                   bound_ms=b[0], max_abs_err=err,
                   picks_differing_in_band=ndiff)
        if theirs is not None:
            key = packed3_key(npad, m, lw_s)
            ti, tv = theirs[f"idx/{key}"], theirs[f"val/{key}"]
            picks = int((ti == idx.cpu().numpy()).sum())
            seg.update(parent_ms=parent_ms[key], picks_equal_parent=picks,
                       val_bits_equal_parent=int(
                           (tv.view(np.int32) == val.cpu().numpy().view(
                               np.int32)).sum()))
            if picks < 0.999 * m:
                say("kernels", kernel="packed3_best", level=level, **seg)
                fail(f"{name}: {picks} of {m} picks equal to {parent}'s "
                     "kernel, fewer than 99.9%")
        if lw_s != lw:
            seg["plain_ms"] = cuda_time_ms(lambda: match.packed_best_plain(
                qa, w1, k_used, **kw), reps=3, flush=flush)
            if route == "packed3w_best":
                seg["plan"] = match._packed3w_plan(
                    m, npad, match._sm_count(0), k_used)._asdict()
                if lw_s == P3W_ROW_LW:
                    rows[route] = kernel_row(
                        route, "packed3w_best.cu", 523, err, k_ms,
                        seg["plain_ms"], l_ms, b)
            say("kernels", kernel="packed3_best", route=route, npad=npad,
                width=2 * lw_s, kp=w1.shape[1], k_used=k_used,
                bound_by=b[1], **seg)
        else:
            segs.append((level, seg))
        del qa, qb, w1, w2, dbnh, idx, val
    torch.cuda.empty_cache()
    total = dict.fromkeys(("ms", "library_ms", "bound_ms", "parent_ms"), 0.0)
    for level in levels:
        lsegs = [sg for lv, sg in segs if lv == level]
        tot = {k: sum(sg["steps"] * sg.get(k, 0.0) for sg in lsegs)
               for k in total}
        for k in total:
            total[k] += tot[k]
        say("kernels", kernel="packed3_best", level=level,
            npad=1024 ** 2 >> (2 * level), width=width, segments=lsegs,
            launches=sum(sg["steps"] for sg in lsegs),
            **{f"weighted_{k}": v for k, v in tot.items()
               if theirs is not None or k != "parent_ms"})
    say("kernels", kernel="packed3_best", levels=list(levels),
        launches=sum(sh[3] for sh in shapes),
        **{f"weighted_{k}": v for k, v in total.items()
           if theirs is not None or k != "parent_ms"})
    say("kernels", kernel="packed3_best", npad=SCAN_SHAPE["npad"],
        width=width, k_used=(width + 15) // 16 * 16, **segs[-1][1])


def parent_bits(kind, parent, shapes):
    """The ``kind`` kernel ("argmin": argmin_l2, "packed": packed_best,
    "packed_widths": packed_best at other lane widths,
    "argmin2": argmin2_l2, "packed3": packed_best's packed3 form,
    "pertile": pertile_champions, "argmin_bf16": argmin_l2_bf16, "forms":
    the four superseded packed forms, "champions": packed_champions) of the
    checkout in ``parent`` on the same seeded operands, in a child process
    built from that tree's sources: ({"idx/<key>": ..., "val/<key>": ...},
    {"<key>": device ms}), the keys those of the kind's ``run_*_shapes``
    ("<npad>/<m>" for most)."""
    import numpy as np

    out = os.path.join(HERE, "image_analogies_tpu_torch", "_build",
                       f"{kind}_parent_bits.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--bits-of", kind,
         os.path.abspath(parent), out, "--shapes", json.dumps(shapes)],
        capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        fail(f"{kind} kernel of {parent}: exit {child.returncode}\n"
             f"{child.stdout[-2000:]}{child.stderr[-4000:]}")
    return dict(np.load(out)), json.loads(
        child.stdout.strip().splitlines()[-1])


def bits_child(kind, root, out, shapes):
    """Child of ``parent_bits``: the kernel of the checkout at ``root``
    (built from its own sources) on the seeded operands of each shape;
    saves (idx, val) per shape to ``out`` and prints its device ms per
    shape as the last line."""
    import numpy as np

    sys.path.insert(0, root)
    from image_analogies_tpu_torch.ops import match

    if not os.path.abspath(match.__file__).startswith(root + os.sep):
        fail(f"imported {match.__file__}, not the package under {root}")
    run = {"argmin": run_argmin_shapes, "packed": run_packed_shapes,
           "packed_widths": run_packed_width_shapes,
           "argmin2": run_argmin2_shapes,
           "packed3": run_packed3_shapes,
           "pertile": run_pertile_shapes,
           "argmin_bf16": run_argmin_bf16_shapes,
           "forms": run_forms_shapes,
           "champions": run_champions_shapes}[kind]
    got = run(match, [tuple(s) for s in shapes])
    arrays = {}
    for key, (idx, val, *_) in got.items():
        arrays[f"idx/{key}"], arrays[f"val/{key}"] = idx, val
    np.savez(out, **arrays)
    print(json.dumps({k: v[2] for k, v in got.items()}), flush=True)


def phase_kernels(parent=None):
    rows = {}
    phase_argmin_kernel(rows)
    phase_argmin_levels(parent)
    phase_argmin2_levels(parent)
    phase_pertile_levels(parent)
    phase_packed3_levels(rows, parent)
    phase_packed_kernel(rows, parent)
    phase_packed2k_widths(rows, parent)
    phase_packed3_kernels(rows, parent)
    phase_bf16_db_kernels(rows)
    phase_argmin_bf16_levels(rows, parent)
    phase_packed_forms(rows, parent)
    return rows


def packed_db(match, npad, lw=55, seed=13):
    """Seeded packed2k DB on the card, built as the main path builds it
    (``pack_wk``): live-dim rows uniform in [0, 0.2), the last 1,000 rows
    padding (norm lanes -3e38), row ``hi`` a copy of row ``lo`` in another
    DB chunk (12,345 and 900,000 at N = 2^20, scaled with N).  Returns
    (wk, shift, the row lo, n_real, lo)."""
    import torch

    from image_analogies_tpu_torch.backends.cuda import (
        pack_wk, packed_shift_and_halfnorm)

    dev = torch.device("cuda", 0)
    n_real = npad - 1000
    lo, hi = 12345 * npad >> 20, 900000 * npad >> 20
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n_real, lw), generator=gen, device=dev) * 0.2
    x[hi] = x[lo]  # duplicate rows: ties go to the lowest index
    live = torch.arange(lw, device=dev)
    shift, half_norm = packed_shift_and_halfnorm(x, live)
    # the row sums of two equal rows of odd length may round apart on the
    # card (their alignments differ): the twin gets the same half norm
    half_norm[hi] = half_norm[lo]
    wk, _ = pack_wk(x, shift, half_norm, live, npad)
    return wk, shift, x[lo].clone(), n_real, lo


def packed_queries(match, m, shift, x_lo, kp, lw=55):
    """Seeded packed query rows [q1|q1|1 1 1|q2|q1|0] of M uniform queries
    (centered by the DB's shift), query 0 equal to the duplicated row."""
    import torch

    dev = shift.device
    gen = torch.Generator(device=dev).manual_seed(m)
    qv = torch.rand((m, lw), generator=gen, device=dev) * 0.2 - shift
    qv[0] = x_lo - shift
    g1, g2, _ = match.bf16_split3(qv)
    q1, q2 = g1.to(torch.bfloat16), g2.to(torch.bfloat16)
    o2 = 2 * lw + 3
    return torch.cat([q1, q1, torch.ones((m, 3), dtype=torch.bfloat16,
                                         device=dev), q2, q1,
                      torch.zeros((m, kp - o2 - 2 * lw), dtype=torch.bfloat16,
                                  device=dev)], dim=1).contiguous()


def packed_cases(match, shapes, lw=55):
    """Yield (level, npad, m, steps, qa, wk, k_used, n_real, lo) for each
    shape, one DB per N at a time (``packed_db``)."""
    k_used = (4 * lw + 3 + 15) // 16 * 16
    db = None
    for level, npad, m, steps in shapes:
        if db is None or db[0] != npad:
            db = (npad, *packed_db(match, npad, lw))
        _, wk, shift, x_lo, n_real, lo = db
        qa = packed_queries(match, m, shift, x_lo, wk.shape[1], lw)
        yield level, npad, m, steps, qa, wk, k_used, n_real, lo


def run_packed_width_shapes(match, shapes):
    """``match.packed_best`` on the seeded operands of each (lw, npad, m):
    {"<lw>": (idx, val, device ms)}, timed from a cold L2 (the ``--parent``
    child of the packed2k widths)."""
    import torch

    flush = flusher(torch.device("cuda", 0))
    out = {}
    for lw, npad, m in shapes:
        for *_, qa, wk, k_used, _, _ in packed_cases(match, [(0, npad, m, 0)],
                                                     lw):
            idx, val = match.packed_best(qa, wk, k_used)
            ms = cuda_time_ms(lambda: match.packed_best(qa, wk, k_used),
                              reps=20, flush=flush)
            out[str(lw)] = (idx.cpu().numpy(), val.cpu().numpy(), ms)
        torch.cuda.empty_cache()
    return out


def run_packed_shapes(match, shapes):
    """``match.packed_best`` on the seeded operands of each (level, npad,
    m, steps): {"npad/m": (idx, val, device ms)}, timed from a cold L2."""
    import torch

    flush = flusher(torch.device("cuda", 0))
    out = {}
    for _, npad, m, _, qa, wk, k_used, _, _ in packed_cases(match, shapes):
        idx, val = match.packed_best(qa, wk, k_used)
        ms = cuda_time_ms(lambda: match.packed_best(qa, wk, k_used), reps=20,
                          flush=flush)
        out[f"{npad}/{m}"] = (idx.cpu().numpy(), val.cpu().numpy(), ms)
    return out


def packed_bound(m, npad, width):
    """Bound of one packed2k call at the function's own width (4L + 3
    lanes): qa and wk read once, (idx, val) written once; 2 M N width
    bf16 operations."""
    return bound(2 * (m * width + npad * width) + 8 * m,
                 2 * m * npad * width, PEAK_BF16_FLOP_S)


def phase_packed_kernel(rows, parent):
    """packed_best (the packed2k scan, levels 0-1 of the main path) at every
    wavefront segment shape of npr_1024's levels 0 and 1 and at the
    headline shape (M = 352, the JAX wrapper's padding of the widest level-0
    batch; the port launches M = 344): held against its plain version
    (scores within PACKED_ATOL, picks equal outside SCORE_BAND, the
    duplicate and padding rules), timed from a cold L2 beside the
    ``torch.mm(out_dtype=float32) + max`` yardstick and the bound, device
    ms weighted by each segment's steps per level and in all.  With
    ``parent``: that tree's packed_best on the same inputs (a child
    process), its ms and the counts of equal picks and equal val bits
    (wgmma sums in the hardware's order, so bits may differ)."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.ops import match

    s = PACKED_SHAPE
    lw = s["lw"]
    width = 4 * lw + 3  # the function's lanes: 223
    head = ("headline", s["npad"], s["m"], 0)
    # every M but a level's widest comes twice (the ramp up and down): one
    # measurement each, weighted by the steps of both
    shapes = merge_repeats(level_shapes(PACKED_LEVELS)) + [head]
    theirs = None
    if parent:
        theirs, parent_ms = parent_bits("packed", parent, shapes)
    flush = flusher(torch.device("cuda", 0))
    segs = []
    for level, npad, m, steps, qa, wk, k_used, n_real, lo in packed_cases(
            match, shapes, lw):
        name = f"packed_best level {level} M={m}"
        match.reset_launch_counts()
        idx, val = match.packed_best(qa, wk, k_used)
        torch.cuda.synchronize()
        if match.LAUNCHES["packed_best"] != 1:
            fail(f"{name}: {match.LAUNCHES['packed_best']} launches")
        scores = match._packed_scores_plain(qa, wk, k_used, None, None, None,
                                            False)
        ref_idx, ref_val = match._first_max(scores)
        second = torch.topk(scores, 2, dim=1).values[:, 1]
        del scores
        err, ndiff = check_picks(name, idx, val, ref_idx, ref_val, second,
                                 PACKED_ATOL)
        if int(idx[0]) != lo or int(idx.max()) >= n_real:
            fail(f"{name}: duplicate/padding rule broken (idx[0]="
                 f"{int(idx[0])}, max {int(idx.max())})")
        k_ms = cuda_time_ms(lambda: match.packed_best(qa, wk, k_used),
                            reps=20, flush=flush)
        wkt = wk.T
        l_ms = cuda_time_ms(
            lambda: torch.mm(qa, wkt, out_dtype=torch.float32).max(dim=1),
            reps=10, flush=flush)
        seg = dict(m=m, steps=steps, ms=k_ms, library_ms=l_ms,
                   bound_ms=packed_bound(m, npad, width)[0],
                   max_abs_err=err, picks_differing_in_band=ndiff)
        if theirs is not None:
            key = f"{npad}/{m}"
            ti, tv = theirs[f"idx/{key}"], theirs[f"val/{key}"]
            seg.update(parent_ms=parent_ms[key],
                       picks_equal_parent=int((ti == idx.cpu().numpy()).sum()),
                       val_bits_equal_parent=int(
                           (tv.view(np.int32) == val.cpu().numpy().view(
                               np.int32)).sum()))
        if level == "headline":
            p_ms = cuda_time_ms(lambda: match.packed_best_plain(
                qa, wk, k_used), reps=3, flush=flush)
            b = packed_bound(m, npad, width)
            rows["packed_best"] = kernel_row(
                "packed_best", "packed2k_best.cu", 523, err, k_ms, p_ms,
                l_ms, b)
            seg.update(plain_ms=p_ms)
        segs.append((level, seg))
        del qa, wkt
    torch.cuda.empty_cache()
    total = dict.fromkeys(("ms", "library_ms", "bound_ms", "parent_ms"), 0.0)
    for level in PACKED_LEVELS:
        lsegs = [sg for lv, sg in segs if lv == level]
        tot = {k: sum(sg["steps"] * sg.get(k, 0.0) for sg in lsegs)
               for k in total}
        for k in total:
            total[k] += tot[k]
        say("kernels", kernel="packed_best", level=level,
            npad=1024 ** 2 >> (2 * level), width=width, segments=lsegs,
            launches=sum(sg["steps"] for sg in lsegs),
            **{f"weighted_{k}": v for k, v in tot.items()
               if theirs is not None or k != "parent_ms"})
    say("kernels", kernel="packed_best", levels=list(PACKED_LEVELS),
        launches=sum(sh[3] for sh in shapes),
        **{f"weighted_{k}": v for k, v in total.items()
           if theirs is not None or k != "parent_ms"})
    m344 = [sg["ms"] for lv, sg in segs if lv == 0 and sg["m"] == 344]
    say("kernels", kernel="packed_best", npad=s["npad"], width=width,
        k_used=(width + 15) // 16 * 16, **segs[-1][1],
        m344_ms=m344[0] if m344 else None,
        bound_by=rows["packed_best"]["bound_by"])


def phase_packed2k_widths(rows, parent):
    """packed_best (the packed2k form) at each of P2K_WIDTHS at M = 352, N
    = 2^20: the width rule's kernel (packed2k_best.cu up to 512 lanes,
    packed2kw_best.cu past them, its launch plan printed) held against its
    plain version (scores within PACKED_ATOL and picks equal outside
    SCORE_BAND up to 512 lanes; past them within P3W_ATOL, picks outside
    that band: the tensor cores' fp32 sum over 38-65 k steps), the
    duplicate and padding rules, timed from a cold L2 beside the
    ``torch.mm(out_dtype=float32) + max`` yardstick, the plain version and
    the bound.  The 832-lane shape is packed2kw_best's row in the table.
    With ``parent``: that tree's packed_best at the widths it takes (up to
    512 lanes), its ms and the counts of equal picks and val bits."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.ops import match

    npad, m = PACKED_SHAPE["npad"], PACKED_SHAPE["m"]
    theirs = None
    if parent:
        mine = [[lw, npad, m] for lw in P2K_WIDTHS
                if 4 * lw + 3 <= match._P2K_MAX_LANES]
        theirs, parent_ms = parent_bits("packed_widths", parent, mine)
    flush = flusher(torch.device("cuda", 0))
    for lw in P2K_WIDTHS:
        width = 4 * lw + 3
        for *_, qa, wk, k_used, n_real, lo in packed_cases(
                match, [(0, npad, m, 0)], lw):
            route = match._packed2k_route(k_used)
            wide = route == "packed2kw_best"
            plan = (match._packed2kw_plan if wide else match._packed2k_plan)(
                m, npad, match._sm_count(0), k_used)
            name = f"{route} {k_used} lanes"
            match.reset_launch_counts()
            idx, val = match.packed_best(qa, wk, k_used)
            torch.cuda.synchronize()
            if match.LAUNCHES[route] != 1 or sum(match.LAUNCHES.values()) != 1:
                fail(f"{name}: launches "
                     f"{ {k: v for k, v in match.LAUNCHES.items() if v} }")
            scores = match._packed_scores_plain(qa, wk, k_used, None, None,
                                                None, False)
            ref_idx, ref_val = match._first_max(scores)
            second = torch.topk(scores, 2, dim=1).values[:, 1]
            del scores
            atol = P3W_ATOL if wide else PACKED_ATOL
            err, ndiff = check_picks(name, idx, val, ref_idx, ref_val,
                                     second, atol,
                                     band=P3W_ATOL if wide else SCORE_BAND)
            if int(idx[0]) != lo or int(idx.max()) >= n_real:
                fail(f"{name}: duplicate/padding rule broken (idx[0]="
                     f"{int(idx[0])}, max {int(idx.max())})")
            k_ms = cuda_time_ms(lambda: match.packed_best(qa, wk, k_used),
                                reps=20, flush=flush)
            wkt = wk.T
            l_ms = cuda_time_ms(
                lambda: torch.mm(qa, wkt, out_dtype=torch.float32).max(dim=1),
                reps=10, flush=flush)
            p_ms = cuda_time_ms(lambda: match.packed_best_plain(
                qa, wk, k_used), reps=3, flush=flush)
            b = packed_bound(m, npad, width)
            seg = dict(m=m, npad=npad, width=width, k_used=k_used,
                       kp=int(wk.shape[1]), route=route,
                       plan=dict(plan._asdict()), ms=k_ms, library_ms=l_ms,
                       plain_ms=p_ms, bound_ms=b[0], bound_by=b[1],
                       bound_share=b[0] / k_ms, max_abs_err=err,
                       picks_differing_in_band=ndiff)
            if theirs is not None and not wide:
                ti, tv = theirs[f"idx/{lw}"], theirs[f"val/{lw}"]
                seg.update(parent_ms=parent_ms[str(lw)],
                           picks_equal_parent=int(
                               (ti == idx.cpu().numpy()).sum()),
                           val_bits_equal_parent=int(
                               (tv.view(np.int32) == val.cpu().numpy().view(
                                   np.int32)).sum()))
            say("kernels", kernel="packed_best", **seg)
            if lw == P2KW_ROW_LW:
                rows["packed2kw_best"] = kernel_row(
                    "packed2kw_best", "packed2kw_best.cu", 523, err, k_ms,
                    p_ms, l_ms, b)
            del qa, wk, wkt
        torch.cuda.empty_cache()


# the per-tile champions' shapes (L, folded) at M = 352, N = 2^20, tile
# 4,096: packed3_champions at 2L = 110 (the kernel's row in the table) and
# at 414 lanes (folded past 256 lanes: packed3w_best.cu), packed2_champions
# (unfolded) at 110
CHAMPION_SHAPES = ((55, 1), (207, 1), (55, 0))


def champion_case(match, lw=55):
    """Seeded packed3 operands at level 0 of npr_1024 (M = 352, N = 2^20,
    2L = 2 ``lw`` lanes), built as the exact_hi2 level build makes them
    (``pack_w12``): live-dim rows uniform in [0, 0.2), the last 5,000 rows
    padding (the last scan tile all padding), row 900,000 a copy of row
    12,345 (its half norm too); queries centered by the DB's shift and split
    in three bf16 parts (``_packed3_rows``), query 0 equal to row 12,345.
    Returns (qa, qb, w1, w2, dbnh, k_used, tile, n_real).  Torch and the
    imported tree's match module only: the --parent child builds the same
    operands for the other tree's kernel."""
    import torch

    from image_analogies_tpu_torch.backends.cuda import (
        pack_w12, packed_shift_and_halfnorm, scan_tile_rows)

    dev = torch.device("cuda", 0)
    m, npad = SCAN_SHAPE["m"], SCAN_SHAPE["npad"]
    n_real = npad - 5000
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.rand((n_real, lw), generator=gen, device=dev) * 0.2
    x[900000] = x[12345]  # duplicate rows in different chunks and tiles
    live = torch.arange(lw, device=dev)
    shift, half_norm = packed_shift_and_halfnorm(x, live)
    w1, w2, dbnh = pack_w12(x, shift, half_norm, live, npad)
    dbnh[900000] = dbnh[12345]
    qv = torch.rand((m, lw), generator=gen, device=dev) * 0.2 - shift
    qv[0] = x[12345] - shift
    del x
    q1, q2, q3 = (t.to(torch.bfloat16) for t in match.bf16_split3(qv))
    qa, qb = match._packed3_rows(q1, q2, q3, w1.shape[1])
    return (qa, qb, w1, w2, dbnh, (2 * lw + 15) // 16 * 16,
            scan_tile_rows(npad), n_real)


def champion_operands(qa, qb, fold):
    """(qa, qb) of the champion scan: folded the packed3 rows; unfolded the
    rows [q1|q1] and [q1|q3] (qa's first block and qb), one tensor."""
    import torch

    if fold:
        return qa, qb
    m = qb.shape[0]
    q = torch.cat([qa[:m], qb])
    return q[:m], q[m:]


def run_champions_shapes(match, shapes):
    """``match.packed_champions`` on the seeded operands of each (L,
    folded) (``champion_case``): {"L/fold": (idx, vals, device ms)}, tile-
    major (ntiles, M), timed from a cold L2."""
    import torch

    flush = flusher(torch.device("cuda", 0))
    out = {}
    for lw, fold in shapes:
        qa, qb, w1, w2, dbnh, k_used, tile, _ = champion_case(match, lw)
        qa, qb = champion_operands(qa, qb, fold)
        call = lambda: match.packed_champions(qa, qb, w1, w2, dbnh, tile,
                                              k_used, fold_a=bool(fold))
        vals, idx = call()
        ms = cuda_time_ms(call, reps=20, flush=flush)
        out[f"{lw}/{fold}"] = (idx.cpu().numpy(), vals.cpu().numpy(), ms)
        del qa, qb, w1, w2, dbnh
        torch.cuda.empty_cache()
    return out


def phase_packed3_kernels(rows, parent):
    """packed3_best (exact_hi2's scan) and packed_champions (its per-tile
    witness) at level 0 of npr_1024: M = 352 queries as 704 + 352 rows of
    three passes, Npad = 1,048,576, 2L = 110 of 128 lanes; then the
    champions at each of ``CHAMPION_SHAPES`` (folded past 256 lanes the
    width rule's packed3w_best.cu), each held against its plain version
    (the duplicate rows' tiles, the all-padding last tile), timed beside
    the per-tile yardstick and the bound; 2L = 110 folded is the kernel's
    row.  With ``parent``: that tree's packed_champions on the same inputs
    (a child process), its ms and the counts of equal picks and val bits
    over the (tile, query) champions; fewer than 99.9% equal picks fails."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.ops import match

    dev = torch.device("cuda", 0)
    m, npad = SCAN_SHAPE["m"], SCAN_SHAPE["npad"]
    theirs = None
    if parent:
        theirs, parent_ms = parent_bits("champions", parent,
                                        list(CHAMPION_SHAPES))
    flush = flusher(dev)
    for lw, fold in CHAMPION_SHAPES:
        qa, qb, w1, w2, dbnh, k_used, tile, n_real = champion_case(match, lw)
        ntiles = npad // tile
        # the function's work at its own width 2L (the kernel rounds its
        # lanes up to a multiple of 16): 3 (folded) or 2 passes of 2L
        # products per (query, row)
        width = 2 * lw
        if (lw, fold) == (55, 1):
            kw = dict(qb=qb, w2=w2, dbnh=dbnh, fold_a=True)
            idx, val = match.packed_best(qa, w1, k_used, **kw)
            torch.cuda.synchronize()
            scores = match._packed_scores_plain(qa, w1, k_used, qb, w2, dbnh,
                                                True)
            ref_idx, ref_val = match._first_max(scores)
            second = torch.topk(scores, 2, dim=1).values[:, 1]
            del scores
            err, ndiff = check_picks("packed3_best", idx, val, ref_idx,
                                     ref_val, second, PACKED_ATOL)
            if int(idx[0]) != 12345 or int(idx.max()) >= n_real:
                fail(f"packed3_best: duplicate/padding rule broken (idx[0]="
                     f"{int(idx[0])}, max {int(idx.max())})")
            b = packed3_bound(m, npad, width)
            k_ms = cuda_time_ms(lambda: match.packed_best(qa, w1, k_used,
                                                          **kw),
                                reps=20, flush=flush)
            p_ms = cuda_time_ms(lambda: match.packed_best_plain(
                qa, w1, k_used, **kw), reps=3, flush=flush)
            l_ms = cuda_time_ms(packed3_library(qa, qb, w1, w2, dbnh, m),
                                reps=10, flush=flush)
            rows["packed3_best"] = kernel_row(
                "packed3_best", "packed3_best.cu", 523, err, k_ms, p_ms,
                l_ms, b)
            say("kernels", kernel="packed3_best", m=m, npad=npad,
                width=width, k_used=k_used, max_abs_err=err,
                picks_differing_in_band=ndiff, ms=k_ms, plain_ms=p_ms,
                library_ms=l_ms, bound_ms=b[0], bound_by=b[1])
        qa, qb = champion_operands(qa, qb, fold)
        name = f"packed_champions L={lw} fold={fold}"
        route = match._champions_route(k_used, bool(fold))
        call = lambda: match.packed_champions(qa, qb, w1, w2, dbnh, tile,
                                              k_used, fold_a=bool(fold))
        match.reset_launch_counts()
        vals, tidx = call()
        torch.cuda.synchronize()
        if match.LAUNCHES["packed_champions"] != 1 or sum(
                match.LAUNCHES.values()) != 1:
            fail(f"{name}: launches {match.LAUNCHES}")
        scores = match._packed_scores_plain(qa, w1, k_used, qb, w2, dbnh,
                                            bool(fold))
        ref_tv, ref_ti = match._tile_champions(scores, tile)
        second_t = torch.topk(scores.view(m, ntiles, tile), 2,
                              dim=2).values[..., 1].T
        del scores
        atol = PACKED_ATOL if k_used <= 256 else P3W_ATOL
        terr, tdiff = check_tiles(name, vals, tidx, ref_tv, ref_ti, second_t,
                                  atol)
        del ref_tv, ref_ti, second_t
        if (int(tidx[12345 // tile, 0]), int(tidx[900000 // tile, 0])) != (
                12345, 900000) or not bool(torch.isneginf(vals[-1]).all()):
            fail(f"{name}: duplicate/all-padding tile rule broken")
        k_ms = cuda_time_ms(call, reps=20, flush=flush)
        p_ms = cuda_time_ms(lambda: match.packed_champions_plain(
            qa, qb, w1, w2, dbnh, tile, k_used, fold_a=bool(fold)), reps=3,
            flush=flush)
        w1t, w2t = w1.T, w2.T

        def library():
            mm = lambda a, b: torch.mm(a, b, out_dtype=torch.float32)
            d = mm(qa[:m], w1t)
            if fold:
                d += mm(qa[m:], w1t)
            d += mm(qb, w2t)
            return (d - dbnh).view(m, ntiles, tile).max(dim=2)

        l_ms = cuda_time_ms(library, reps=10, flush=flush)
        b = (packed3_bound(m, npad, width, ntiles) if fold
             else packed2_bound(m, npad, width, ntiles))
        seg = dict(route=route, m=m, npad=npad, tile=tile, width=width,
                   passes=3 if fold else 2, k_used=k_used, max_abs_err=terr,
                   picks_differing_in_band=tdiff, ms=k_ms, plain_ms=p_ms,
                   library_ms=l_ms, bound_ms=b[0], bound_by=b[1],
                   bound_share=b[0] / k_ms,
                   plan=match._champions_plan(m, npad, match._sm_count(0),
                                              k_used, bool(fold),
                                              tile)._asdict())
        if theirs is not None:
            key = f"{lw}/{fold}"
            ti, tv = theirs[f"idx/{key}"], theirs[f"val/{key}"]
            picks = int((ti == tidx.cpu().numpy()).sum())
            seg.update(parent_ms=parent_ms[key], picks_equal_parent=picks,
                       val_bits_equal_parent=int(
                           (tv.view(np.int32) == vals.cpu().numpy().view(
                               np.int32)).sum()), champions=ti.size)
            if picks < 0.999 * ti.size:
                say("kernels", kernel="packed_champions", **seg)
                fail(f"{name}: {picks} of {ti.size} picks equal to "
                     f"{parent}'s kernel, fewer than 99.9%")
        if (lw, fold) == (55, 1):
            rows["packed_champions"] = kernel_row(
                "packed_champions", "tile_champions.cu", 426, terr, k_ms,
                p_ms, l_ms, b)
        say("kernels", kernel="packed_champions", **seg)
        del qa, qb, w1, w2, w1t, w2t, dbnh, vals, tidx
        torch.cuda.empty_cache()


def phase_bf16_db_kernels(rows):
    """pertile_champions (scan_rescue) and argmin2_l2 (two_pass), q_split,
    at level 0 of npr_1024: M = 352 queries as 704 hi/lo rows, the bf16
    centered DB of Npad = 1,048,576 rows, F = 68 of Fp = 128 lanes, the
    port's rescue tile."""
    import torch

    from image_analogies_tpu_torch.backends.cuda import scan_tile_rows
    from image_analogies_tpu_torch.ops import match

    dev = torch.device("cuda", 0)
    s = SCAN_SHAPE
    m, npad, f, fp = s["m"], s["npad"], s["f"], s["fp"]
    n_real = npad - 5000
    tile = scan_tile_rows(npad)
    ntiles = npad // tile
    k_used = (f + 15) // 16 * 16
    gen = torch.Generator(device=dev).manual_seed(19)
    db = torch.rand((n_real, f), generator=gen, device=dev) * 0.2
    db[900000] = db[12345]
    dbc = db - db.mean(dim=0)[None, :]
    dbp = torch.zeros((npad, fp), dtype=torch.bfloat16, device=dev)
    dbp[:n_real, :f] = dbc.to(torch.bfloat16)
    dbn = torch.full((npad,), float("inf"), device=dev)
    dbn[:n_real] = (dbc * dbc).sum(dim=1)
    dbnh = 0.5 * dbn
    q = torch.zeros((m, fp), device=dev)
    q[:, :f] = dbc[torch.randint(0, n_real, (m,), generator=gen,
                                 device=dev)] \
        + torch.randn((m, f), generator=gen, device=dev) * 0.02
    q[0, :f] = dbp[12345, :f].float()
    del db, dbc
    flush = flusher(dev)

    vals, tidx = match.pertile_champions(q, dbp, dbnh, tile, True, k_used)
    i1, v1, i2, v2 = match.argmin2_l2(q, dbp, dbn, True, k_used)
    torch.cuda.synchronize()
    qk = match._scan_queries(q, True)
    dots = match._dots(qk[:m], dbp, k_used) + match._dots(qk[m:], dbp,
                                                          k_used)
    s2 = dots - dbnh
    ref_tv, ref_ti = match._tile_champions(s2, tile)
    second_t = torch.topk(s2.view(m, ntiles, tile), 2,
                          dim=2).values[..., 1].T
    del s2
    terr, tdiff = check_tiles("pertile_champions", vals, tidx, ref_tv,
                              ref_ti, second_t, PACKED_ATOL)
    if (int(tidx[12345 // tile, 0]), int(tidx[900000 // tile, 0])) != (
            12345, 900000) or not bool(torch.isneginf(vals[-1]).all()):
        fail("pertile_champions: duplicate/all-padding tile rule broken")
    sl2 = dbn[None, :] - 2.0 * dots
    del dots
    top3 = torch.topk(sl2, 3, dim=1, largest=False).values
    del sl2
    r1, rv1, r2, rv2 = match.argmin2_l2_plain(q, dbp, dbn, True, k_used)
    e1, d1 = check_picks("argmin2_l2 first", i1, v1, r1, rv1, top3[:, 1],
                         PACKED_ATOL)
    e2, d2 = check_picks("argmin2_l2 second", i2, v2, r2, rv2, top3[:, 2],
                         PACKED_ATOL)
    if (int(i1[0]), int(i2[0])) != (12345, 900000) or \
            int(torch.maximum(i1, i2).max()) >= n_real:
        fail(f"argmin2_l2: duplicate/padding rule broken (i1[0]="
             f"{int(i1[0])}, i2[0]={int(i2[0])})")

    dbt = dbp.T

    def library_dots():
        return (torch.mm(qk[:m], dbt, out_dtype=torch.float32)
                + torch.mm(qk[m:], dbt, out_dtype=torch.float32))

    k_ms = cuda_time_ms(lambda: match.pertile_champions(
        q, dbp, dbnh, tile, True, k_used), reps=20, flush=flush)
    p_ms = cuda_time_ms(lambda: match.pertile_champions_plain(
        q, dbp, dbnh, tile, True, k_used), reps=3, flush=flush)
    l_ms = cuda_time_ms(lambda: (library_dots() - dbnh).view(
        m, ntiles, tile).max(dim=2), reps=10, flush=flush)
    # the function's work at its own width F = 68 (the kernel rounds its
    # lanes up to 80): hi and lo passes of F products per (query, row)
    b = pertile_bound(m, npad, f, ntiles)
    rows["pertile_champions"] = kernel_row(
        "pertile_champions", "pertile_champions.cu", 300, terr, k_ms, p_ms,
        l_ms, b)
    say("kernels", kernel="pertile_champions", q_split=True, m=m,
        npad=npad, tile=tile, f=f, k_used=k_used, max_abs_err=terr,
        picks_differing_in_band=tdiff, ms=k_ms, plain_ms=p_ms,
        library_ms=l_ms, bound_ms=b[0], bound_by=b[1])

    k_ms = cuda_time_ms(lambda: match.argmin2_l2(q, dbp, dbn, True, k_used),
                        reps=20, flush=flush)
    p_ms = cuda_time_ms(lambda: match.argmin2_l2_plain(
        q, dbp, dbn, True, k_used), reps=3, flush=flush)
    l_ms = cuda_time_ms(lambda: torch.topk(
        dbn[None, :] - 2.0 * library_dots(), 2, dim=1, largest=False),
        reps=10, flush=flush)
    b = argmin2_bound(m, npad, f)
    err = max(e1, e2)
    rows["argmin2_l2"] = kernel_row("argmin2_l2", "argmin2.cu", 131, err,
                                    k_ms, p_ms, l_ms, b)
    say("kernels", kernel="argmin2_l2", q_split=True, m=m, npad=npad, f=f,
        k_used=k_used, max_abs_err=err, picks_differing_in_band=d1 + d2,
        ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b[0],
        bound_by=b[1])
    del q, qk, dbp, dbt, dbn, dbnh
    torch.cuda.empty_cache()


def batched_level_shapes():
    """[(level, npad, m, rows, F)]: the approximate match of batched
    npr_1024 on the 1024^2 inputs, level by level as the level build makes
    it: one scan row of M = w pixels a launch, ``rows`` = h launches,
    against the rows-above DB of h w rows padded to a multiple of
    ``PAD_TILE`` (``pad_bf16_uncentered``), F the level's feature width
    (``spec_for_level``, a luminance source: no coarse block at the
    coarsest level)."""
    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.backends.cuda import PAD_TILE
    from image_analogies_tpu_torch.ops.features import spec_for_level

    params = PRESETS["npr_1024"]
    out, h = [], 1024
    for level in range(params.levels):
        f = spec_for_level(params, level, params.levels, 1).total
        out.append((level, -(-h * h // PAD_TILE) * PAD_TILE, h, h, f))
        h = (h + 1) // 2
    return out


def run_argmin_bf16_shapes(match, shapes):
    """``match.argmin_l2_bf16`` (the F used lanes rounded up to 16) on the
    seeded operands of each (level, npad, m, rows, F) (``argmin2_cases``,
    uncentered): {"npad/m": (idx, val, device ms)}, timed from a cold L2."""
    import torch

    flush = flusher(torch.device("cuda", 0))
    out = {}
    for shape, (_, npad, m, _, q, dbp, dbn, *_) in zip(
            shapes, argmin2_cases(shapes, center=False)):
        k_used = (shape[4] + 15) // 16 * 16
        idx, val = match.argmin_l2_bf16(q, dbp, dbn, k_used)
        ms = cuda_time_ms(lambda: match.argmin_l2_bf16(q, dbp, dbn, k_used),
                          reps=20, flush=flush)
        out[f"{npad}/{m}"] = (idx.cpu().numpy(), val.cpu().numpy(), ms)
    return out


def argmin_bf16_bound(m, npad, f):
    """Bound of one argmin_l2_bf16 call at the function's own width F: the
    fp32 queries, the F used DB lanes and the norms read once, (idx, val)
    written once; one pass of 2 M N F bf16 operations."""
    return bound(4 * m * f + 2 * npad * f + 4 * npad + 8 * m,
                 2 * m * npad * f, PEAK_BF16_FLOP_S)


def phase_argmin_bf16_levels(rows, parent):
    """argmin_l2_bf16 (the batched/rowwise approximate match) at each level
    of batched npr_1024 (``batched_level_shapes``: M = 1024 >> l queries,
    one scan row, against the level's rows-above DB, the last npad / 1024
    rows padding); level 0 (M = 1,024, N = 2^20, F = 68 of 128 lanes) is
    the headline and the kernel's row in the table.  Held against its
    plain version (scores within PACKED_ATOL, picks equal outside
    SCORE_BAND, the duplicate and padding rules), timed from a cold L2
    beside the bf16 ``mm`` + ``min`` yardstick and the bound; each level's
    launches are its scan rows, its weighted ms the launches times the ms,
    and the weight of the gap the sum over levels of launches x (ms -
    bound).  With ``parent``: that tree's argmin_l2_bf16 on the same inputs
    (a child process), its ms and the counts of equal picks and val bits;
    fewer than 99.9% equal picks at a level fails."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.ops import match

    shapes = batched_level_shapes()
    theirs = None
    if parent:
        theirs, parent_ms = parent_bits("argmin_bf16", parent, shapes)
    flush = flusher(torch.device("cuda", 0))
    keys = ["ms", "bound_ms", "library_ms"] + (["parent_ms"] if theirs
                                               else [])
    total = dict.fromkeys(keys, 0.0)
    for (level, npad, m, launches, f), case in zip(
            shapes, argmin2_cases(shapes, center=False)):
        q, dbp, dbn, n_real, lo = case[4:9]
        name = f"argmin_l2_bf16 level {level} M={m}"
        k_used = (f + 15) // 16 * 16
        match.reset_launch_counts()
        idx, val = match.argmin_l2_bf16(q, dbp, dbn, k_used)
        torch.cuda.synchronize()
        if match.LAUNCHES["argmin_l2_bf16"] != 1:
            fail(f"{name}: {match.LAUNCHES['argmin_l2_bf16']} launches")
        qk = match._scan_queries(q, False)
        dbt = dbp.T
        second = torch.topk(dbn[None, :] - 2.0 * match._dots(qk, dbp, k_used),
                            2, dim=1, largest=False).values[:, 1]
        ref_idx, ref_val = match.argmin_l2_bf16_plain(q, dbp, dbn, k_used)
        err, ndiff = check_picks(name, idx, val, ref_idx, ref_val, second,
                                 PACKED_ATOL)
        del second, ref_idx, ref_val
        if int(idx[0]) != lo or int(idx.max()) >= n_real:
            fail(f"{name}: duplicate/padding rule broken (idx[0]="
                 f"{int(idx[0])}, max {int(idx.max())})")
        k_ms = cuda_time_ms(lambda: match.argmin_l2_bf16(q, dbp, dbn,
                                                         k_used),
                            reps=20, flush=flush)
        p_ms = cuda_time_ms(lambda: match.argmin_l2_bf16_plain(
            q, dbp, dbn, k_used), reps=3, flush=flush)
        l_ms = cuda_time_ms(lambda: (dbn[None, :] - 2.0 * torch.mm(
            qk, dbt, out_dtype=torch.float32)).min(dim=1), reps=10,
            flush=flush)
        b = argmin_bf16_bound(m, npad, f)
        seg = dict(level=level, m=m, npad=npad, f=f, k_used=k_used,
                   launches=launches, ms=k_ms, plain_ms=p_ms,
                   library_ms=l_ms, bound_ms=b[0], bound_by=b[1],
                   bound_share=b[0] / k_ms, max_abs_err=err,
                   picks_differing_in_band=ndiff)
        if theirs is not None:
            key = f"{npad}/{m}"
            ti, tv = theirs[f"idx/{key}"], theirs[f"val/{key}"]
            picks = int((ti == idx.cpu().numpy()).sum())
            seg.update(parent_ms=parent_ms[key], picks_equal_parent=picks,
                       val_bits_equal_parent=int(
                           (tv.view(np.int32)
                            == val.cpu().numpy().view(np.int32)).sum()))
            if picks < 0.999 * m:
                say("kernels", kernel="argmin_l2_bf16", **seg)
                fail(f"{name}: {picks} of {m} picks equal to {parent}'s "
                     "kernel, fewer than 99.9%")
        for k in keys:
            total[k] += launches * seg[k]
        say("kernels", kernel="argmin_l2_bf16", **seg,
            **{f"weighted_{k}": launches * seg[k] for k in keys})
        if level == 0:
            rows["argmin_l2_bf16"] = kernel_row(
                "argmin_l2_bf16", "argmin_bf16.cu", 51, err, k_ms, p_ms,
                l_ms, b)
        del q, qk, dbp, dbt, dbn, case, idx, val
    torch.cuda.empty_cache()
    say("kernels", kernel="argmin_l2_bf16", levels=[sh[0] for sh in shapes],
        launches=sum(sh[3] for sh in shapes),
        weighted_gap_ms=total["ms"] - total["bound_ms"],
        **{f"weighted_{k}": v for k, v in total.items()})


def forms_operands(match, m, npad, lw=FORMS_LW):
    """Each superseded packed form's ``packed_best`` operands as its wrapper
    in ops/match.py builds them, on the card: {form: (qa, w1, k_used,
    keywords, lanes of the function's product set (4L, 3L, 4L + 3 or 3L +
    3), weight lanes it reads, its line in pallas_match.py)}, qa and qb of
    the two-stream forms adjacent rows of one tensor.  Seeded live-dim rows
    uniform in [0, 0.2), the last npad / 1024 (at least 100) rows padding,
    row 60,000 N / 65,536 a copy of row 345 (another DB chunk); M queries,
    query 0 equal to row 345, centered by the DB's shift and split in bf16
    parts.  Returns (operands, the real rows, 345).  Torch and the imported
    tree's match module only: the --parent child builds the same operands
    for the other tree's kernels."""
    import torch

    from image_analogies_tpu_torch.backends.cuda import (
        packed_shift_and_halfnorm)

    dev = torch.device("cuda", 0)
    bf16 = torch.bfloat16
    n_real = npad - max(100, npad >> 10)
    lo, hi = 345, 60000 * npad >> 16
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.rand((n_real, lw), generator=gen, device=dev) * 0.2
    x[hi] = x[lo]  # duplicate rows: ties go to the lowest index
    shift, half_norm = packed_shift_and_halfnorm(
        x, torch.arange(lw, device=dev))
    d1, d2, d3 = (t.to(bf16) for t in match.bf16_split3(x - shift))
    qv = torch.rand((m, lw), generator=gen, device=dev) * 0.2 - shift
    qv[0] = x[lo] - shift
    del x
    q1, q2 = (t.to(bf16) for t in match.bf16_split3(qv)[:2])
    dbnh = torch.full((npad,), float("inf"), device=dev)
    dbnh[:n_real] = half_norm
    kp = 128

    def pack(left, right):
        w = torch.zeros((npad, kp), dtype=bf16, device=dev)
        w[:n_real, :lw], w[:n_real, lw:2 * lw] = left, right
        return w

    def two(qa, qb):  # qa's rows then qb's, one tensor
        q = torch.cat([qa, qb])
        return q[:m], q[m:]

    pair = lambda left, right: match._pack_rows(left, right, kp)
    w12, w13 = pack(d1, d2), pack(d1, d3)
    w12n = match.add_norm_lanes(pack(d1, d2), dbnh, lw)
    qn = pair(q1, q1)
    qn[:, 2 * lw:2 * lw + 3] = 1.0
    qa2, qb2 = two(pair(q1, q1), pair(q2, q1))
    qa2n, qb2n = two(qn, pair(q2, q1))
    ops = {
        "packed2_best": (qa2, w12, match._lanes(lw),
                         dict(qb=qb2, w2=w13, dbnh=dbnh), 4 * lw, 4 * lw,
                         656),
        "packed1w_best": (torch.cat([pair(q1, q1),
                                     pair(q2, torch.zeros_like(q2))]),
                          w12, match._lanes(lw),
                          dict(dbnh=dbnh, fold_a=True), 3 * lw, 2 * lw, 673),
        "packed2wn_best": (qa2n, w12n, match._lanes(lw, norm=True),
                           dict(qb=qb2n, w2=w13), 4 * lw + 3, 4 * lw + 3,
                           781),
        "packed1wn_best": (match.norm_query_rows(q1, q2, kp), w12n,
                           match._lanes(lw, norm=True), dict(fold_a=True),
                           3 * lw + 3, 2 * lw + 3, 819),
    }
    wrapped = {  # each form through its wrapper, for the check that the
        # operands above are the wrapper's
        "packed2_best": lambda: match.packed2_best(q1, q2, w12, w13, dbnh),
        "packed1w_best": lambda: match.packed1w_best(q1, q2, w12, dbnh),
        "packed2wn_best": lambda: match.packed2wn_best(q1, q2, w12n, w13),
        "packed1wn_best": lambda: match.packed1wn_best(q1, q2, w12n),
    }
    return ops, wrapped, n_real, lo


def run_forms_shapes(match, shapes):
    """Each superseded form's ``match.packed_best`` on the seeded operands
    of each (m, npad) (``forms_operands``): {"form/npad/m": (idx, val,
    device ms)}, timed from a cold L2."""
    import torch

    flush = flusher(torch.device("cuda", 0))
    out = {}
    for m, npad in shapes:
        ops = forms_operands(match, m, npad)[0]
        for form, (qa, w1, k_used, kw, *_) in ops.items():
            idx, val = match.packed_best(qa, w1, k_used, **kw)
            ms = cuda_time_ms(lambda: match.packed_best(qa, w1, k_used, **kw),
                              reps=20, flush=flush)
            out[f"{form}/{npad}/{m}"] = (idx.cpu().numpy(),
                                         val.cpu().numpy(), ms)
        del ops
        torch.cuda.empty_cache()
    return out


def phase_packed_forms(rows, parent):
    """The four superseded packed forms (packed2_best.cu, packed1w_best.cu,
    packed2wn_best.cu and packed1wn_best.cu on the Hopper core) at each of
    ``FORMS_SHAPES`` on the operands each form's wrapper builds
    (``forms_operands``): one launch a call, held against the plain version
    (at the small shape on CPU copies, the wrapper's CPU path; at M = 352,
    N = 2^20 on the card), the duplicate and padding rules; the kernel,
    its plain version and the ``mm``s + ``max`` yardstick timed, the bound
    at the form's own width (its product set: 4L, 3L, 4L + 3 or 3L + 3
    lanes).  The small shape is each form's row in the table.  With
    ``parent``: that tree's forms on the same inputs (a child process), its
    ms and the counts of equal picks and val bits; fewer than 99.9% equal
    picks fails."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.ops import match

    shapes = [(s["m"], s["npad"]) for s in FORMS_SHAPES]
    theirs = None
    if parent:
        theirs, parent_ms = parent_bits("forms", parent, shapes)
    flush = flusher(torch.device("cuda", 0))
    for i, (m, npad) in enumerate(shapes):
        ops, wrapped, n_real, lo = forms_operands(match, m, npad)
        for form, (qa, w1, k_used, kw, width, w_lanes, line) in ops.items():
            name = f"{form} M={m} N={npad}"
            match.reset_launch_counts()
            idx, val = match.packed_best(qa, w1, k_used, **kw)
            torch.cuda.synchronize()
            if match.LAUNCHES[form] != 1 or sum(match.LAUNCHES.values()) != 1:
                fail(f"{name}: launches {match.LAUNCHES}, expected one")
            if not torch.equal(wrapped[form]()[0], idx):
                fail(f"{name}: the timed operands are not the wrapper's")
            # the plain version: at the small shape on the CPU copies (the
            # wrapper's CPU path), else on the card
            plain = [t.cpu() if i == 0 else t for t in (qa, w1)]
            pkw = {k: (v.cpu() if i == 0 and torch.is_tensor(v) else v)
                   for k, v in kw.items()}
            scores = match._packed_scores_plain(
                plain[0], plain[1], k_used, pkw.get("qb"), pkw.get("w2"),
                pkw.get("dbnh"), pkw.get("fold_a", False))
            ref_idx, ref_val = match._first_max(scores)
            second = torch.topk(scores, 2, dim=1).values[:, 1]
            del scores
            err, ndiff = check_picks(
                name, idx.to(ref_idx.device), val.to(ref_idx.device),
                ref_idx, ref_val, second, PACKED_ATOL)
            del ref_idx, ref_val, second
            if int(idx[0]) != lo or int(idx.max()) >= n_real:
                fail(f"{name}: duplicate/padding rule broken (idx[0]="
                     f"{int(idx[0])}, max {int(idx.max())})")
            w1t = w1.T
            w2t = kw["w2"].T if "w2" in kw else None

            def library(qa=qa, w1t=w1t, w2t=w2t, kw=kw):
                mm = lambda a, b: torch.mm(a, b, out_dtype=torch.float32)
                d = (mm(qa[:m], w1t) + mm(qa[m:], w1t) if kw.get("fold_a")
                     else mm(qa, w1t))
                if w2t is not None:
                    d = d + mm(kw["qb"], w2t)
                return (d - kw["dbnh"] if "dbnh" in kw else d).max(dim=1)

            k_ms = cuda_time_ms(lambda: match.packed_best(qa, w1, k_used,
                                                          **kw),
                                reps=20, flush=flush)
            p_ms = cuda_time_ms(lambda: match.packed_best_plain(
                qa, w1, k_used, **kw), reps=5 if i == 0 else 3, flush=flush)
            l_ms = cuda_time_ms(library, reps=10, flush=flush)
            # inputs read once (the weight lanes, the half norms unless they
            # ride W1, q1 and q2), outputs written once
            b = bound(2 * npad * w_lanes + (4 * npad if "dbnh" in kw else 0)
                      + 2 * 2 * m * FORMS_LW + 8 * m, 2 * m * npad * width,
                      PEAK_BF16_FLOP_S)
            seg = dict(m=m, npad=npad, width=width, k_used=k_used,
                       max_abs_err=err, picks_differing_in_band=ndiff,
                       ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                       bound_ms=b[0], bound_by=b[1], bound_share=b[0] / k_ms,
                       plan=match._packed_form_plan(
                           form, m, npad, match._sm_count(0),
                           k_used)._asdict())
            if theirs is not None:
                key = f"{form}/{npad}/{m}"
                ti, tv = theirs[f"idx/{key}"], theirs[f"val/{key}"]
                picks = int((ti == idx.cpu().numpy()).sum())
                seg.update(parent_ms=parent_ms[key], picks_equal_parent=picks,
                           val_bits_equal_parent=int(
                               (tv.view(np.int32) == val.cpu().numpy().view(
                                   np.int32)).sum()))
                if picks < 0.999 * m:
                    say("kernels", kernel=form, **seg)
                    fail(f"{name}: {picks} of {m} picks equal to {parent}'s "
                         "kernel, fewer than 99.9%")
            if i == 0:
                rows[form] = kernel_row(form, f"{form}.cu", line, err, k_ms,
                                        p_ms, l_ms, b)
            say("kernels", kernel=form, **seg)
            del w1t, w2t, idx, val
        del ops, wrapped
        torch.cuda.empty_cache()


def expected_launches(params, size: int, modes=None):
    """Kernel launches of a size x size run.  Wavefront: c(h-1)+w steps a
    level, each on its level's anchor kernel (``modes``: the mode each
    level ran, finest first; default the resolution of match_mode).
    Batched and rowwise: one ``argmin_l2_bf16`` launch per scan row.
    Exact: none."""
    from image_analogies_tpu_torch.backends.cuda import resolve_match_mode
    from image_analogies_tpu_torch.ops.pyramid import num_feasible_levels

    levels = num_feasible_levels((size, size), params.levels,
                                 params.patch_size)
    c = params.patch_size // 2 + 1
    out = {}
    h = size
    for level in range(levels):
        if params.strategy in ("batched", "rowwise"):
            key, n = "argmin_l2_bf16", h
        elif params.strategy in ("auto", "wavefront"):
            mode = (modes[level] if modes is not None
                    else resolve_match_mode(params.match_mode, h * h))
            key, n = ANCHOR_KERNEL[mode], c * (h - 1) + h
        else:
            key, n = None, 0
        if key:
            out[key] = out.get(key, 0) + n
        h = (h + 1) // 2
    return out


def run_path(phase, params, a, ap, b, runs=("first",), keep_levels=True,
             check_modes=True):
    """``create_image_analogy`` on the card once per label in ``runs``
    ("cold" then "warm" to time a warm run; "first" for a single run that
    is the process's first use of its mode), with every launch count set to
    0 just before each run and read just after: each level's kernel must
    have launched once per wavefront step or scan row, and no other kernel
    at all.  Returns (result, launches of the last run)."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.ops import match

    size = a.shape[0]
    result = launches = None
    for run in runs:
        match.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = create_image_analogy(a, ap, b, params,
                                      keep_levels=keep_levels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(match.LAUNCHES)
        stats = sorted(result.stats, key=lambda st: st["level"])
        modes = [st.get("match_mode") for st in stats]
        want = expected_launches(params, size,
                                 None if check_modes else modes)
        extra = {}
        if params.strategy == "batched":
            extra["refined"] = {st["level"]: st["refined_ratio"]
                                for st in stats}
        say(phase, run=run, size=size, strategy=params.strategy,
            match_mode=params.match_mode, wall_s=wall,
            level_ms={st["level"]: st["ms"] for st in stats},
            level_build_ms={st["level"]: st["total_ms"] - st["ms"]
                            for st in stats},
            level_mode={st["level"]: st.get("match_mode", st["strategy"])
                        for st in stats},
            coherence={st["level"]: st["coherence_ratio"] for st in stats},
            **extra,
            launches={k: v for k, v in launches.items() if v},
            expected_launches=want,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        for name, n in launches.items():
            if n != want.get(name, 0):
                fail(f"{phase}: {name} launched {n} times, expected "
                     f"{want.get(name, 0)} (one per wavefront step or scan "
                     "row of its levels)")
    bp = result.bp_y
    if bp.shape != (size, size) or not bool(np.isfinite(bp).all()):
        fail(f"{phase}: B' is not a finite {size}x{size} plane")
    return result, launches


def load_oracle_inputs(seed=7):
    from image_analogies_tpu_torch.utils.assets import (input_digest,
                                                        make_structured)

    a, ap, b = make_structured(1024, seed)
    digest = input_digest(a, ap, b)
    if digest != ORACLE_DIGESTS[seed]:
        fail(f"inputs drifted from the cached seed-{seed} oracle ({digest} "
             f"!= {ORACLE_DIGESTS[seed]})")
    return a, ap, b


def phase_main(a, ap, b):
    from image_analogies_tpu_torch import PRESETS

    params = PRESETS["npr_1024"]
    result, launches = run_path("main", params, a, ap, b,
                                runs=("cold", "warm"))
    return params, result, launches


def phase_oracle(a, ap, b, params, result, phase="oracle",
                 ssim_min=SSIM_MIN, unexplained_max=UNEXPLAINED_MAX, seed=7):
    """SSIM and the tie-audit against the cached 1024^2 oracle of
    make_structured ``seed``; with ``unexplained_max`` None (the probe
    modes) the audit is reported only."""
    import numpy as np

    from image_analogies_tpu_torch.utils.parity import (
        audit_source_map_mismatches)
    from image_analogies_tpu_torch.utils.ssim import ssim

    oz = np.load(os.path.join(HERE, "bench_cache",
                              f"oracle_1024_seed{seed}.npz"))
    s = ssim(result.bp_y, oz["bp_y"])
    oracle_levels = [(oz[f"bp_l{i}"], oz[f"s_l{i}"])
                     for i in range(len(result.levels))]
    t0 = time.perf_counter()
    audit = audit_source_map_mismatches(a, ap, b, params, result.levels,
                                        oracle_levels)
    frac = audit["unexplained"] / max(audit["mismatches"], 1)
    say(phase, seed=seed, ssim=s, value_match=float(
        (result.source_map == oz["source_map"]).mean()),
        mismatches=audit["mismatches"], ctx_diverged=audit["ctx_diverged"],
        tie_exact=audit["tie_exact"], tie_fp=audit["tie_fp"],
        kappa_boundary=audit["kappa_boundary"],
        unexplained=audit["unexplained"], unexplained_fraction=frac,
        explained=audit["mismatch_explained_by_ties"],
        first_divergence_is_tie=audit["first_divergence_is_tie"],
        max_fp_band=audit["max_fp_band"],
        audit_s=time.perf_counter() - t0)
    if not s >= ssim_min:
        fail(f"{phase}: SSIM vs oracle {s:.4f} < {ssim_min}")
    if unexplained_max is not None and not frac <= unexplained_max:
        fail(f"{phase}: tie-audit unexplained fraction {frac:.3g} > "
             f"{unexplained_max}")


def phase_oracle13(params):
    """The main path once on the seed-13 1024^2 inputs, audited against
    their cached oracle with the seed-7 limits."""
    a, ap, b = load_oracle_inputs(13)
    result, _ = run_path("oracle", params, a, ap, b, runs=("seed13",))
    phase_oracle(a, ap, b, params, result, seed=13)


def phase_exact_hi2(a, ap, b):
    """exact_hi2 (packed3 at every level) at 1024^2, held to the main
    path's oracle limits."""
    from image_analogies_tpu_torch import PRESETS

    params = dataclasses.replace(PRESETS["npr_1024"], match_mode="exact_hi2")
    result, launches = run_path("exact_hi2", params, a, ap, b,
                                runs=("cold", "warm"))
    phase_oracle(a, ap, b, params, result, phase="exact_hi2")
    return launches


def phase_probe(phase, mode, a, ap, b):
    """A non-parity probe mode at 1024^2 (a wiring check against the
    oracle, not a parity claim), then its single-pass variant at 256^2."""
    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.utils.assets import make_structured

    os.environ["IA_EXPERIMENTAL"] = "1"
    params = dataclasses.replace(PRESETS["npr_1024"], match_mode=mode)
    result, launches = run_path(phase, params, a, ap, b,
                                runs=("cold", "warm"))
    phase_oracle(a, ap, b, params, result, phase=phase,
                 ssim_min=PROBE_SSIM_MIN, unexplained_max=None)
    small = make_structured(256, 7)
    run_path(phase, dataclasses.replace(params, match_mode=mode + "_1p"),
             *small, keep_levels=False)
    return launches


def phase_batched(a, ap, b):
    """The batched strategy with the npr_1024 preset at 1024^2, cold then
    warm (SSIM vs the oracle printed, not asserted: batched is not a
    parity mode), then the self-analogy B = A at 256^2 (3 levels, the JAX
    package's floors asserted) and at 1024^2 (printed)."""
    import numpy as np

    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.utils.assets import make_structured
    from image_analogies_tpu_torch.utils.ssim import ssim

    params = dataclasses.replace(PRESETS["npr_1024"], strategy="batched")
    result, launches = run_path("batched", params, a, ap, b,
                                runs=("cold", "warm"), keep_levels=False)
    oz = np.load(os.path.join(HERE, "bench_cache", "oracle_1024_seed7.npz"))
    say("batched", ssim_vs_oracle=ssim(result.bp_y, oz["bp_y"]),
        value_match=float((result.source_map == oz["source_map"]).mean()))
    for size, levels in ((256, 3), (1024, params.levels)):
        sa, sap = (a, ap) if size == 1024 else make_structured(size, 7)[:2]
        res, _ = run_path("batched", dataclasses.replace(params,
                                                         levels=levels),
                          sa, sap, sa.copy(), keep_levels=False)
        sv = ssim(res.bp_y, sap)
        ident = float((res.source_map.reshape(-1)
                       == np.arange(sa.size)).mean())
        say("batched", self_analogy=size, levels=levels, ssim_vs_ap=sv,
            identity=ident)
        if size == 256 and not (sv >= SELF_SSIM_MIN
                                and ident >= SELF_IDENTITY_MIN):
            fail(f"batched: self-analogy at 256^2 SSIM {sv:.4f} (floor "
                 f"{SELF_SSIM_MIN}), identity {ident:.4f} (floor "
                 f"{SELF_IDENTITY_MIN})")
    return launches


def phase_gate():
    """bf16_scoring at 64^2: the parity gate probes on this card (two 32^2
    syntheses and their audit); its verdict is printed, not asserted, and
    every level then runs the mode the verdict allows."""
    import torch

    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.backends import gate
    from image_analogies_tpu_torch.backends.cuda import resolve_match_mode
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.utils.assets import make_structured

    gate.reset_bf16_gate()
    params = dataclasses.replace(PRESETS["npr_1024"], bf16_scoring=True)
    dev = torch.device("cuda", 0)
    match.reset_launch_counts()
    t0 = time.perf_counter()
    allowed = gate.bf16_gate_allows(params, dev)
    probe_s = time.perf_counter() - t0
    say("gate", device=gate.device_key(dev), probe_s=probe_s,
        probe_launches={k: v for k, v in match.LAUNCHES.items() if v},
        **gate.bf16_gate_verdict(dev))
    a, ap, b = make_structured(64, 7)
    result, _ = run_path("gate", params, a, ap, b, keep_levels=False,
                         check_modes=False)
    for st in result.stats:
        h = a.shape[0]
        for _ in range(st["level"]):
            h = (h + 1) // 2
        want = ("scan_rescue" if allowed
                else resolve_match_mode(params.match_mode, h * h))
        if st["match_mode"] != want:
            fail(f"gate: level {st['level']} ran {st['match_mode']}, the "
                 f"verdict allows {want}")


def phase_card_vs_cpu():
    """exact_hi2, scan_rescue[_1p] and two_pass[_1p] at 96^2 (3 levels) on
    the card and on the CPU, exact_hi2 and scan_rescue on RGB sources;
    exact_hi2 on RGB sources at patch 7 (64^2, 2 levels: 2L = 414 and 342
    lanes, packed3w_best.cu at every wavefront step); then
    batched (96^2) and rowwise (64^2) against a CPU run of the same bf16
    approximate match (the kernel's plain version, through the level's
    approx_fn), and exact (48^2) against the CPU's fp32 scan.  Returns the
    launch counts of the patch-7 card run."""
    import numpy as np

    from image_analogies_tpu_torch import AnalogyParams, create_image_analogy
    from image_analogies_tpu_torch.backends.cuda import CudaMatcher
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.utils.assets import make_structured
    from image_analogies_tpu_torch.utils.ssim import ssim

    os.environ["IA_EXPERIMENTAL"] = "1"
    gray = make_structured(96, 7)
    rgb = tuple(np.stack([x, x * x, 1 - x], -1).astype(np.float32)
                for x in gray)
    rgb64 = tuple(np.ascontiguousarray(x[16:80, 16:80]) for x in rgb)
    cases = [(dict(match_mode=mode), gray) for mode in NEW_MODES] + [
        (dict(match_mode=mode, color_mode="source_rgb"), rgb)
        for mode in ("exact_hi2", "scan_rescue")] + [
        (dict(match_mode="exact_hi2", color_mode="source_rgb", patch_size=7,
              levels=2), rgb64)] + [
        (dict(strategy=strategy), make_structured(size, 7))
        for strategy, size in (("batched", 96), ("rowwise", 64),
                               ("exact", 48))]
    wide = None
    for kw, (a, ap, b) in cases:
        params = AnalogyParams(**{"levels": 3, "kappa": 5.0, **kw})
        match.reset_launch_counts()
        gpu = create_image_analogy(a, ap, b, params)
        if kw.get("patch_size") == 7:
            wide = dict(match.LAUNCHES)
            want = sum(expected_launches(params, a.shape[0]).values())
            if wide["packed3w_best"] != want or wide["packed3_best"]:
                fail(f"card_vs_cpu: {kw} launched "
                     f"{ {k: v for k, v in wide.items() if v} }, expected "
                     f"packed3w_best once per wavefront step ({want})")
        cpu = create_image_analogy(a, ap, b, params, backend=CudaMatcher(
            params, "cpu", bf16_approx=params.strategy in ("batched",
                                                           "rowwise")))
        diff = float((gpu.source_map != cpu.source_map).mean())
        s = ssim(gpu.bp_y, cpu.bp_y)
        say("card_vs_cpu", size=a.shape[0], **kw, source_map_differs=diff,
            ssim=s)
        if not (diff < CARD_CPU_MISMATCH_MAX and s >= CARD_CPU_SSIM_MIN
                and np.isfinite(gpu.bp).all()):
            fail(f"card_vs_cpu: {kw} differs from its CPU run (source maps "
                 f"{diff:.4f}, SSIM {s:.4f})")
    return wide


def want_launches(params, b_shape, stats, src_channels, temporal=False):
    """Kernel launches of one wavefront ``create_image_analogy`` call from
    its level stats: c(h-1)+w steps a level (B's plane at that level), each
    on the kernel its resolved match mode runs at the level's lane width
    (packed2k past 512 lanes: packed2kw_best; packed3 past 256:
    packed3w_best)."""
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.ops.features import spec_for_level

    levels = len(stats)
    c = params.patch_size // 2 + 1
    out = {}
    for st in stats:
        level, mode = st["level"], st["match_mode"]
        hb, wb = b_shape
        for _ in range(level):
            hb, wb = (hb + 1) // 2, (wb + 1) // 2
        spec = spec_for_level(params, level, levels, src_channels,
                              temporal=temporal)
        lw = int(spec.query_live_mask().sum())
        if mode == "exact_hi2_2p":
            key = match._packed2k_route((4 * lw + 3 + 15) // 16 * 16)
        elif mode == "exact_hi2":
            key = match._packed3_route((2 * lw + 15) // 16 * 16)
        else:
            key = ANCHOR_KERNEL[mode]
        out[key] = out.get(key, 0) + c * (hb - 1) + wb
    return out


def want_video_launches(params, b_shape, stats):
    """``want_launches`` summed over a clip's calls (its stats grouped by
    frame and phase; the temporal block in phase 2 and in every sequential
    frame but the first)."""
    groups = {}
    for st in stats:
        groups.setdefault((st["phase"], st["frame"]), []).append(st)
    out = {}
    for (phase, frame), sts in groups.items():
        temporal = phase == "phase2" or (phase == "seq" and frame > 0)
        for k, v in want_launches(params, b_shape, sts, 1, temporal).items():
            out[k] = out.get(k, 0) + v
    return out


def run_app(phase, label, fn, want):
    """One application run on the card: every launch count set to 0 just
    before ``fn()`` and read just after, held to ``want(result)`` (each
    kernel once per wavefront step of its levels, no other kernel); prints
    each level's mode, scan ms and coherence ratio, the wall-clock and the
    peak device memory.  Returns (result, launches, wall seconds)."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.ops import match

    match.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in match.LAUNCHES.items() if v}
    expected = want(result)
    levels = [dict(level=st["level"], mode=st.get("match_mode"),
                   ms=st["ms"], coherence=st["coherence_ratio"],
                   **{k: st[k] for k in ("frame", "phase") if k in st})
              for st in result.stats]
    say(phase, run=label, wall_s=wall, levels=levels, launches=launches,
        expected_launches=expected,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if launches != {k: v for k, v in expected.items() if v}:
        fail(f"{phase} {label}: launched {launches}, expected {expected} "
             "(one per wavefront step of its levels)")
    outs = result.frames if hasattr(result, "frames") else [result.bp]
    if not all(bool(np.isfinite(x).all()) for x in outs):
        fail(f"{phase} {label}: B' is not finite")
    return result, launches, wall


def golden_calls(assets):
    """The five golden configs (``examples/make_golden.py``) as calls of the
    port's entry points: {name: (call taking the params, the params, B's
    shape, source channels, video)}."""
    from image_analogies_tpu_torch import PRESETS, modes, video_analogy

    P = lambda name, **extra: PRESETS[name].replace(**extra)
    filt = (assets["filter_a"], assets["filter_ap"], assets["filter_b"])
    frames = [assets[f"video_f{t}"] for t in range(3)]
    return {
        "tbn": (lambda p: modes.texture_by_numbers(
            assets["tbn_labels_a"], assets["tbn_texture"],
            assets["tbn_labels_b"], p), P("texture_by_numbers"),
            assets["tbn_labels_b"].shape[:2], 3, False),
        "oil": (lambda p: modes.artistic_filter(*filt, p), P("oil_filter"),
                filt[2].shape, 1, False),
        "superres": (lambda p: modes.super_resolution(
            assets["sr_sharp"], assets["sr_low"], p),
            P("super_resolution"), assets["sr_low"].shape, 1, False),
        "npr": (lambda p: modes.artistic_filter(*filt, p), P("npr_1024"),
                filt[2].shape, 1, False),
        "video": (lambda p: video_analogy(
            assets["video_filter_a"], assets["video_filter_ap"], frames, p,
            scheme="two_phase"), P("video", levels=2), frames[0].shape, 1,
            True),
    }


def rgb_superres_inputs(size, sharp_seeds=(11, 12, 13),
                        low_seeds=(21, 22, 23)):
    """RGB super-resolution inputs of side ``size``: three seeded
    ``_texture`` stripe planes of the port's generator stacked as the sharp
    exemplar, three more blurred twice as the low-res target."""
    import numpy as np

    from image_analogies_tpu_torch.ops.pyramid import blur_np
    from image_analogies_tpu_torch.utils.assets import _texture

    stack = lambda seeds: np.stack(
        [_texture(size, size, np.random.default_rng(s), "stripes")
         for s in seeds], -1)
    return stack(sharp_seeds), blur_np(blur_np(stack(low_seeds)))


def hold_card_to_cpu(phase, label, card, cpu):
    """card_vs_cpu's limits: source maps differ on < 2% of pixels and SSIM
    of the synthesized planes >= 0.99 (each frame of a clip)."""
    import numpy as np

    from image_analogies_tpu_torch.utils.ssim import ssim

    if hasattr(card, "frames_y"):
        pairs = list(zip(card.source_maps, cpu.source_maps, card.frames_y,
                         cpu.frames_y))
    else:
        pairs = [(card.source_map, cpu.source_map, card.bp_y, cpu.bp_y)]
    diffs = [float((sg != sc).mean()) for sg, sc, _, _ in pairs]
    ssims = [ssim(yg, yc) for _, _, yg, yc in pairs]
    say(phase, run=label, source_map_differs=diffs, ssim=ssims)
    if not (max(diffs) < CARD_CPU_MISMATCH_MAX
            and min(ssims) >= CARD_CPU_SSIM_MIN):
        fail(f"{phase} {label}: differs from its CPU run (source maps "
             f"{diffs}, SSIM {ssims})")


def phase_modes_small():
    """The five golden configs at the golden sizes (64^2; video 3 x 32^2,
    two levels) on inputs rebuilt by the port's ``utils/assets.py`` (8-bit
    round trip included), through ``modes.*`` and ``video_analogy`` on the
    card and on the CPU, held to card_vs_cpu's limits; then
    super_resolution on RGB sources with ``color_mode="source_rgb"`` and
    exact_hi2_2p at 64^2 (832 and 688 lanes: packed2kw_best.cu at every
    wavefront step) against its CPU run."""
    from image_analogies_tpu_torch import PRESETS, modes
    from image_analogies_tpu_torch.utils.assets import make_golden_assets

    assets = make_golden_assets()
    for name, (call, params, shape, chans, video) in golden_calls(
            assets).items():
        want = ((lambda r: want_video_launches(params, shape, r.stats))
                if video else
                (lambda r: want_launches(params, shape, r.stats, chans)))
        got, _, _ = run_app("modes_small", name, lambda: call(params), want)
        hold_card_to_cpu("modes_small", name, got,
                         call(params.replace(device="cpu")))
    sharp, low = rgb_superres_inputs(64)
    params = PRESETS["super_resolution"].replace(
        color_mode="source_rgb", match_mode="exact_hi2_2p")
    got, launches, _ = run_app(
        "modes_small", "super_resolution_rgb",
        lambda: modes.super_resolution(sharp, low, params),
        lambda r: want_launches(params, low.shape[:2], r.stats, 3))
    if set(launches) != {"packed2kw_best"}:
        fail(f"modes_small: RGB super-resolution launched {launches}")
    hold_card_to_cpu("modes_small", "super_resolution_rgb", got,
                     modes.super_resolution(sharp, low,
                                            params.replace(device="cpu")))


def phase_modes(size=1024):
    """Each application at 1024^2 with its preset's full feature width,
    cold then warm (texture_by_numbers: one level, packed2k at 352 lanes;
    artistic_filter with oil_filter; super_resolution: packed2k at 368
    lanes at level 0 and 304 at level 1; texture_synthesis from a 1024^2
    exemplar to a 1024^2 output), on ``utils/assets.make_all(1024, 0)``;
    then super_resolution on RGB sources (``rgb_superres_inputs``) with
    ``color_mode="source_rgb"`` once (packed2kw_best.cu at 832 lanes at
    level 0 and 688 at level 1).  Returns the RGB run's launches."""
    from image_analogies_tpu_torch import PRESETS, modes
    from image_analogies_tpu_torch.utils.assets import make_all

    t0 = time.perf_counter()
    x = make_all(size, 0)
    say("modes", inputs_s=time.perf_counter() - t0, size=size)
    cases = {
        "texture_by_numbers": (lambda p: modes.texture_by_numbers(
            x["tbn_labels_a"], x["tbn_texture"], x["tbn_labels_b"], p),
            PRESETS["texture_by_numbers"], 3),
        "artistic_filter": (lambda p: modes.artistic_filter(
            x["filter_a"], x["filter_ap"], x["filter_b"], p),
            PRESETS["oil_filter"], 1),
        "super_resolution": (lambda p: modes.super_resolution(
            x["sr_sharp"], x["sr_low"], p), PRESETS["super_resolution"], 1),
        "texture_synthesis": (lambda p: modes.texture_synthesis(
            x["texture"], (size, size), p), PRESETS["texture_synthesis"], 1),
    }
    for name, (call, params, chans) in cases.items():
        for label in ("cold", "warm"):
            run_app("modes", f"{name} {label}", lambda: call(params),
                    lambda r: want_launches(params, (size, size), r.stats,
                                            chans))
    del x
    sharp, low = rgb_superres_inputs(size)
    params = PRESETS["super_resolution"].replace(color_mode="source_rgb")
    _, launches, _ = run_app(
        "modes", "super_resolution_rgb",
        lambda: modes.super_resolution(sharp, low, params),
        lambda r: want_launches(params, (size, size), r.stats, 3))
    if "packed2kw_best" not in launches:
        fail(f"modes: RGB super-resolution launched {launches}")
    return launches


def phase_video(size=512):
    """``video_analogy`` with ``PRESETS["video"]`` on three 512^2 frames
    (``utils/assets.make_all(512, 0)``'s drifting blob and its filter
    pair): level 0 (262,144 rows) runs packed2k, at 336 lanes where the
    temporal block rides (phase 2, and every sequential frame but the
    first) and at 224 lanes without it; levels 1-2 the fp32 argmin (F = 93
    and, at the coarsest, 75 with the block).  two_phase cold then warm,
    then sequential once: each frame's stats, ``flicker()`` and the launch
    counts."""
    from image_analogies_tpu_torch import PRESETS, video_analogy
    from image_analogies_tpu_torch.utils.assets import make_all

    x = make_all(size, 0)
    frames = [x[f"video_f{t}"] for t in range(3)]
    params = PRESETS["video"]
    for scheme, label in (("two_phase", "cold"), ("two_phase", "warm"),
                          ("sequential", "first")):
        res, _, _ = run_app(
            "video", f"{scheme} {label}",
            lambda: video_analogy(x["filter_a"], x["filter_ap"], frames,
                                  params, scheme=scheme),
            lambda r: want_video_launches(params, frames[0].shape, r.stats))
        say("video", run=f"{scheme} {label}", flicker=res.flicker())


def phase_profile(a, ap, b, params, phase="profile"):
    """One more warm run under torch.profiler: device busy time by kernel
    name, and the busy share of the profiled wall-clock (the profiler adds
    host cost, so the share is a lower bound for the plain run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_analogies_tpu_torch import create_image_analogy

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        create_image_analogy(a, ap, b, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0_us, t1_us = e.time_range.start, e.time_range.end
        spans.append((t0_us, t1_us))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t1_us - t0_us) / 1e3, n + 1)
    if not spans:
        fail("the profiler recorded no device events")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_us, e_us in spans[1:]:
        if s_us > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_us, e_us
        else:
            cur_e = max(cur_e, e_us)
    busy = (busy + cur_e - cur_s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    # device kernels of the matching calls: one per argmin_l2 call, the
    # scan and the merge per packed_best call
    kernels = {name[:60]: n for name, (_, n) in by_name.items()
               if "argmin" in name or "scan_kernel" in name
               or "merge" in name}
    say(phase, wall_ms=wall * 1e3, device_busy_ms=busy,
        busy_share=busy / (wall * 1e3), device_kernels=len(spans),
        match_device_kernels=kernels,
        top={name[:60]: {"ms": ms, "n": n} for name, (ms, n) in top})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default), or with 'profile': one more warm run of "
                      "the main path under torch.profiler, or "
                      "'batched_profile': a profiled warm batched run at "
                      "1024^2")
    ap.add_argument("--ptxas", action="store_true",
                    help="rebuild with -Xptxas -v and print each kernel's "
                         "registers, shared memory and spills")
    ap.add_argument("--parent", metavar="DIR",
                    help="with the kernels phase: run the argmin_l2, "
                         "argmin2_l2, pertile_champions, packed3_best, "
                         "packed_best, argmin_l2_bf16, packed_champions and "
                         "the four superseded packed forms of the checkout "
                         "in DIR (e.g. the parent commit, unpacked by git "
                         "archive) on their shapes too; argmin_l2's picks "
                         "and scores must be the same bits, the others' "
                         "picks (argmin2_l2's (i1, i2)) >= 99.9%% equal but "
                         "packed_best's, and the equal picks and val bits "
                         "of all but argmin_l2 are counted")
    ap.add_argument("--bits-of", nargs=3, metavar=("KIND", "ROOT", "OUT"),
                    help=argparse.SUPPRESS)  # the child of --parent
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES + ("profile", "batched_profile") for p in phases):
        fail(f"unknown phase in {phases}", code=2)
    if not os.path.isdir(os.path.join(HERE, "image_analogies_tpu_torch")):
        fail("image_analogies_tpu_torch/ is not beside this script: run it "
             "from a checkout of the repository", code=2)
    try:
        import torch
    except ImportError:
        fail("torch is not installed", code=2)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card",
             code=2)
    if args.bits_of:
        bits_child(*args.bits_of, json.loads(args.shapes))
        return
    sys.path.insert(0, HERE)
    import image_analogies_tpu_torch  # noqa: F401  (sets TF32 off)

    if "env" in phases:
        phase_env(args.ptxas)
    rows = phase_kernels(args.parent) if "kernels" in phases else None
    path_launches = {}
    if {"main", "oracle", "profile", "exact_hi2", "rescue",
            "two_pass", "batched", "batched_profile"} & set(phases):
        a, ap_, b = load_oracle_inputs()
    if {"main", "oracle", "profile"} & set(phases):
        params, result, path_launches["main"] = phase_main(a, ap_, b)
        if "oracle" in phases:
            phase_oracle(a, ap_, b, params, result)
            del result
            phase_oracle13(params)
        if "profile" in phases:
            phase_profile(a, ap_, b, params)
    if "exact_hi2" in phases:
        path_launches["exact_hi2"] = phase_exact_hi2(a, ap_, b)
    if "rescue" in phases:
        path_launches["rescue"] = phase_probe("rescue", "scan_rescue",
                                              a, ap_, b)
    if "two_pass" in phases:
        path_launches["two_pass"] = phase_probe("two_pass", "two_pass",
                                                a, ap_, b)
    if "batched" in phases:
        path_launches["batched"] = phase_batched(a, ap_, b)
    if "batched_profile" in phases:
        from image_analogies_tpu_torch import PRESETS

        bparams = dataclasses.replace(PRESETS["npr_1024"], strategy="batched")
        run_path("batched_profile", bparams, a, ap_, b, runs=("cold",),
                 keep_levels=False)
        phase_profile(a, ap_, b, bparams, phase="batched_profile")
    if "gate" in phases:
        phase_gate()
    if "card_vs_cpu" in phases:
        path_launches["card_vs_cpu"] = phase_card_vs_cpu()
    if "modes_small" in phases:
        phase_modes_small()
    if "modes" in phases:
        path_launches["modes"] = phase_modes()
    if "video" in phases:
        phase_video()
    if not set(PHASES) <= set(phases):
        return
    # each kernel's launches from the run of its path (packed3w_best:
    # card_vs_cpu's exact_hi2 on RGB sources at patch 7; packed2kw_best:
    # the modes phase's super_resolution on RGB sources at 1024^2);
    # packed_champions (the witness of packed_best) and the four superseded
    # packed forms are on no path, so 0 (kernel_row's)
    for path, names in (("main", ("argmin_l2", "packed_best")),
                        ("modes", ("packed2kw_best",)),
                        ("exact_hi2", ("packed3_best",)),
                        ("card_vs_cpu", ("packed3w_best",)),
                        ("rescue", ("pertile_champions",)),
                        ("two_pass", ("argmin2_l2",)),
                        ("batched", ("argmin_l2_bf16",))):
        for name in names:
            rows[name]["launches"] = path_launches[path][name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
