#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port (``image_analogies_tpu_torch``) builds
and runs its main path on one NVIDIA card, and that what comes out is right.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, one line each (a failing phase exits non-zero; nothing is caught
and carried on):

1. env      — torch/CUDA versions, the card, and the build of every CUDA
              kernel from the sources in this checkout (one nvcc per
              source, all started together).
2. kernels  — each kernel against its plain PyTorch version on the card at
              the main path's shapes (seeded inputs with duplicate and
              padding rows): picks equal except inside the stated score
              band, scores within the stated tolerance; CUDA-event times
              of the kernel, the plain version, a PyTorch yardstick and the
              bound the card's peak rates allow.
3. main     — ``create_image_analogy`` with ``PRESETS["npr_1024"]`` on the
              1024^2 structured inputs of the cached oracle, cold then
              warm: per-level scan and build ms, wall-clock, kernel launch
              counts (each kernel must have launched, once per wavefront
              step of its levels).
4. oracle   — SSIM of B' and the tie-audit of all five levels' source maps
              against ``bench_cache/oracle_1024_seed7.npz``.

``--phases main,profile`` adds one more warm run under torch.profiler
(device time by kernel, device busy share); ``--ptxas`` prints each
kernel's registers, shared memory and spills.

Then the kernel table as one JSON line, the card's name and power limit,
and, as the last line, ``{"ok": true, "device": {...}}``.  Without a card,
or outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "kernels", "main", "oracle")

# peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_HBM_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12

# main-path shapes (npr_1024): the widest anti-diagonal batch of each
# kernel's levels and the DB rows it scans
ARGMIN_SHAPE = dict(m=88, npad=65536, f=68, fp=128)  # level 2 (256^2)
PACKED_SHAPE = dict(m=352, npad=1048576, lw=55)  # level 0 (1024^2)

# tolerances of kernel vs plain on the card: both are fp32 sums of the
# same terms in different orders; picks may differ only where the plain
# version's best two scores lie within SCORE_BAND of each other
ARGMIN_ATOL = 1e-5
PACKED_ATOL = 1e-5
SCORE_BAND = 2e-5

SSIM_MIN = 0.98
UNEXPLAINED_MAX = 1e-4
ORACLE_DIGEST = "8512fc90ebcc2781"


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
    """Mean ms per call by CUDA events around each call (warmed; ``flush``
    runs between calls, outside the timed window)."""
    import torch

    for _ in range(warm):
        fn()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / PEAK_HBM_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_picks(name, idx, val, ref_idx, ref_val, second, atol):
    """Scores within ``atol``; picks equal except where the plain
    version's best two scores are within SCORE_BAND."""
    import torch

    err = float((val - ref_val).abs().max())
    if not err <= atol:
        fail(f"{name}: max |score - plain| {err:.3g} > {atol}")
    diff = idx != ref_idx
    gap = (ref_val - second).abs()
    bad = diff & (gap > SCORE_BAND)
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} picks differ from the plain "
             f"version outside the {SCORE_BAND} band")
    return err, int(diff.sum())


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


def phase_kernels():
    import numpy as np
    import torch

    from image_analogies_tpu_torch.backends.cuda import (
        pack_wk, packed_shift_and_halfnorm)
    from image_analogies_tpu_torch.ops import match

    dev = torch.device("cuda", 0)
    rows = {}

    # --- argmin_l2 at level 2 (256^2): Mp=88, Npad=65536 -------------
    s = ARGMIN_SHAPE
    m, npad, f, fp = s["m"], s["npad"], s["f"], s["fp"]
    n_real = npad - 100  # 100 padding rows: zero features, +inf norms
    rng = np.random.default_rng(11)
    db = np.zeros((npad, fp), np.float32)
    db[:n_real, :f] = rng.uniform(0, 1, (n_real, f)).astype(np.float32) * .2
    db[64000] = db[1000]  # duplicate rows: ties go to the lowest index
    q = rng.uniform(0, 1, (m, f)).astype(np.float32) * 0.2
    q[0] = db[1000, :f]
    dbn = np.full((npad,), np.inf, np.float32)
    dbn[:n_real] = (db[:n_real] ** 2).sum(1)
    qd, dbd, dbnd = (torch.from_numpy(x).to(dev) for x in (q, db, dbn))
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
    b_ms, b_by = bound(4 * (m * f + npad * f + npad) + 8 * m,
                       2 * m * npad * f, PEAK_FP32_FLOP_S)
    rows["argmin_l2"] = dict(
        name="argmin_l2", route="cuda",
        source="image_analogies_tpu_torch/ops/csrc/argmin_l2.cu",
        replaces="image_analogies_tpu/ops/pallas_match.py:51",
        launches=0, max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=l_ms)
    say("kernels", kernel="argmin_l2", m=m, npad=npad, f=f,
        max_abs_err=err, picks_differing_in_band=ndiff, ms=k_ms,
        plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
    del qd, dbd, dbnd, scores, dbt

    # --- packed_best at level 0 (1024^2): Mp=352, Npad=1,048,576 -----
    s = PACKED_SHAPE
    m, npad, lw = s["m"], s["npad"], s["lw"]
    n_real = npad - 1000
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.rand((n_real, lw), generator=gen, device=dev) * 0.2
    x[900000] = x[12345]  # duplicate rows in different chunks
    live = torch.arange(lw, device=dev)
    shift, half_norm = packed_shift_and_halfnorm(x, live)
    wk, _ = pack_wk(x, shift, half_norm, live, npad)
    qv = torch.rand((m, lw), generator=gen, device=dev) * 0.2 - shift
    qv[0] = x[12345] - shift
    g1, g2, _ = match.bf16_split3(qv)
    q1, q2 = g1.to(torch.bfloat16), g2.to(torch.bfloat16)
    kp = wk.shape[1]
    o2 = 2 * lw + 3
    k_used = (o2 + 2 * lw + 15) // 16 * 16
    qa = torch.cat([q1, q1, torch.ones((m, 3), dtype=torch.bfloat16,
                                       device=dev), q2, q1,
                    torch.zeros((m, kp - o2 - 2 * lw), dtype=torch.bfloat16,
                                device=dev)], dim=1).contiguous()
    idx, val = match.packed_best(qa, wk, k_used)
    torch.cuda.synchronize()
    scores = qa.float() @ wk.float().T
    ref_idx, ref_val = match.packed_best_plain(qa, wk, k_used)
    second = torch.topk(scores, 2, dim=1).values[:, 1]
    del scores
    err, ndiff = check_picks("packed_best", idx, val, ref_idx, ref_val,
                             second, PACKED_ATOL)
    if int(idx[0]) != 12345 or int(idx.max()) >= n_real:
        fail(f"packed_best: duplicate/padding rule broken (idx[0]="
             f"{int(idx[0])}, max {int(idx.max())})")
    # the 512 MiB DB exceeds the 50 MB L2 anyway; flush it between calls
    # so no call finds the previous one's tail resident
    scratch = torch.empty((256 << 20,), dtype=torch.uint8, device=dev)
    flush = lambda: scratch.fill_(1)
    k_ms = cuda_time_ms(lambda: match.packed_best(qa, wk, k_used), reps=20,
                        flush=flush)
    p_ms = cuda_time_ms(lambda: match.packed_best_plain(qa, wk, k_used),
                        reps=3, flush=flush)
    wkt = wk.T
    l_ms = cuda_time_ms(
        lambda: torch.mm(qa, wkt, out_dtype=torch.float32).max(dim=1),
        reps=10, flush=flush)
    b_ms, b_by = bound(2 * (m * k_used + npad * k_used) + 8 * m,
                       2 * m * npad * k_used, PEAK_BF16_FLOP_S)
    rows["packed_best"] = dict(
        name="packed_best", route="cuda",
        source="image_analogies_tpu_torch/ops/csrc/packed_best.cu",
        replaces="image_analogies_tpu/ops/pallas_match.py:523",
        launches=0, max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=l_ms)
    say("kernels", kernel="packed_best", m=m, npad=npad, k_used=k_used,
        max_abs_err=err, picks_differing_in_band=ndiff, ms=k_ms,
        plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
    del wk, qa, scratch, x
    torch.cuda.empty_cache()
    return rows


def expected_launches(params, size: int):
    """Wavefront steps per kernel for a size x size run: c(h-1)+w steps a
    level, on the packed kernel where A has >= the crossover rows."""
    from image_analogies_tpu_torch.backends.cuda import (
        resolve_match_mode)
    from image_analogies_tpu_torch.ops.pyramid import num_feasible_levels

    levels = num_feasible_levels((size, size), params.levels,
                                 params.patch_size)
    c = params.patch_size // 2 + 1
    out = {"argmin_l2": 0, "packed_best": 0}
    h = size
    for _ in range(levels):
        steps = c * (h - 1) + h
        mode = resolve_match_mode(params.match_mode, h * h)
        out["packed_best" if mode == "exact_hi2_2p" else "argmin_l2"] += steps
        h = (h + 1) // 2
    return out


def phase_main():
    import torch

    from image_analogies_tpu_torch import PRESETS, create_image_analogy
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.utils.assets import (input_digest,
                                                        make_structured)

    params = PRESETS["npr_1024"]
    a, ap, b = make_structured(1024, 7)
    digest = input_digest(a, ap, b)
    if digest != ORACLE_DIGEST:
        fail(f"inputs drifted from the cached oracle ({digest} != "
             f"{ORACLE_DIGEST})")
    want = expected_launches(params, 1024)
    result = None
    launches = None
    for run in ("cold", "warm"):
        match.reset_launch_counts()
        t0 = time.perf_counter()
        result = create_image_analogy(a, ap, b, params, keep_levels=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(match.LAUNCHES)
        say("main", run=run, wall_s=wall,
            level_ms={st["level"]: st["ms"] for st in result.stats},
            level_build_ms={st["level"]: st["total_ms"] - st["ms"]
                            for st in result.stats},
            level_mode={st["level"]: st["match_mode"]
                        for st in result.stats},
            coherence={st["level"]: st["coherence_ratio"]
                       for st in result.stats},
            launches=launches, expected_launches=want,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        for name, n in launches.items():
            if n <= 0:
                fail(f"main path never launched kernel {name}")
            if n != want[name]:
                fail(f"{name}: {n} launches, expected {want[name]} (one "
                     "per wavefront step of its levels)")
    bp = result.bp_y
    if bp.shape != (1024, 1024) or not bool((bp == bp).all()):
        fail("B' is not a finite 1024x1024 plane")
    return a, ap, b, params, result, launches


def phase_oracle(a, ap, b, params, result):
    import numpy as np

    from image_analogies_tpu_torch.utils.parity import (
        audit_source_map_mismatches)
    from image_analogies_tpu_torch.utils.ssim import ssim

    oz = np.load(os.path.join(HERE, "bench_cache", "oracle_1024_seed7.npz"))
    s = ssim(result.bp_y, oz["bp_y"])
    oracle_levels = [(oz[f"bp_l{i}"], oz[f"s_l{i}"])
                     for i in range(len(result.levels))]
    t0 = time.perf_counter()
    audit = audit_source_map_mismatches(a, ap, b, params, result.levels,
                                        oracle_levels)
    frac = audit["unexplained"] / max(audit["mismatches"], 1)
    say("oracle", ssim=s, value_match=float(
        (result.source_map == oz["source_map"]).mean()),
        mismatches=audit["mismatches"], ctx_diverged=audit["ctx_diverged"],
        tie_exact=audit["tie_exact"], tie_fp=audit["tie_fp"],
        kappa_boundary=audit["kappa_boundary"],
        unexplained=audit["unexplained"], unexplained_fraction=frac,
        explained=audit["mismatch_explained_by_ties"],
        first_divergence_is_tie=audit["first_divergence_is_tie"],
        max_fp_band=audit["max_fp_band"],
        audit_s=time.perf_counter() - t0)
    if not s >= SSIM_MIN:
        fail(f"SSIM vs oracle {s:.4f} < {SSIM_MIN}")
    if not frac <= UNEXPLAINED_MAX:
        fail(f"tie-audit unexplained fraction {frac:.3g} > "
             f"{UNEXPLAINED_MAX}")


def phase_profile(a, ap, b, params):
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
    say("profile", wall_ms=wall * 1e3, device_busy_ms=busy,
        busy_share=busy / (wall * 1e3), device_kernels=len(spans),
        top={name[:60]: {"ms": ms, "n": n} for name, (ms, n) in top})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default), or with 'profile': one more warm run of "
                      "the main path under torch.profiler")
    ap.add_argument("--ptxas", action="store_true",
                    help="rebuild with -Xptxas -v and print each kernel's "
                         "registers, shared memory and spills")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES + ("profile",) for p in phases):
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
    sys.path.insert(0, HERE)
    import image_analogies_tpu_torch  # noqa: F401  (sets TF32 off)

    if "env" in phases:
        phase_env(args.ptxas)
    rows = phase_kernels() if "kernels" in phases else None
    if {"main", "oracle", "profile"} & set(phases):
        a, ap_, b, params, result, launches = phase_main()
        if rows is not None:
            for name, n in launches.items():
                rows[name]["launches"] = n
        if "oracle" in phases:
            phase_oracle(a, ap_, b, params, result)
        if "profile" in phases:
            phase_profile(a, ap_, b, params)
    if not set(PHASES) <= set(phases):
        return
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
