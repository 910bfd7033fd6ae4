"""Command-line interface of the port (counterpart of the JAX package's
``cli.py`` ``run``, ``video``, ``sweep`` and ``eval``).

    python -m image_analogies_tpu_torch.cli run --mode filter --a A.png \\
        --ap Ap.png --b B.png --out Bp.png --levels 3 --kappa 5
    python -m image_analogies_tpu_torch.cli video --a A.png --ap Ap.png \\
        --frames f0.png f1.png f2.png --out-dir out/
    python -m image_analogies_tpu_torch.cli sweep --ap sharp.png \\
        --b low.png --kappas 0,0.5,1 --out-dir sweep/
    python -m image_analogies_tpu_torch.cli eval --a out.png --b ref.png

Every engine command runs on the card (``--device cuda``, the default)
and exits non-zero where there is none; ``--device cpu`` runs the plain
versions of the kernels on the CPU.  Output paths (and sweep's and eval's
JSON records) go to stdout, each level's stats to stderr as JSON lines.
The engine flags are those whose fields the port has; ROADMAP lists the
JAX package's others under the items that bring their fields.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from image_analogies_tpu_torch.config import (
    EXPERIMENTAL_MATCH_MODES,
    PARITY_MATCH_MODES,
    PRESETS,
    STRATEGIES,
    AnalogyParams,
    experimental_enabled,
)
from image_analogies_tpu_torch.models import modes
from image_analogies_tpu_torch.models.analogy import resolve_device
from image_analogies_tpu_torch.models.video import SCHEMES, video_analogy
from image_analogies_tpu_torch.utils.imageio import load_image, save_image
from image_analogies_tpu_torch.utils.ssim import ssim

MODES = ("filter", "texture_by_numbers", "super_resolution",
         "texture_synthesis")
# each run mode's preset
_BASE = {"filter": "oil_filter", "texture_by_numbers": "texture_by_numbers",
         "super_resolution": "super_resolution",
         "texture_synthesis": "texture_synthesis"}


def _add_engine_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the synthesis runs: the card (default; "
                        "exits non-zero where there is none) or the CPU "
                        "(the kernels' plain versions)")
    p.add_argument("--levels", type=int, default=None)
    p.add_argument("--kappa", type=float, default=None)
    p.add_argument("--patch-size", type=int, default=None)
    p.add_argument("--coarse-patch-size", type=int, default=None)
    p.add_argument("--strategy", choices=STRATEGIES, default=None,
                   help="scan strategy: auto = wavefront (oracle parity); "
                        "batched: a scan row a step, approximate; "
                        "exact/rowwise: per-pixel validation scans")
    mm_choices = PARITY_MATCH_MODES
    if experimental_enabled():
        mm_choices = mm_choices + EXPERIMENTAL_MATCH_MODES
    p.add_argument("--match-mode", choices=mm_choices, default=None,
                   help="wavefront anchor scan (auto: exact_hi2_2p on "
                        "large levels, exact_hi below); the non-parity "
                        "probes appear only with IA_EXPERIMENTAL=1")
    p.add_argument("--refine-passes", type=int, default=None,
                   help="batched strategy: left-propagation refinement "
                        "passes per scan row")
    p.add_argument("--no-remap", action="store_true",
                   help="disable luminance remapping")
    p.add_argument("--no-gaussian", action="store_true",
                   help="unweighted (flat) neighborhood distances")


def _params_from_args(args, base: AnalogyParams) -> AnalogyParams:
    kw = {"device": args.device}
    for name in ("levels", "kappa", "patch_size", "coarse_patch_size",
                 "strategy", "match_mode", "refine_passes"):
        v = getattr(args, name)
        if v is not None:
            kw[name] = v
    if args.no_remap:
        kw["remap_luminance"] = False
    if args.no_gaussian:
        kw["gaussian_weights"] = False
    return base.replace(**kw)


def _emit_stats(stats) -> None:
    for st in stats:
        print(json.dumps(st, sort_keys=True), file=sys.stderr)


def cmd_run(args) -> int:
    params = _params_from_args(args, PRESETS[_BASE[args.mode]])
    ap = load_image(args.ap)
    if args.mode == "texture_synthesis":
        shape = tuple(int(x) for x in args.out_shape.split("x"))
        res = modes.texture_synthesis(ap, shape, params, seed=args.seed)
    elif args.mode == "super_resolution":
        # A is A' degraded; only A' and B are read
        res = modes.super_resolution(ap, load_image(args.b), params,
                                     blur_passes=args.blur_passes)
    else:
        a, b = load_image(args.a), load_image(args.b)
        fn = (modes.artistic_filter if args.mode == "filter"
              else modes.texture_by_numbers)
        res = fn(a, ap, b, params)
    save_image(args.out, res.bp)
    _emit_stats(res.stats)
    print(args.out)
    return 0


def cmd_video(args) -> int:
    a, ap = load_image(args.a), load_image(args.ap)
    frames = [load_image(f) for f in args.frames]
    params = _params_from_args(args, PRESETS["video"])
    if args.temporal_weight is not None:
        params = params.replace(temporal_weight=args.temporal_weight)
    res = video_analogy(a, ap, frames, params, scheme=args.scheme)
    os.makedirs(args.out_dir, exist_ok=True)
    outs = []
    for t, frame in enumerate(res.frames):
        path = os.path.join(args.out_dir, f"frame_{t:04d}.png")
        save_image(path, frame)
        outs.append(path)
    _emit_stats(res.stats)
    print("\n".join(outs))
    return 0


def cmd_sweep(args) -> int:
    """Kappa sweep of one mode: each kappa's output written, with its SSIM
    against ``--ref`` when given."""
    ap_img = load_image(args.ap)
    b = load_image(args.b)
    a = load_image(args.a) if args.a else None
    ref = load_image(args.ref) if args.ref else None
    base = PRESETS[_BASE[args.mode]]
    os.makedirs(args.out_dir, exist_ok=True)
    for k in (float(x) for x in args.kappas.split(",")):
        params = _params_from_args(args, base).replace(kappa=k)
        if args.mode == "super_resolution":
            res = modes.super_resolution(ap_img, b, params,
                                         blur_passes=args.blur_passes)
        else:
            res = modes.artistic_filter(a, ap_img, b, params)
        out = os.path.join(args.out_dir, f"kappa_{k:g}.png")
        save_image(out, res.bp)
        rec = {"kappa": k, "out": out}
        if ref is not None:
            rec["ssim_vs_ref"] = round(ssim(np.clip(res.bp, 0, 1), ref), 4)
        print(json.dumps(rec))
    return 0


def cmd_eval(args) -> int:
    x = load_image(args.a)
    y = load_image(args.b)
    print(json.dumps({"ssim": ssim(x, y)}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="image_analogies_tpu_torch",
        description="Image Analogies (Hertzmann et al. 2001) on one NVIDIA "
                    "card, PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="single-image analogy")
    run.add_argument("--mode", choices=MODES, default="filter")
    run.add_argument("--a", help="unfiltered source image A")
    run.add_argument("--ap", required=True, help="filtered source image A'")
    run.add_argument("--b", help="target image B")
    run.add_argument("--out", required=True)
    run.add_argument("--out-shape", default="256x256",
                     help="HxW for texture_synthesis")
    run.add_argument("--blur-passes", type=int, default=2,
                     help="degradation strength for super_resolution")
    run.add_argument("--seed", type=int, default=None,
                     help="texture_synthesis: noise seed for varied outputs "
                          "(omit for the deterministic degenerate analogy)")
    _add_engine_flags(run)
    run.set_defaults(fn=cmd_run)

    vid = sub.add_parser("video", help="video analogy over frames")
    vid.add_argument("--a", required=True)
    vid.add_argument("--ap", required=True)
    vid.add_argument("--frames", nargs="+", required=True)
    vid.add_argument("--out-dir", required=True)
    vid.add_argument("--scheme", choices=SCHEMES, default="two_phase")
    vid.add_argument("--temporal-weight", type=float, default=None)
    _add_engine_flags(vid)
    vid.set_defaults(fn=cmd_video)

    sw = sub.add_parser("sweep", help="kappa sweep over one mode")
    sw.add_argument("--mode", choices=("filter", "super_resolution"),
                    default="super_resolution")
    sw.add_argument("--a", help="unfiltered source (filter mode)")
    sw.add_argument("--ap", required=True)
    sw.add_argument("--b", required=True)
    sw.add_argument("--kappas", default="0,0.5,1,2,5,10",
                    help="comma-separated kappa values")
    sw.add_argument("--out-dir", required=True)
    sw.add_argument("--ref", default=None,
                    help="reference image for per-kappa SSIM")
    sw.add_argument("--blur-passes", type=int, default=2)
    _add_engine_flags(sw)
    sw.set_defaults(fn=cmd_sweep)

    ev = sub.add_parser("eval", help="SSIM between two images")
    ev.add_argument("--a", required=True)
    ev.add_argument("--b", required=True)
    ev.set_defaults(fn=cmd_eval)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd in ("run", "sweep"):
        required = {"filter": ("a", "b"), "texture_by_numbers": ("a", "b"),
                    "super_resolution": ("b",), "texture_synthesis": ()}
        missing = [k for k in required[args.mode]
                   if getattr(args, k, None) is None]
        if missing:
            parser.error(
                f"--{' --'.join(missing)} required for mode {args.mode}")
    if hasattr(args, "device"):
        try:
            resolve_device(args.device)
        except RuntimeError as e:  # no card and no --device cpu
            print(f"{parser.prog}: {e} (on the command line: --device "
                  "cpu)", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
