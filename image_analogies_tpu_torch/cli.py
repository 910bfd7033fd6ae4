"""Command-line interface of the port (counterpart of the JAX package's
``cli.py``: every subcommand but ``bench``).

    python -m image_analogies_tpu_torch.cli run --mode filter --a A.png \\
        --ap Ap.png --b B.png --out Bp.png --levels 3 --kappa 5
    python -m image_analogies_tpu_torch.cli video --a A.png --ap Ap.png \\
        --frames f0.png f1.png f2.png --out-dir out/
    python -m image_analogies_tpu_torch.cli sweep --ap sharp.png \\
        --b low.png --kappas 0,0.5,1 --out-dir sweep/
    python -m image_analogies_tpu_torch.cli eval --a out.png --b ref.png
    python -m image_analogies_tpu_torch.cli tune --dry-run
    python -m image_analogies_tpu_torch.cli warmup --size 256x256 \
        --compile-cache-dir /path/to/libs
    python -m image_analogies_tpu_torch.cli catalog build --a A.png \
        --ap Ap.png --b B.png --dir cat/
    python -m image_analogies_tpu_torch.cli run --a A.png --ap Ap.png \
        --b B.png --out Bp.png --ann-prefilter --catalog-dir cat/
    python -m image_analogies_tpu_torch.cli serve --selftest 12
    python -m image_analogies_tpu_torch.cli serve --http 8080 \
        --journal journal/ --archive archive/
    python -m image_analogies_tpu_torch.cli journal inspect journal/
    python -m image_analogies_tpu_torch.cli why <idempotency-key> \
        --root journal/
    python -m image_analogies_tpu_torch.cli metrics run.jsonl
    python -m image_analogies_tpu_torch.cli archive inspect archive/
    python -m image_analogies_tpu_torch.cli chaos --selftest
    python -m image_analogies_tpu_torch.cli soak --seed 7 --json
    python -m image_analogies_tpu_torch.cli report run.jsonl --json
    python -m image_analogies_tpu_torch.cli trace run.jsonl -o trace.json
    python -m image_analogies_tpu_torch.cli top --once --from-archive archive/
    python -m image_analogies_tpu_torch.cli blackbox journal/ --all

Every engine command runs on the card (``--device cuda``, the default)
and exits non-zero where there is none; ``--device cpu`` runs the plain
versions of the kernels on the CPU.  Output paths (and sweep's and eval's
JSON records) go to stdout, each level's stats to stderr as JSON lines.
The engine flags are those whose fields the port has, the driver's
surroundings included (``--no-level-sync``, ``--level-retries``,
``--dispatch-timeout-s``, ``--checkpoint-dir``, ``--resume-from-level``,
``--log-path``, ``--save-levels``, ``--profile-dir``, ``--devcache-bytes``)
and the run's own counters and tuning (``--metrics``, ``--metrics-port``:
a loopback ``/metrics`` + ``/healthz`` for the command's duration,
``--shape-buckets``, ``--compile-cache-dir``), the two-stage ANN matcher and the exemplar
catalog (``--ann-prefilter``, ``--catalog-dir``, ``--catalog-host-bytes``),
the matcher (``--backend cpu``: the host oracle, with ``--no-ann`` its
brute force), and the mesh (``--db-shards``, ``--data-shards``; a world starts from
torchrun's environment or ``--coordinator``, ``--num-processes``,
``--process-id``, and only rank 0 writes outputs and prints):

    torchrun --nproc-per-node 2 -m image_analogies_tpu_torch.cli run \
        --a A.png --ap Ap.png --b B.png --out Bp.png --db-shards 2

ROADMAP lists the JAX package's others under the items that bring their
fields.  ``tune`` sweeps the main path's two kernels' launch geometry on
the card and persists verified winners to the tune store
(``tune/autotune.py``; ``--knob ann``: the ANN slab, by audited
syntheses, reported and never stored); ``warmup`` builds every kernel library a target size's levels
launch into the library directory (``tune/warmup.py``); ``catalog``
builds, inspects, warms and prunes the exemplar catalog (``catalog/``),
with the JAX package's outputs and exit codes, and takes no engine flags;
``serve --selftest N`` drives the serving path (``serve/``) with a
synthetic load, on the ``oil_filter`` preset as in the JAX package, and
``serve --http PORT`` serves it on loopback (``--journal DIR``: the
write-ahead request journal; ``--archive DIR``: the telemetry archive)
until interrupted.  ``journal``, ``why``, ``metrics`` and ``archive``
are the offline readers of the journal, the run log and the archive, with
the JAX package's flags, outputs and exit codes; they take no engine
flags and need no card.  ``chaos`` runs the seeded fault drills
(``chaos/``: ``--selftest`` or ``--plan FILE``, ``--kinds``, ``--seed``,
``--json``) on ``--device``, with the JAX package's rendering and exit
codes 0, 1 and 2.  ``soak`` replays a seeded traffic trace against an
autoscaling fleet with chaos armed (``soak/``: ``--spec``, ``--full``,
``--seed``, ``--workdir``, ``--json``) on ``--device``, serving on the host
oracle as the JAX soak does; exit 0 on a green gate, 1 on a red one, 2 on
a bad or missing spec.  ``report``, ``trace``, ``top`` and ``blackbox``
read a run log (``obs/report.py``, ``obs/export.py``), a serving front's
``/timeline`` or ``/tenants`` (or an archive: ``--from-archive``) and a
journal directory's flight-recorder dumps, with the JAX package's flags,
outputs and exit codes; they take no engine flags and need no card.
ROADMAP lists ``bench`` under the port's own benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
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
from image_analogies_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_writer,
)
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
    p.add_argument("--backend", choices=("cuda", "cpu"), default=None,
                   help="the matcher: cuda (default; the card's kernels on "
                        "--device) or cpu (the host oracle: NumPy and the "
                        "cKDTree, which ignores --device)")
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
    p.add_argument("--no-level-sync", action="store_true",
                   help="do not wait for each level's device work (one wait "
                        "at the final fetch; per-level stats report "
                        "enqueue_ms, and the next level's inputs are "
                        "prefetched on a helper thread); --level-retries "
                        "forces the wait back on")
    p.add_argument("--level-retries", type=int, default=None,
                   help="retry a level this many times on a transient "
                        "fault (an injected fault, a watchdog timeout, a "
                        "CUDA out-of-memory error)")
    p.add_argument("--dispatch-timeout-s", type=float, default=None,
                   help="watchdog deadline around each level's dispatch: a "
                        "wedged level raises a transient WatchdogTimeout "
                        "(recovered by --level-retries) instead of hanging "
                        "the run; 0 = inline, no watchdog")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save each level's (B', source map) here")
    p.add_argument("--resume-from-level", type=int, default=None,
                   help="with --checkpoint-dir: load every level coarser "
                        "than this one from its checkpoint")
    p.add_argument("--log-path", default=None,
                   help="append one JSON record per level (and the retry, "
                        "watchdog and resume events) to this file")
    p.add_argument("--save-levels", dest="save_levels_dir", default=None,
                   metavar="DIR",
                   help="write each level's B' plane as DIR/level_XX.png")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of each synthesis "
                        "here")
    p.add_argument("--devcache-bytes", type=int, default=None,
                   help="device-upload cache byte budget "
                        "(utils/devcache.py; IA_DEVCACHE_BYTES overrides)")
    p.add_argument("--metrics", action="store_true",
                   help="run-scoped observability (obs/): per-run metrics "
                        "registry (launch, compile, memory, pipeline "
                        "counters) + span records; with --log-path the "
                        "run_id-stamped records and the run_end snapshot "
                        "go to the log.  Off by default and near-zero-cost "
                        "when off")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="bind a loopback /metrics + /healthz exposition "
                        "server (obs/live.py) for the duration of the "
                        "command, scraping the LIVE registry mid-run "
                        "(implies --metrics; 0 = ephemeral port, printed "
                        "to stderr)")
    p.add_argument("--shape-buckets", action="store_true",
                   help="bucket per-level DB row counts (tune/buckets.py: "
                        "the scan copies pad with rows that cannot win) and "
                        "the batched strategy's query rows, so different "
                        "sizes share launch plans; IA_SHAPE_BUCKETS "
                        "overrides either way")
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="directory of the kernel libraries nvcc builds — "
                        "they survive process restarts (pairs with "
                        "`warmup`; IA_COMPILE_CACHE_DIR overrides)")
    p.add_argument("--no-ann", action="store_true",
                   help="disable the cKDTree index (the cpu backend's "
                        "brute force)")
    p.add_argument("--ann-prefilter", action="store_true",
                   help="two-stage matcher (wavefront and batched): a "
                        "PCA-projected prefilter ranks the whole exemplar "
                        "DB and the exact fp32 distance re-scores only the "
                        "top-m slab (tune: ann_top_m / ann_proj_dims).  "
                        "Gated by a first-use parity probe per device and "
                        "strategy; refused or unsupported requests run the "
                        "exact matcher (ann.fallback_exact)")
    p.add_argument("--catalog-dir", default=None, metavar="DIR",
                   help="exemplar catalog root (catalog/): with "
                        "--ann-prefilter each level's sealed PCA basis "
                        "(`catalog build`) is read from here instead of "
                        "computed; IA_CATALOG_DIR overrides")
    p.add_argument("--catalog-host-bytes", type=int, default=None,
                   help="host-RAM catalog tier byte budget "
                        "(IA_CATALOG_HOST_BYTES overrides; default 256 MiB)")
    p.add_argument("--db-shards", type=int, default=None,
                   help="shard the patch DB over this many ranks of a "
                        "running world (torchrun, or --coordinator)")
    p.add_argument("--data-shards", type=int, default=None,
                   help="video: shard frames over this many ranks "
                        "(two_phase); one image (wavefront): split each "
                        "anti-diagonal's queries over them "
                        "(query-parallel; with one db shard, one device's "
                        "bits)")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: the coordinator host:port "
                        "(parallel/distributed.py); torchrun's environment "
                        "serves with no flags at all")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _params_from_args(args, base: AnalogyParams) -> AnalogyParams:
    kw = {"device": args.device}
    for name in ("levels", "kappa", "patch_size", "coarse_patch_size",
                 "strategy", "match_mode", "refine_passes", "level_retries",
                 "dispatch_timeout_s", "checkpoint_dir", "resume_from_level",
                 "log_path", "save_levels_dir", "profile_dir", "db_shards",
                 "data_shards", "backend"):
        v = getattr(args, name)
        if v is not None:
            kw[name] = v
    if args.devcache_bytes is not None:
        kw["devcache_max_bytes"] = args.devcache_bytes
    if args.no_level_sync:
        kw["level_sync"] = False
    if args.no_remap:
        kw["remap_luminance"] = False
    if args.no_gaussian:
        kw["gaussian_weights"] = False
    if args.metrics or args.metrics_port is not None:
        kw["metrics"] = True
    if args.shape_buckets:
        kw["shape_buckets"] = True
    if args.compile_cache_dir is not None:
        kw["compile_cache_dir"] = args.compile_cache_dir
    if args.catalog_dir is not None:
        kw["catalog_dir"] = args.catalog_dir
    if args.catalog_host_bytes is not None:
        kw["catalog_host_bytes"] = args.catalog_host_bytes
    if args.ann_prefilter:
        kw["ann_prefilter"] = True
    if args.no_ann:
        kw["use_ann"] = False
    return base.replace(**kw)


@contextlib.contextmanager
def _maybe_metrics_server(args):
    """Bind the obs/live exposition server for the command's duration
    when --metrics-port was given; no-op (and no obs.live import)
    otherwise."""
    port = getattr(args, "metrics_port", None)
    if port is None:
        yield None
        return
    from image_analogies_tpu_torch.obs import live as obs_live

    httpd = obs_live.start_http_server(port)
    bound = httpd.server_address[1]
    print(f"metrics: http://127.0.0.1:{bound}/metrics "
          f"(and /healthz)", file=sys.stderr)
    try:
        yield httpd
    finally:
        obs_live.stop_http_server(httpd)


def _emit_stats(stats) -> None:
    for st in stats:
        print(json.dumps(st, sort_keys=True), file=sys.stderr)


def cmd_run(args) -> int:
    params = _params_from_args(args, PRESETS[_BASE[args.mode]])
    ap = load_image(args.ap)
    with _maybe_metrics_server(args):
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
    if is_writer():
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
    with _maybe_metrics_server(args):
        res = video_analogy(a, ap, frames, params, scheme=args.scheme)
    if not is_writer():
        return 0
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
    with _maybe_metrics_server(args):
        for k in (float(x) for x in args.kappas.split(",")):
            params = _params_from_args(args, base).replace(kappa=k)
            if args.mode == "super_resolution":
                res = modes.super_resolution(ap_img, b, params,
                                             blur_passes=args.blur_passes)
            else:
                res = modes.artistic_filter(a, ap_img, b, params)
            if not is_writer():
                continue
            out = os.path.join(args.out_dir, f"kappa_{k:g}.png")
            save_image(out, res.bp)
            rec = {"kappa": k, "out": out}
            if ref is not None:
                rec["ssim_vs_ref"] = round(
                    ssim(np.clip(res.bp, 0, 1), ref), 4)
            print(json.dumps(rec))
    return 0


def cmd_eval(args) -> int:
    x = load_image(args.a)
    y = load_image(args.b)
    print(json.dumps({"ssim": ssim(x, y)}))
    return 0


def cmd_tune(args) -> int:
    """Measured tuning of the main path's two kernels' launch geometry
    (tune/autotune.py): candidates timed on the card, every candidate's
    picks and scores checked bit-identical, verified winners persisted to
    the tune store.  --dry-run prints the plan and never touches CUDA."""
    from image_analogies_tpu_torch.tune import autotune

    cands = (tuple(int(x) for x in args.candidates.split(","))
             if args.candidates else None)
    if not args.dry_run and args.device == "cuda":
        import torch

        torch.cuda.init()  # so that the keys carry the card's name
    plan = autotune.build_plan(knob=args.knob, reps=args.reps,
                               candidates=cands, store=args.store,
                               device=args.device, rows=args.rows)
    if args.dry_run:
        print(json.dumps(plan, indent=2, sort_keys=True))
        return 0
    res = autotune.run_plan(plan, persist=not args.no_persist)
    print(json.dumps(res, indent=2, sort_keys=True))
    return 0 if res["all_verified"] else 1


def cmd_serve(args) -> int:
    """The serving scheduler (serve/): micro-batching with admission
    control, deadlines and graceful degradation.  ``--selftest N`` replays
    a synthetic load against a sequential baseline and prints the latency
    and throughput summary (its JSON on stderr); exit 0 iff no request
    errored and every full-fidelity response equals its singleton's bits.
    ``--http PORT`` binds the loopback front end (serve/http.py) and
    serves until interrupted; ``--journal DIR`` arms the write-ahead
    request journal, ``--archive DIR`` (or ``IA_ARCHIVE_DIR``) the
    telemetry archive."""
    from image_analogies_tpu_torch.serve import loadgen
    from image_analogies_tpu_torch.serve.types import ServeConfig

    params = _params_from_args(args, PRESETS["oil_filter"])
    # --deadline-ms: a scalar is the server-wide default; a comma list
    # ("none" entries undeadlined) is cycled per selftest request
    deadline_ms = None
    if args.deadline_ms is not None:
        parts = [None if p.lower() in ("none", "") else float(p)
                 for p in str(args.deadline_ms).split(",")]
        deadline_ms = parts[0] if len(parts) == 1 else tuple(parts)
    warmup_sizes = ()
    if args.warmup:
        warmup_sizes = tuple(
            tuple(int(x) for x in chunk.split("x"))
            for chunk in args.warmup.split(","))
    cfg = ServeConfig(
        params=params,
        queue_depth=args.queue_depth,
        batch_window_ms=args.batch_window_ms,
        max_batch=args.max_batch,
        workers=args.workers,
        default_deadline_s=(deadline_ms / 1e3
                            if isinstance(deadline_ms, (int, float))
                            else None),
        degrade=not args.no_degrade,
        request_retries=args.request_retries,
        warmup_sizes=warmup_sizes,
        deadline_ordering=not args.no_deadline_ordering,
        breaker_threshold=args.breaker_threshold,
        cost_persist=not args.no_cost_persist,
        slo_target=args.slo_target,
        slo_fast_window_s=args.slo_fast_window_s,
        slo_slow_window_s=args.slo_slow_window_s,
        journal_dir=args.journal,
        batch_engine=not args.no_batch_engine,
        ledger=not args.no_ledger,
    )
    if args.selftest is not None:
        flash_crowd = (loadgen.parse_flash_crowd(args.flash_crowd)
                       if args.flash_crowd else None)
        with _maybe_metrics_server(args):
            summary = loadgen.selftest(cfg, args.selftest, seed=args.seed,
                                       deadline_ms=deadline_ms,
                                       zipf=args.zipf, styles=args.styles,
                                       flash_crowd=flash_crowd)
        print(loadgen.render(summary))
        print(json.dumps(summary, sort_keys=True), file=sys.stderr)
        return 0 if (summary["errors"] == 0
                     and summary["bit_identical"]) else 1

    if args.http is None:
        print("serve: pass --selftest N or --http PORT", file=sys.stderr)
        return 2

    from image_analogies_tpu_torch.obs import archive as obs_archive
    from image_analogies_tpu_torch.obs import ceilings as obs_ceilings
    from image_analogies_tpu_torch.obs import timeline as obs_timeline
    from image_analogies_tpu_torch.serve.http import serve_http
    from image_analogies_tpu_torch.serve.server import Server

    with Server(cfg) as srv:
        # single-server deployment: arm the temporal plane and run its
        # own background sampler so /timeline is live
        tl = obs_timeline.arm()
        # witness + watchdog planes ride the same sampler as feeders
        archive_root = args.archive or os.environ.get("IA_ARCHIVE_DIR")
        if archive_root:
            obs_archive.arm(root=archive_root)
        obs_ceilings.arm()
        tl.start_sampler(interval_s=1.0)
        httpd = serve_http(srv, args.http)
        # the bound port (--http 0 binds an ephemeral one)
        print(f"serving on http://127.0.0.1:{httpd.server_address[1]} "
              f"(POST /v1/analogy, GET /healthz, GET /metrics, "
              f"GET /timeline, GET /tenants, GET /archive/stats); "
              f"Ctrl-C to drain+exit", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.shutdown()
            obs_ceilings.disarm()
            if archive_root:
                obs_archive.disarm()
            obs_timeline.disarm()
    return 0


def cmd_fleet(args) -> int:
    """Router + worker fleet (serve/fleet.py, serve/router.py): N servers
    behind a consistent-hash router with health-gated spillover and
    dead-worker journal handoff, in this process or as ``worker_main``
    children (``--transport subprocess``), each on ``--device``.
    ``--selftest N`` routes the synthetic load through the ring and exits
    0 iff no request errored and every response equals its singleton's
    bits (JSON summary on stderr); ``--http PORT`` binds the loopback
    front end on the fleet (0 = an ephemeral port, printed) and serves
    until interrupted."""
    from image_analogies_tpu_torch.serve.types import FleetConfig, ServeConfig

    params = _params_from_args(args, PRESETS["oil_filter"])
    scfg = ServeConfig(
        params=params,
        queue_depth=args.queue_depth,
        batch_window_ms=args.batch_window_ms,
        max_batch=args.max_batch,
        workers=args.workers,
        cost_persist=False,
        journal_dir=None,  # per-worker dirs derive from journal_root
    )
    # --policy FILE > --autoscale > static fleet.  With bare --autoscale
    # the declarative defaults apply except the ceiling, which --size
    # already names: the fleet breathes between the policy floor and the
    # size the operator asked for.
    policy = None
    if args.policy:
        from image_analogies_tpu_torch.serve.policy import ControlPolicy
        policy = ControlPolicy.load(args.policy)
    elif args.autoscale:
        from image_analogies_tpu_torch.serve.policy import ControlPolicy
        policy = ControlPolicy(max_workers=max(1, args.size))
    fcfg = FleetConfig(
        serve=scfg,
        size=args.size,
        journal_root=args.journal,
        wire=args.wire,
        transport=args.transport,
        policy=policy,
    )

    if args.selftest is not None:
        from image_analogies_tpu_torch.serve import loadgen

        flash_crowd = (loadgen.parse_flash_crowd(args.flash_crowd)
                       if args.flash_crowd else None)
        with _maybe_metrics_server(args):
            summary = loadgen.fleet_selftest(fcfg, args.selftest,
                                             seed=args.seed,
                                             zipf=args.zipf,
                                             styles=args.styles,
                                             flash_crowd=flash_crowd)
        print(loadgen.render_fleet(summary))
        print(json.dumps(summary, sort_keys=True), file=sys.stderr)
        return 0 if (summary["errors"] == 0
                     and summary["bit_identical"]) else 1

    if args.http is None:
        print("fleet: pass --selftest N or --http PORT", file=sys.stderr)
        return 2

    from image_analogies_tpu_torch.serve.fleet import Fleet
    from image_analogies_tpu_torch.serve.http import serve_fleet_http

    with Fleet(fcfg) as fl:
        httpd = serve_fleet_http(fl, args.http)
        print(f"fleet of {len(fl.workers)} ({fcfg.transport}) serving on "
              f"http://127.0.0.1:{httpd.server_address[1]} "
              f"(POST /v1/analogy, GET /healthz, GET /metrics, "
              f"GET /timeline, GET /tenants); Ctrl-C to drain+exit",
              flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.shutdown()
    return 0


def cmd_chaos(args) -> int:
    """Seeded fault-injection drills (chaos/): run a workload under a
    fault plan on ``--device`` and assert full recovery — bit-identical
    output, no lost or hung request, and injection counters reconciled
    against the recovery counters they should have caused.  --selftest
    runs one canonical drill per drill kind plus the schedule-determinism
    check; --plan FILE replays a custom ChaosPlan JSON.  Exit 0 when every
    drill passed, 1 when one failed, 2 on a bad plan or no mode."""
    from image_analogies_tpu_torch.chaos import ChaosPlan
    from image_analogies_tpu_torch.chaos import runner as chaos_runner

    if args.selftest:
        kinds = args.kinds.split(",") if args.kinds else None
        result = chaos_runner.selftest(seed=args.seed, kinds=kinds,
                                       device=args.device)
    elif args.plan:
        try:
            plan = ChaosPlan.load(args.plan)
        except (OSError, ValueError) as exc:
            print(f"chaos: bad plan {args.plan}: {exc}", file=sys.stderr)
            return 2
        report = chaos_runner.run_drill(plan, device=args.device)
        report.setdefault("kind", plan.name or "plan")
        result = {"seed": plan.seed, "ok": report["ok"],
                  "reports": [report]}
    else:
        print("chaos: pass --plan FILE or --selftest", file=sys.stderr)
        return 2
    print(chaos_runner.render(result))
    if args.json:
        print(json.dumps(result, sort_keys=True, default=str),
              file=sys.stderr)
    return 0 if result["ok"] else 1


def cmd_report(args) -> int:
    """Analyze a run-log JSONL (obs/report.py): per-level timing
    breakdown, counter totals, retry/coherence summaries, compile/HBM
    sections, manifest.  --json prints the analyze() dict per run."""
    from image_analogies_tpu_torch.obs import report as obs_report

    if not os.path.exists(args.log):
        print(f"report: no such log: {args.log}", file=sys.stderr)
        return 2
    if args.json:
        print(obs_report.report_json(args.log))
    else:
        print(obs_report.report(args.log))
    return 0


def cmd_top(args) -> int:
    """Live terminal cockpit over a serving front end's ``/timeline``
    endpoint: QPS, windowed p50/p95, queue depth, breaker states, HBM
    peak, and anomaly flags per worker (obs/timeline.py renders; this
    command only fetches and redraws).  ``--once`` prints a single
    frame and exits — the CI-friendly mode tier-1 drives against a
    live selftest server.  ``--tenants`` switches to the per-style
    view over ``/tenants``: top-K tenants by request count with QPS,
    p95, cost share, and degrade/retry burden (obs/ledger.py)."""
    import time as _time
    import urllib.error
    import urllib.request

    from image_analogies_tpu_torch.obs import timeline as obs_timeline

    if getattr(args, "from_archive", None):
        # Replay archived history into the cockpit: every sealed
        # timeline document becomes one frame, no server needed.
        from image_analogies_tpu_torch.obs import archive as obs_archive

        ar = obs_archive.TelemetryArchive(args.from_archive)
        frames = ar.history("timeline")
        if not frames:
            print(f"top: no archived timeline documents under "
                  f"{args.from_archive}", file=sys.stderr)
            return 2
        if args.once:
            print(obs_timeline.render_cockpit(frames[-1]))
            return 0
        try:
            for doc in frames:
                sys.stdout.write(
                    "\x1b[2J\x1b[H" + obs_timeline.render_cockpit(doc)
                    + "\n")
                sys.stdout.flush()
                _time.sleep(args.interval)
        except KeyboardInterrupt:
            pass
        return 0

    if args.tenants:
        from image_analogies_tpu_torch.obs import ledger as obs_ledger

        t_url = args.url.rstrip("/") + "/tenants"

        def fetch_tenants():
            with urllib.request.urlopen(t_url, timeout=5) as resp:
                return json.loads(resp.read().decode())

        if args.once:
            try:
                doc = fetch_tenants()
            except (OSError, ValueError, urllib.error.URLError) as exc:
                print(f"top: cannot fetch {t_url}: {exc}",
                      file=sys.stderr)
                return 2
            sys.stdout.write(obs_ledger.render_tenants(doc))
            return 0
        try:
            while True:
                try:
                    frame = obs_ledger.render_tenants(fetch_tenants())
                except (OSError, ValueError,
                        urllib.error.URLError) as exc:
                    frame = f"top: cannot fetch {t_url}: {exc}\n"
                sys.stdout.write("\x1b[2J\x1b[H" + frame)
                sys.stdout.flush()
                _time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0

    url = args.url.rstrip("/") + "/timeline"
    if args.window is not None:
        url += f"?window={args.window:g}"
    health_url = args.url.rstrip("/") + "/healthz"

    def fetch():
        with urllib.request.urlopen(url, timeout=5) as resp:
            return json.loads(resp.read().decode())

    def fleet_line():
        # Best-effort elastic-fleet banner from /healthz: live size vs
        # configured, the control plane's last verdict, and how to
        # attribute it.  Single-server fronts (no "control" section)
        # and fetch failures render nothing.
        try:
            with urllib.request.urlopen(health_url, timeout=5) as resp:
                doc = json.loads(resp.read().decode())
        except (OSError, ValueError, urllib.error.URLError):
            return ""
        ctl = doc.get("control") if isinstance(doc, dict) else None
        if not isinstance(ctl, dict):
            return ""
        line = (f"fleet: size={ctl.get('size', '?')}"
                f"/{doc.get('configured_size', '?')} "
                f"autoscale={'on' if ctl.get('autoscale') else 'off'}")
        last = ctl.get("last_verdict")
        if isinstance(last, dict):
            line += (f"  last={last.get('verdict', '?')}"
                     f"({last.get('cause', '?')}) "
                     f"{last.get('worker', '?')} "
                     f"— ia why ctl-{last.get('verdict', '?')}-"
                     f"{last.get('worker', '?')}")
        return line + "\n"

    if args.once:
        try:
            doc = fetch()
        except (OSError, ValueError, urllib.error.URLError) as exc:
            print(f"top: cannot fetch {url}: {exc}", file=sys.stderr)
            return 2
        print(fleet_line() + obs_timeline.render_cockpit(doc))
        return 0
    try:
        while True:
            try:
                frame = (fleet_line()
                         + obs_timeline.render_cockpit(fetch()))
            except (OSError, ValueError,
                    urllib.error.URLError) as exc:
                frame = f"top: cannot fetch {url}: {exc}"
            # ANSI clear+home, then one full frame: flicker-free enough
            # for a 1 Hz cockpit without a curses dependency
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_trace(args) -> int:
    """Convert a run-log JSONL into a Chrome/Perfetto trace.json
    (obs/export.py) for chrome://tracing / ui.perfetto.dev."""
    from image_analogies_tpu_torch.obs import export as obs_export

    if not os.path.exists(args.log):
        print(f"trace: no such log: {args.log}", file=sys.stderr)
        return 2
    res = obs_export.export_trace(args.log, args.out)
    print(f"{args.out}: {res['events']} events from "
          f"{res['records']} records")
    return 0


def cmd_soak(args) -> int:
    """Trace-driven soak (soak/): replay a seeded TraceSpec against an
    autoscaling fleet with chaos armed the whole run, then gate on the
    duration-emergent invariants — zero-loss accounting, audit-subset
    bit-identity, the DDSketch p99.9 bound, zero ceiling alarms, and
    journals bounded under autocompaction.  Exits non-zero on a red
    gate (exit 1; 2 on a bad or missing spec); failing verdicts name an
    `ia why`-linkable culprit key.  The fleet runs on ``--device`` and
    serves on the host oracle, as the JAX soak does: no kernel launches."""
    from image_analogies_tpu_torch.soak import driver as soak_driver
    from image_analogies_tpu_torch.soak import invariants as soak_invariants
    from image_analogies_tpu_torch.soak import trace as soak_trace

    if args.spec:
        try:
            spec = soak_trace.TraceSpec.load(args.spec)
        except (OSError, ValueError) as exc:
            print(f"soak: bad spec {args.spec}: {exc}", file=sys.stderr)
            return 2
    elif args.full:
        spec = soak_trace.full_spec(seed=args.seed)
    else:
        spec = soak_trace.smoke_spec(seed=args.seed)
    result = soak_driver.run(spec, workdir=args.workdir, device=args.device)
    sys.stdout.write(soak_invariants.render(result))
    if args.workdir:
        print(f"artifacts kept under {args.workdir} — runbook: "
              f"ia why <culprit> --root "
              f"{result['facts'].get('journal_root')}; "
              f"ia archive inspect {result['facts'].get('archive_root')}")
    if args.json:
        print(json.dumps(result, sort_keys=True, default=str),
              file=sys.stderr)
    return 0 if result["ok"] else 1


def cmd_blackbox(args) -> int:
    """Render the flight-recorder dumps (obs/recorder.py) sealed into a
    journal directory on a death path — the last N records before a
    process death, breaker trip, or watchdog timeout.  Default shows the
    newest dump; ``--all`` walks every dump chronologically.  A dump
    whose integrity seal fails is reported as damaged, never rendered."""
    from image_analogies_tpu_torch.obs import recorder as obs_recorder

    if not os.path.isdir(args.dir):
        print(f"blackbox: no such directory {args.dir}", file=sys.stderr)
        return 2
    dumps = obs_recorder.list_dumps(args.dir)
    if not dumps:
        print(f"blackbox: no dumps in {args.dir}", file=sys.stderr)
        return 1
    if not args.all:
        dumps = dumps[-1:]
    docs = []
    for path in dumps:
        try:
            docs.append((path, obs_recorder.load_dump(path)))
        except ValueError as exc:
            print(f"blackbox: {exc}", file=sys.stderr)
            return 2
    if args.json:
        print(json.dumps([doc for _path, doc in docs], indent=2,
                         sort_keys=True))
        return 0
    for path, doc in docs:
        print(f"# {os.path.basename(path)}")
        sys.stdout.write(obs_recorder.render_dump(doc, last=args.last))
    return 0


def cmd_warmup(args) -> int:
    """Build and load every kernel library a target size's levels launch
    (tune/warmup.py): with --compile-cache-dir a later process finds them
    there."""
    from image_analogies_tpu_torch.tune import warmup as tune_warmup

    params = _params_from_args(args, PRESETS["oil_filter"])
    h, w = (int(x) for x in args.size.split("x"))
    eh = ew = None
    if args.exemplar_size:
        eh, ew = (int(x) for x in args.exemplar_size.split("x"))
    res = tune_warmup.warmup(params, h, w, exemplar_height=eh,
                             exemplar_width=ew, seed=args.seed)
    print(json.dumps(res, sort_keys=True))
    return 0


def cmd_catalog(args) -> int:
    """Exemplar catalog tooling (catalog/), the JAX package's ``catalog``
    command: ``build`` precomputes one style's per-level feature pyramid
    and its ANN bases and seals them under the root; ``inspect`` is a
    read-only summary of the store; ``warm`` pre-stages entries into this
    process's host-RAM tier; ``gc`` prunes tmp litter, quarantined files
    and over-budget bytes."""
    from image_analogies_tpu_torch.catalog import build as catalog_build
    from image_analogies_tpu_torch.catalog import store as catalog_store
    from image_analogies_tpu_torch.catalog import tiers as catalog_tiers

    if args.action == "build":
        a = load_image(args.a)
        ap = load_image(args.ap)
        target = load_image(args.b) if args.b else None
        kw = {}
        for name in ("levels", "kappa", "patch_size", "coarse_patch_size"):
            v = getattr(args, name)
            if v is not None:
                kw[name] = v
        if args.no_remap:
            kw["remap_luminance"] = False
        rep = catalog_build.build_style(a, ap, PRESETS["oil_filter"].replace(
            **kw), root_dir=args.dir, target=target)
        print(json.dumps(rep, sort_keys=True))
        return 0

    if not os.path.isdir(args.dir):
        print(f"catalog: no such directory {args.dir}", file=sys.stderr)
        return 2

    if args.action == "inspect":
        info = catalog_store.stats(args.dir)
        if args.json:
            print(json.dumps(info, indent=2, sort_keys=True))
        else:
            print(f"catalog {args.dir}: {len(info['styles'])} style(s), "
                  f"{info['entries']} entries, "
                  f"{info['bytes']} bytes"
                  + (f", {info['corrupt']} quarantined"
                     if info["corrupt"] else ""))
            for style in catalog_store.list_styles(args.dir):
                ents = catalog_store.list_entries(args.dir, style)
                print(f"  {style}  {len(ents)} entries / "
                      f"{sum(n for _, n in ents)} bytes")
        return 0

    if args.action == "warm":
        styles = ([args.style] if args.style
                  else catalog_store.list_styles(args.dir))
        total = {"styles": 0, "entries": 0, "bytes": 0}
        for style in styles:
            rep = catalog_tiers.warm(style, root_dir=args.dir)
            if rep["entries"]:
                total["styles"] += 1
                total["entries"] += rep["entries"]
                total["bytes"] += rep["bytes"]
        print(json.dumps(total, sort_keys=True))
        return 0

    # gc (argparse admits no other action)
    keep = set(args.keep.split(",")) if args.keep else None
    rep = catalog_store.gc(args.dir, keep=keep, max_bytes=args.max_bytes,
                           purge_corrupt=args.purge_corrupt)
    print(json.dumps(rep, sort_keys=True))
    return 0


def cmd_journal(args) -> int:
    """Write-ahead journal tooling (serve/journal.py).  ``inspect`` is a
    read-only summary of a journal directory — segments, per-state
    request counts, incomplete and poisoned keys; ``compact`` rewrites
    it to its minimal equivalent (final state per key, finished input
    spills dropped, response spills kept for dedupe)."""
    from image_analogies_tpu_torch.serve.journal import RequestJournal

    if not os.path.isdir(args.dir):
        print(f"journal: no such directory {args.dir}", file=sys.stderr)
        return 2
    jr = RequestJournal(args.dir)
    if args.action == "inspect":
        info = jr.inspect()
        if args.json:
            print(json.dumps(info, indent=2, sort_keys=True))
        else:
            print(f"journal {info['path']}: {info['requests']} requests "
                  f"in {info['segments']} segment(s), {info['lines']} lines"
                  + (f", {info['corrupt_segments']} quarantined file(s)"
                     if info["corrupt_segments"] else ""))
            for st, n in sorted(info["states"].items()):
                print(f"  {st:<12} {n}")
            if info["incomplete"]:
                print(f"  incomplete   {', '.join(info['incomplete'])}")
            if info["poisoned"]:
                print(f"  poisoned     {', '.join(info['poisoned'])}")
        return 0
    if args.action == "compact":
        try:
            out = jr.compact()
        except RuntimeError as exc:  # journal active (live appender)
            print(f"journal: {exc}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(out, indent=2, sort_keys=True))
        else:
            print(f"compacted {args.dir}: {out['segments']} segment(s) / "
                  f"{out['lines']} lines -> 1 segment / "
                  f"{out['after']['lines']} lines "
                  f"({out['dropped_lines']} dropped)")
        return 0
    print(f"journal: unknown action {args.action}", file=sys.stderr)
    return 2


def cmd_why(args) -> int:
    """Request forensics (``ia why <idem-key>``): merge the write-ahead
    journal(s) under --root — a single ``ia serve --journal`` dir or an
    ``ia fleet --journal`` root with per-worker subdirs — with the
    sealed decision log into one ordered causal chain for a single
    request: which worker admitted it, every control-plane verdict
    (degrade, shed, spill, requeue, poison, handoff re-chain) with its
    cause, the cost vector, and the terminal state."""
    from image_analogies_tpu_torch.serve import journal as serve_journal

    if not os.path.isdir(args.root):
        print(f"why: no such directory {args.root}", file=sys.stderr)
        return 2
    doc = serve_journal.reconstruct(args.idem, args.root)
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True, default=str))
    else:
        sys.stdout.write(serve_journal.render_why(doc))
    return 0 if doc.get("found") else 2


def cmd_metrics(args) -> int:
    """Prometheus exposition of a run log's latest metrics snapshot
    (obs/live.py).  Without --port, render once to stdout.  With --port,
    bind a loopback sidecar exposition server that re-reads the log per
    scrape — live telemetry for runs that did not pass --metrics-port
    themselves (the log is the transport)."""
    from image_analogies_tpu_torch.obs import live as obs_live

    if not os.path.exists(args.log):
        print(f"metrics: no such log: {args.log}", file=sys.stderr)
        return 2
    if args.port is None:
        snap = obs_live.snapshot_from_log(args.log)
        if snap is None:
            print(f"metrics: no run_end snapshot in {args.log}",
                  file=sys.stderr)
            return 1
        sys.stdout.write(obs_live.render_prometheus(snap))
        return 0

    log = args.log
    httpd = obs_live.start_http_server(
        args.port,
        snapshot_fn=lambda: obs_live.snapshot_from_log(log),
        health_fn=lambda: obs_live.health_from_log(log))
    bound = httpd.server_address[1]
    print(f"metrics sidecar on http://127.0.0.1:{bound}/metrics "
          f"(and /healthz), re-reading {log} per scrape; Ctrl-C to exit",
          file=sys.stderr)
    try:
        httpd._ia_thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        obs_live.stop_http_server(httpd)
    return 0


def cmd_archive(args) -> int:
    """Offline reader over a durable telemetry archive (obs/archive.py).
    ``inspect`` summarizes the sealed store — segments, bytes, witnessed
    record kinds, quarantined files; ``replay`` reconstructs the final
    ``/timeline`` + ``/tenants`` documents exactly as the server last
    published them (the round-trip contract); ``diff`` compares two
    archives series-by-series — the before/after-an-incident view."""
    from image_analogies_tpu_torch.obs import archive as obs_archive

    def _open(root):
        if not os.path.isdir(root):
            print(f"archive: no such directory {root}", file=sys.stderr)
            return None
        return obs_archive.TelemetryArchive(root)

    if args.action == "diff":
        a = _open(args.a)
        b = _open(args.b)
        if a is None or b is None:
            return 2
        d = obs_archive.diff_replays(a.replay(), b.replay())
        if args.json:
            print(json.dumps(d, indent=2, sort_keys=True))
        else:
            print(obs_archive.render_diff(d))
        return 0

    ar = _open(args.root)
    if ar is None:
        return 2

    if args.action == "inspect":
        info = ar.stats()
        rep = ar.replay()
        info["kinds"] = rep["kinds"]
        info["span"] = rep["span"]
        if args.json:
            print(json.dumps(info, indent=2, sort_keys=True))
            return 0
        span = rep["span"]
        dur = (span[1] - span[0]
               if span[0] is not None and span[1] is not None else 0.0)
        print(f"archive {args.root}: {info['segments']} segment(s) + "
              f"{info['summary_segments']} summary, {info['bytes']} bytes"
              + (f", {info['quarantined']} quarantined"
                 if info["quarantined"] else ""))
        kinds = ", ".join(f"{k}={n}"
                          for k, n in sorted(rep["kinds"].items()))
        print(f"  span: {dur:.1f}s  kinds: {kinds or '(empty)'}")
        return 0

    if args.action == "replay":
        from image_analogies_tpu_torch.obs import ledger as obs_ledger
        from image_analogies_tpu_torch.obs import timeline as obs_timeline

        rep = ar.replay()
        if args.json:
            print(json.dumps(rep, indent=2, sort_keys=True))
            return 0
        if rep["timeline"] is None and rep["tenants"] is None:
            print("archive: no witnessed timeline/tenants documents",
                  file=sys.stderr)
            return 2
        if rep["timeline"] is not None:
            print(obs_timeline.render_cockpit(rep["timeline"]))
        if rep["tenants"] is not None:
            print(obs_ledger.render_tenants(rep["tenants"],
                                            title="tenants (archived)"))
        if rep["decisions"]:
            print(f"decisions witnessed: {len(rep['decisions'])}  latest: "
                  + json.dumps(rep["decisions"][-1], sort_keys=True))
        if rep["anomalies"]:
            print(f"anomalies witnessed: {len(rep['anomalies'])}")
        return 0

    print(f"archive: unknown action {args.action}", file=sys.stderr)
    return 2


def _add_catalog_parser(sub) -> None:
    """``catalog build | inspect | warm | gc``: no engine flags (``build``
    runs the host feature builds; the rest is file io)."""
    ct = sub.add_parser("catalog",
                        help="exemplar catalog tooling: precompute a "
                             "style's sealed per-level feature pyramids and "
                             "ANN bases (build), summarize the store "
                             "(inspect), pre-stage entries into host RAM "
                             "(warm), or prune it (gc)")
    ct_sub = ct.add_subparsers(dest="action", required=True)
    cb = ct_sub.add_parser("build",
                           help="precompute + seal one style's per-level "
                                "features and ANN bases under the root")
    cb.add_argument("--a", required=True, help="unfiltered source A")
    cb.add_argument("--ap", required=True, help="filtered source A'")
    cb.add_argument("--b", default=None,
                    help="remap anchor target: with luminance remap on, "
                         "A's planes depend on the target's luminance "
                         "stats — pass the (first) target so the sealed "
                         "entries match its requests (omit to anchor on "
                         "A itself)")
    cb.add_argument("--dir", required=True, help="catalog root directory")
    cb.add_argument("--levels", type=int, default=None)
    cb.add_argument("--kappa", type=float, default=None)
    cb.add_argument("--patch-size", type=int, default=None)
    cb.add_argument("--coarse-patch-size", type=int, default=None)
    cb.add_argument("--no-remap", action="store_true",
                    help="disable luminance remapping")
    ci = ct_sub.add_parser("inspect",
                           help="read-only store summary: styles, "
                                "entries, bytes, quarantined files")
    ci.add_argument("dir", help="catalog root directory")
    ci.add_argument("--json", action="store_true",
                    help="machine-readable output")
    cw = ct_sub.add_parser("warm",
                           help="pre-stage sealed entries into this "
                                "process's host-RAM tier")
    cw.add_argument("dir", help="catalog root directory")
    cw.add_argument("--style", default=None,
                    help="warm one style (default: every style on disk)")
    cg = ct_sub.add_parser("gc",
                           help="prune the disk tier: tmp litter always, "
                                "quarantined files with --purge-corrupt, "
                                "oldest entries past --max-bytes")
    cg.add_argument("dir", help="catalog root directory")
    cg.add_argument("--max-bytes", type=int, default=None,
                    help="prune oldest-first until the store fits")
    cg.add_argument("--keep", default=None,
                    help="comma-separated styles exempt from pruning")
    cg.add_argument("--purge-corrupt", action="store_true",
                    help="also remove quarantined .corrupt files "
                         "(they are evidence; default keeps them)")
    ct.set_defaults(fn=cmd_catalog)


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

    tn = sub.add_parser("tune",
                        help="measured launch-geometry tuning: sweep the "
                             "main path's two kernels' candidate plans on "
                             "the card, verify bit-identical picks and "
                             "scores, persist winners to the tune store "
                             "(.ia_tune.json)")
    tn.add_argument("--dry-run", action="store_true",
                    help="print the sweep plan JSON; no device work")
    tn.add_argument("--knob", choices=("chunks", "stages", "all", "ann"),
                    default="all",
                    help="chunks: chunks_per_sm of packed2k and argmin_l2; "
                         "stages: packed2k's ring_stages; all: both (the "
                         "packed2k sweep over their product); ann: the ANN "
                         "slab ann_top_m by full two-stage syntheses, each "
                         "audited against an exact run; reported, never "
                         "stored (not part of all)")
    tn.add_argument("--store", default=None,
                    help="tune store path (default: repo .ia_tune.json, "
                         "IA_TUNE_STORE overrides)")
    tn.add_argument("--reps", type=int, default=5,
                    help="timed reps per candidate (min-of-k)")
    tn.add_argument("--candidates", default=None,
                    help="comma-separated values of the one swept knob "
                         "(overrides its default grid)")
    tn.add_argument("--rows", type=int, default=0,
                    help="DB rows of every sweep (default: the main path's "
                         "headline N), for a short or CPU run")
    tn.add_argument("--no-persist", action="store_true",
                    help="measure + verify but do not write the store")
    tn.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the card (default), or the CPU: the kernels' "
                         "plain versions, which have no geometry "
                         "(plumbing only)")
    tn.set_defaults(fn=cmd_tune)

    sv = sub.add_parser("serve",
                        help="serving scheduler: micro-batched dispatch "
                             "with admission control, per-request "
                             "deadlines and graceful degradation "
                             "(--selftest N for the synthetic load, "
                             "--http PORT for the loopback front end)")
    sv.add_argument("--selftest", type=int, default=None, metavar="N",
                    help="replay N synthetic mixed-shape requests against "
                         "a sequential baseline and print the latency/"
                         "throughput/degradation summary")
    sv.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="bind the loopback-only stdlib HTTP front end "
                         "(0 = an ephemeral port, printed) and serve "
                         "until interrupted")
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--queue-depth", type=int, default=32,
                    help="admission bound; requests beyond it are "
                         "Rejected(queue_full) immediately")
    sv.add_argument("--batch-window-ms", type=float, default=4.0,
                    help="coalescing window once a batch leader is held")
    sv.add_argument("--max-batch", type=int, default=8)
    sv.add_argument("--workers", type=int, default=2)
    sv.add_argument("--deadline-ms", default=None,
                    help="default per-request deadline; expired before "
                         "dispatch -> cancelled, unmeetable -> degraded "
                         "(fewer levels / coarser patch), flagged in the "
                         "response.  With --selftest a comma list (e.g. "
                         "300,none) cycles per request")
    sv.add_argument("--no-degrade", action="store_true",
                    help="never degrade: unmeetable deadlines run full "
                         "fidelity anyway (only already-expired requests "
                         "time out)")
    sv.add_argument("--request-retries", type=int, default=1,
                    help="transparent retries around each dispatch on "
                         "transient device faults")
    sv.add_argument("--warmup", default=None, metavar="SIZES",
                    help="comma-separated HxW list (e.g. 64x64,128x128): "
                         "build and load every kernel library their "
                         "levels launch before accepting traffic")
    sv.add_argument("--no-deadline-ordering", action="store_true",
                    help="pop batch leaders FIFO instead of earliest-"
                         "deadline-first")
    sv.add_argument("--breaker-threshold", type=int, default=5,
                    help="consecutive dispatch failures that trip the "
                         "worker circuit breaker; 0 disables")
    sv.add_argument("--no-cost-persist", action="store_true",
                    help="do not persist the learned degrade cost rate to "
                         "the tune store at shutdown")
    sv.add_argument("--slo-target", type=float, default=0.99,
                    help="SLO: target fraction of deadlined requests that "
                         "meet their deadline (obs/slo.py)")
    sv.add_argument("--slo-fast-window-s", type=float, default=60.0)
    sv.add_argument("--slo-slow-window-s", type=float, default=600.0)
    sv.add_argument("--journal", default=None, metavar="DIR",
                    help="write-ahead request journal directory: every "
                         "request is recorded at admit and on each state "
                         "transition; on startup the server replays it — "
                         "finished requests dedupe exactly-once, "
                         "interrupted ones re-enqueue, poison ones shed "
                         "(omit to disable; disabled costs nothing)")
    sv.add_argument("--no-batch-engine", action="store_true",
                    help="dispatch every batch member as its own engine "
                         "call instead of one lane-engine call a "
                         "compatible batch (batch/engine.py); the bits "
                         "are the same either way")
    sv.add_argument("--no-ledger", action="store_true",
                    help="disarm the tenant metering plane (per-request "
                         "cost vectors, heavy hitters)")
    sv.add_argument("--zipf", type=float, default=None, metavar="S",
                    help="selftest load: draw requests over --styles "
                         "synthetic styles with Zipf(S)-skewed frequency")
    sv.add_argument("--styles", type=int, default=0,
                    help="style count for --zipf (default 8)")
    sv.add_argument("--flash-crowd", default=None, metavar="T0,DUR,MULT",
                    help="selftest arrivals: Poisson arrivals whose rate "
                         "multiplies by MULT inside [T0, T0+DUR) seconds, "
                         "deterministic from --seed")
    sv.add_argument("--archive", default=None, metavar="DIR",
                    help="durable telemetry archive root: closed timeline "
                         "windows, tenant cost vectors, decision records "
                         "and anomaly events stream to sealed append-only "
                         "segments under DIR (also via IA_ARCHIVE_DIR; "
                         "inspect offline with `archive`)")
    _add_engine_flags(sv)
    sv.set_defaults(fn=cmd_serve)

    fp = sub.add_parser("fleet",
                        help="router + worker fleet: consistent-hash "
                             "affinity on the batch key, health-gated "
                             "spillover, dead-worker journal handoff "
                             "(--selftest N for the routed synthetic "
                             "load, --http PORT for the loopback front "
                             "end)")
    fp.add_argument("--selftest", type=int, default=None, metavar="N",
                    help="route N synthetic mixed-shape requests through "
                         "the ring against a sequential baseline; gates "
                         "on zero errors and bit-identity")
    fp.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="bind the loopback-only HTTP front end on the "
                         "fleet (fleet-view /healthz, routed "
                         "/v1/analogy; 0 = an ephemeral port, printed) "
                         "and serve until interrupted")
    fp.add_argument("--size", type=int, default=2,
                    help="number of Server workers (in-process, or "
                         "children with --transport subprocess)")
    fp.add_argument("--wire", choices=("auto", "binary", "json"),
                    default="auto",
                    help="router<->worker hop encoding: auto/binary "
                         "negotiate the IAF2 raw-f32 frame, json forces "
                         "the fallback list transport")
    fp.add_argument("--transport", choices=("inproc", "subprocess"),
                    default="inproc",
                    help="worker isolation: inproc keeps each worker an "
                         "in-process Server (zero-copy hops); subprocess "
                         "spawns each as a real OS process on a loopback "
                         "port — SIGKILL-able, journal lock holds a real "
                         "foreign pid, hops speak IAF2 over HTTP; each "
                         "child runs on --device, a CUDA context of its "
                         "own on the card")
    fp.add_argument("--journal", default=None, metavar="DIR",
                    help="journal ROOT: each worker journals under "
                         "DIR/<wid>; a dead worker's directory is handed "
                         "to its replacement for exactly-once replay")
    fp.add_argument("--queue-depth", type=int, default=32)
    fp.add_argument("--batch-window-ms", type=float, default=4.0)
    fp.add_argument("--max-batch", type=int, default=8)
    fp.add_argument("--workers", type=int, default=1,
                    help="worker THREADS per server (the fleet dimension "
                         "is --size)")
    fp.add_argument("--zipf", type=float, default=None, metavar="S",
                    help="selftest load: Zipf(S)-skewed per-style "
                         "frequency over --styles synthetic styles "
                         "(see serve --zipf)")
    fp.add_argument("--styles", type=int, default=0,
                    help="style count for --zipf (default 8)")
    fp.add_argument("--flash-crowd", default=None, metavar="T0,DUR,MULT",
                    help="selftest arrival shape: Poisson arrivals whose "
                         "rate multiplies by MULT inside [T0, T0+DUR) "
                         "seconds (see serve --flash-crowd)")
    fp.add_argument("--autoscale", action="store_true",
                    help="arm the elastic control plane with the default "
                         "declarative policy (--size becomes the "
                         "ceiling): the fleet starts at the policy floor "
                         "and the reconcile loop grows/shrinks it on "
                         "observed queue depth, SLO burn, and breaker "
                         "state — every verdict lands in the decision "
                         "plane (`why ctl-<verdict>-<wid>`)")
    fp.add_argument("--policy", default=None, metavar="FILE",
                    help="ControlPolicy JSON file (implies autoscaling): "
                         "min/max workers, pressure/calm thresholds, "
                         "hysteresis window counts, per-direction "
                         "cooldowns; unknown keys are rejected")
    fp.add_argument("--seed", type=int, default=0)
    _add_engine_flags(fp)
    fp.set_defaults(fn=cmd_fleet)

    ch = sub.add_parser("chaos",
                        help="seeded fault-injection drills: run a "
                             "workload under a fault plan and assert "
                             "bit-identical recovery, no lost requests, "
                             "and injection/recovery counter "
                             "reconciliation")
    ch.add_argument("--plan", default=None, metavar="FILE",
                    help="ChaosPlan JSON (seed + per-site fault rules) "
                         "to replay against the matching drill workload")
    ch.add_argument("--selftest", action="store_true",
                    help="one canonical drill per kind "
                         "(transient, oom, latency, corrupt, crash, "
                         "process_death, fleet_death, "
                         "fleet_death_subprocess, batch_partial, "
                         "devcache_tier, ann_corrupt, archive_torn, "
                         "flash_crowd) plus "
                         "the same-seed schedule-determinism check")
    ch.add_argument("--kinds", default=None,
                    help="comma-separated fault-kind subset for "
                         "--selftest (default: all)")
    ch.add_argument("--seed", type=int, default=0,
                    help="plan seed — same seed, same fault schedule")
    ch.add_argument("--json", action="store_true",
                    help="also print the full machine-readable report "
                         "to stderr")
    ch.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the drills run: the card (default; exits "
                         "non-zero where there is none) or the CPU (the "
                         "kernels' plain versions)")
    ch.set_defaults(fn=cmd_chaos)

    wu = sub.add_parser("warmup",
                        help="build every kernel library a target "
                             "resolution's levels launch (pairs with "
                             "--compile-cache-dir and --shape-buckets)")
    wu.add_argument("--size", default="256x256", help="target B HxW")
    wu.add_argument("--exemplar-size", default=None,
                    help="A/A' HxW (default: same as --size)")
    wu.add_argument("--seed", type=int, default=0)
    _add_engine_flags(wu)
    wu.set_defaults(fn=cmd_warmup)
    _add_catalog_parser(sub)
    mx = sub.add_parser("metrics",
                        help="Prometheus text exposition of a run log's "
                             "metrics: once to stdout, or as a loopback "
                             "sidecar server with --port")
    mx.add_argument("log", help="run-log JSONL (--log-path output)")
    mx.add_argument("--port", type=int, default=None, metavar="PORT",
                    help="bind a sidecar /metrics + /healthz server that "
                         "re-reads the log per scrape (0 = ephemeral)")
    mx.set_defaults(fn=cmd_metrics)

    av = sub.add_parser("archive",
                        help="durable telemetry archive tooling: "
                             "summarize the sealed store (inspect), "
                             "reconstruct the final cockpit + tenants "
                             "documents (replay), or compare two "
                             "archives series-by-series (diff)")
    av_sub = av.add_subparsers(dest="action", required=True)
    ai = av_sub.add_parser("inspect",
                           help="read-only store summary: segments, "
                                "bytes, witnessed record kinds, "
                                "quarantined files")
    ai.add_argument("root", help="archive root directory")
    ai.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ai.set_defaults(fn=cmd_archive)
    av_rp = av_sub.add_parser("replay",
                              help="reconstruct the final /timeline + "
                                   "/tenants documents from the sealed "
                                   "segments and render them as the "
                                   "cockpit would have")
    av_rp.add_argument("root", help="archive root directory")
    av_rp.add_argument("--json", action="store_true",
                       help="full replay document (timeline, tenants, "
                            "kinds, decisions, anomalies, span) as JSON")
    av_rp.set_defaults(fn=cmd_archive)
    ad = av_sub.add_parser("diff",
                           help="compare two archives' replayed state: "
                                "per-series deltas (p50/p95/p99/p999, "
                                "counts), tenants present in only one, "
                                "witnessed-kind counts")
    ad.add_argument("a", help="baseline archive root")
    ad.add_argument("b", help="comparison archive root")
    ad.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ad.set_defaults(fn=cmd_archive)

    jr = sub.add_parser("journal",
                        help="write-ahead request journal tooling: "
                             "inspect a journal directory or compact it "
                             "to its minimal equivalent")
    jr.add_argument("action", choices=("inspect", "compact"),
                    help="inspect: read-only per-state summary; compact: "
                         "rewrite to one segment of final states "
                         "(finished input spills dropped, response "
                         "spills kept for dedupe); compact refuses "
                         "while a live server holds the journal")
    jr.add_argument("dir", help="journal directory (ia serve --journal)")
    jr.add_argument("--json", action="store_true",
                    help="machine-readable output")
    jr.set_defaults(fn=cmd_journal)

    wy = sub.add_parser("why",
                        help="request forensics: replay the journal(s) + "
                             "decision log into one ordered causal chain "
                             "for a single idempotency key (admit -> "
                             "verdicts with causes -> cost vector -> "
                             "terminal state)")
    wy.add_argument("idem", help="idempotency key (the journal key; "
                                 "derived content keys appear in "
                                 "`ia journal inspect`)")
    wy.add_argument("--root", required=True, metavar="DIR",
                    help="journal directory (ia serve --journal) or "
                         "fleet journal ROOT (ia fleet --journal) — "
                         "worker subdirs and decisions.jsonl are "
                         "discovered automatically")
    wy.add_argument("--json", action="store_true",
                    help="machine-readable reconstruction (events with "
                         "ts/worker/op, decisions, cost vectors, chain)")
    wy.set_defaults(fn=cmd_why)

    # the readers (report, trace, top, blackbox) take no engine flags and
    # need no card
    rp = sub.add_parser("report",
                        help="analyze a run-log JSONL (--log-path output): "
                             "per-level timing, counters, compile/HBM, "
                             "manifest")
    rp.add_argument("log", help="path to the run-log JSONL")
    rp.add_argument("--json", action="store_true",
                    help="machine-readable output: the analyze() dict per "
                         "run (levels, counters, compile, hbm)")
    rp.set_defaults(fn=cmd_report)

    tr = sub.add_parser("trace",
                        help="convert a run-log JSONL into a Chrome/"
                             "Perfetto trace.json (host/device/compile "
                             "tracks)")
    tr.add_argument("log", help="path to the run-log JSONL")
    tr.add_argument("-o", "--out", default="trace.json",
                    help="output trace path (default: trace.json)")
    tr.set_defaults(fn=cmd_trace)

    tp = sub.add_parser("top",
                        help="live terminal cockpit over a serving front "
                             "end's /timeline endpoint (QPS, windowed "
                             "p50/p95, queue depth, breakers, HBM, "
                             "anomalies per worker)")
    tp.add_argument("--url", default="http://127.0.0.1:8080",
                    help="serving front end base URL "
                         "(default: http://127.0.0.1:8080)")
    tp.add_argument("--interval", type=float, default=1.0,
                    help="refresh period in seconds (default: 1.0)")
    tp.add_argument("--window", type=float, default=None,
                    help="downsampling tier to read (e.g. 10 or 60; "
                         "default: the finest)")
    tp.add_argument("--once", action="store_true",
                    help="print one frame and exit (CI mode)")
    tp.add_argument("--tenants", action="store_true",
                    help="per-style view over /tenants instead of the "
                         "worker cockpit: top-K tenants by request "
                         "count with QPS, p95, cost share, and degrade/"
                         "retry burden (space-saving heavy hitters)")
    tp.add_argument("--from-archive", default=None, metavar="ROOT",
                    help="replay a durable telemetry archive instead of "
                         "scraping a live server: each sealed timeline "
                         "document renders as one cockpit frame at "
                         "--interval pace (--once shows only the final "
                         "frame)")
    tp.set_defaults(fn=cmd_top)

    # soak takes no engine flags (the driver builds its own fleet config),
    # only --device
    sk = sub.add_parser("soak",
                        help="seeded trace-driven soak: replay a "
                             "TraceSpec against an autoscaling fleet "
                             "with chaos armed throughout and gate on "
                             "duration-emergent invariants (zero loss, "
                             "audit bit-identity, p99.9 bound, zero "
                             "ceiling alarms, bounded journals)")
    sk.add_argument("--spec", default=None, metavar="FILE",
                    help="TraceSpec JSON (seed, Zipf styles, diurnal + "
                         "flash-crowd shape, session/priority mixes, "
                         "chaos plan); default is the built-in smoke")
    sk.add_argument("--full", action="store_true",
                    help="run the bench-profile soak (hundreds of "
                         "requests) instead of the smoke")
    sk.add_argument("--seed", type=int, default=7,
                    help="seed for the built-in specs — same seed, "
                         "byte-identical request stream")
    sk.add_argument("--workdir", default=None, metavar="DIR",
                    help="persist journals/archive/catalog under DIR "
                         "(default: swept tempdir) so a red gate's "
                         "culprits stay reconstructable via ia why")
    sk.add_argument("--json", action="store_true",
                    help="also print the full machine-readable result "
                         "to stderr")
    sk.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the fleet runs: the card (default; exits "
                         "non-zero where there is none) or the CPU; it "
                         "serves on the host oracle either way")
    sk.set_defaults(fn=cmd_soak)

    bb = sub.add_parser("blackbox",
                        help="render sealed flight-recorder dumps from a "
                             "journal directory (the last records before "
                             "a process death / breaker trip / watchdog "
                             "timeout)")
    bb.add_argument("dir", help="journal directory holding "
                                "blackbox-*.json dumps")
    bb.add_argument("--all", action="store_true",
                    help="render every dump (default: newest only)")
    bb.add_argument("--last", type=int, default=0,
                    help="trim each dump to its N newest records "
                         "(0 = all)")
    bb.add_argument("--json", action="store_true",
                    help="machine-readable output (seal-verified)")
    bb.set_defaults(fn=cmd_blackbox)

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
    host_oracle = getattr(args, "backend", None) == "cpu"
    if hasattr(args, "device") and not getattr(args, "dry_run", False) \
            and not host_oracle:
        try:
            resolve_device(args.device)
        except RuntimeError as e:  # no card and no --device cpu
            print(f"{parser.prog}: {e} (on the command line: --device "
                  "cpu)", file=sys.stderr)
            return 2
    if hasattr(args, "coordinator"):  # the engine commands
        # before any device work; a no-op for a single-process run, and
        # torchrun's environment serves with no flags at all
        initialize_distributed(
            args.coordinator, args.num_processes, args.process_id,
            device="cpu" if host_oracle else (
                None if args.device == "cuda" else args.device))
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
