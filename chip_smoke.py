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
                levels, no other kernel launched) and a digest of the bits
                (B' and the source map; each path phase prints one).
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
                frames: two_phase cold, then four clips held call by call
                to ``exact_hi`` (luminance two_phase and sequential, RGB
                sources with ``source_rgb`` two_phase: packed2kw at 608
                lanes with the temporal block, and with exact_hi2:
                packed3w at 2L = 296, 304 lanes as launched; two frames
                each): each call
                re-run with ``match_mode="exact_hi"`` on its recorded
                inputs, previous frame and anchor, and held by the
                tie-audit with the temporal block as the parity phase
                holds an application (one parity line a call); each
                clip's stats, ``flicker()`` and launch counts, each
                call's launches too.
14. driver     — the driver's surroundings on the main path (npr_1024 on
                the 1024^2 oracle inputs, warm), a line a step: a clean
                run (6,138 packed_best and 1,783 argmin_l2 launches, the
                reference bits); pipelined runs (``level_sync=False``:
                prefetch and donation on by auto, ``timing`` with 4
                prepped and 4 donated levels, no prefetch error) with the
                walls and peak memory of clean, pipelined, pipelined,
                clean (recorded, not claimed); checkpoints, the JSONL log
                and saved levels, a resume from level 0 (4,093 + 0
                launches) and one past a damaged level 2 (quarantined,
                4,093 + 1,021); a retry of an injected fault; the watchdog
                abandoning level 4's first attempt (a spin kernel past the
                deadline; its late launches counted apart); a profiled
                256^2 run whose trace holds every argmin_l2 kernel; the
                CLI's ``run`` with ``--checkpoint-dir --log-path
                --no-level-sync`` as a subprocess.  Every run's bits must
                be the clean run's.
15. lanes      — the lane engine (``create_image_analogy_batch``) with
                npr_1024 and ``remap_luminance=False`` on the 1024^2 A and
                A' of seed 7 and the B planes of seeds 7, 13, 21 and 42:
                a wavefront and a batched four-lane run, each cold then
                warm, then the four singletons warm; a bucketed batched
                run (``shape_buckets``) of heights 1,024, 1,000, 960 and
                1,024 and its singletons; a remap-on batch, which must
                refuse (``remap_divergence``) before any launch.  Every
                lane's B', source map and ratios must be its singleton's
                bits, and a four-lane run must launch what one singleton
                does (6,138 packed_best + 1,783 argmin_l2; batched 1,984
                argmin_l2_bf16); its walls, the per-lane wall against the
                singletons' mean, peak memory and per-level ms printed.
16. tune       — the tune store and the run's own counters: ``ia tune
                --dry-run`` (a subprocess, no device work); ``ia tune``
                live into a fresh store, twice (subprocesses): every
                candidate of the packed2k sweep (M = 352, N = 2^20, 223
                lanes; chunks_per_sm x ring_stages) and of the argmin_l2
                sweep (M = 88, N = 65,536, F = 68; chunks_per_sm) must
                give bit-identical idx and val; each candidate's ms,
                the winners and whether both runs picked the same one
                printed with the card's name and power limit; npr_1024
                with ``metrics=True`` on the oracle inputs four times
                (empty store, tuned, tuned, empty): each run the main
                path's digest and launches, its ``launch.*`` counters
                equal to ``LAUNCHES``, its ``hbm.peak_bytes.d0`` gauge
                equal to ``max_memory_allocated``, its manifest naming
                the store and its log the resolved keys, walls printed;
                ``ia warmup --size 256x256 --levels 2`` twice into a fresh
                ``--compile-cache-dir`` (subprocesses: the first builds
                the libraries its levels launch, the second finds them
                all); then npr_1024 on ``make_structured(1000, 7)``,
                wavefront and batched, with and without ``shape_buckets``
                (the DB bucketed to 2^20 ... 2^12 rows): the bucketed bits
                must be the unbucketed ones, walls and peaks printed.
17. ann        — the two-stage ANN matcher (``ann_prefilter``) and the
                exemplar catalog.  Gate: npr_1024 with the flag at 64^2,
                wavefront then batched, the gate in force: each verdict
                and its probes' launches printed, every level run in the
                mode its verdict allows (a refusal: the bits of the same
                run without the flag).  Stage 1 and 2 alone at the level-0
                shape (M = 352, N = 2^20, Kp = 32): ms of the product, of
                the top-k, of each stage, and stage 1's bound.  Full
                width, the gate bypassed, on the seed-7 oracle inputs: the
                wavefront with its bases built on the card, ``ann_rescue``
                at all five levels, ``ann.projection_built`` and
                ``ann.prefilter_used`` 5, no kernel launched, SSIM vs the
                oracle >= 0.90 and the tie-audit printed; the wavefront
                again from the bases ``build_style`` sealed on the host:
                5 hits, none built, the first run's bits; batched, its
                bases built on the card, no ``argmin_l2_bf16`` launch, SSIM
                printed; four wavefront lanes at 256^2 (the lanes phase's
                seeds) and their singletons, each lane's bits against its
                singleton's and the stage-1 product's rows printed;
                per-level ms, build ms (total_ms - ms) and peak memory of
                every run.  Catalog at 128^2: ``ia catalog build`` (a
                subprocess, started with the phase: it needs no card)
                seals one entry and one basis a level; a run
                hits every basis and builds none; one damaged basis runs
                its level exact, is quarantined and resealed
                (``ann.fallback_exact`` 1, ``ann.artifacts_rebuilt`` 1);
                the next run hits every level with the first run's bits.
                Tune: ``ia tune --knob ann --no-persist`` (a subprocess),
                which must exit 0 (a tie-clean candidate), its candidates
                printed; the default slab (64) must be tie-clean.

18. mesh       — the mesh path (``parallel/``) on the one card: NCCL in a
                world of one (the sharded argmin at HIGHEST and DEFAULT,
                the packed all-reduce and the ring at the main path's
                level-0 and level-2 shapes, their picks the single-card
                kernels'), then one gloo world of two ranks on cuda:0: the
                npr_1024 wavefront at db_shards=2 on the seed-7 oracle's
                inputs (each rank 6,138 packed2k and 1,783 argmin launches,
                both ranks the same bits, SSIM and tie-audit against the
                oracle, audited while the ranks go on; whether the bits are
                MAIN_DIGEST), batched at db_shards=2 and the query-parallel
                wavefront (data_shards=2) at 512^2 against single-card
                runs, and a 3-frame two_phase clip at 256^2 with its frames
                sharded (data_shards=2) against the serial clip; per rank
                the walls, per-level ms, peak memory, the psum-gather
                estimate and the bytes staged through the host.
19. serve      — the serving path (``serve/``) on npr_1024 with
                ``remap_luminance=False``: (1) ``loadgen.selftest`` of four
                1024^2 requests (one shape class, seed 7) on two workers,
                batches of up to four: every response its singleton's
                bits, no error, the lane engine run (completions > engine
                launches >= 1), and the selftest's launches exactly its
                singleton runs' (the baseline's four, each engine launch
                and each one-by-one member a singleton's 6,138 packed2k +
                1,783 argmin_l2); the walls, p50/p99 latency, queue and
                dispatch ms, peak memory and the learned cost rate beside
                the card's name and power limit (recorded, not claimed);
                (2) ``cli serve --selftest 12`` at its default shapes as a
                subprocess, exit 0; (3) at 256^2: an injected transient
                fault retried inside the server to the library call's bits,
                an expired deadline cancelled before dispatch with no
                launch, a gated worker's queue of one refusing at once
                (queue_full), an unmeetable live deadline served degraded
                with the bits of a library run at the degraded params, the
                breaker failing fast after two failures; (4) eight 256^2
                requests over two exemplars on two workers at once: each
                its singleton's bits, two engine launches, and the
                launches exactly two singletons' (the counters under
                threads; a key's burst may split, so it holds
                engine launches >= 2 and the launches to what ran); (5) the
                journal and the HTTP front on check 1's four requests, their
                derived idempotency keys and singleton runs (no new
                singleton), ``journal_fsync=True``: (a) a journaled server
                behind ``serve_http`` on an ephemeral loopback port, the
                telemetry archive armed, request 1 POSTed as an
                ``x-ia-f32`` frame with its key and an ``X-IA-Trace``,
                answered with its singleton's bits and the caller's trace
                id, ``/healthz``'s journal at done 1, ``/metrics`` parsed as
                Prometheus 0.0.4 with ``serve.journal.done``; (b) requests
                2-4 in process, the workers held in the two engine entry
                points (past the members' ``dispatched`` lines, before any
                launch; a wrapper the check installs), then ``kill()``: the
                check fails the killed server's futures and releases the
                holds, which raise before any launch, and joins every thread
                of the killed server (none alive, no launch) before (c)
                counts; (c) a new server on the directory: recovery done 1,
                replayed 3, poisoned 0, unrecoverable 0, ``wait_recovered``
                ok three times, each response its singleton's bits, the
                launches exactly (engine launches + lone members) x a
                singleton's; (d) the four keys POSTed again as frames, each
                plane its singleton's, the journal's recorded
                ``response_digest`` the singleton's, no launch; (e) ``cli
                journal inspect --json`` (4 requests, 4 done), ``cli why
                <key 2> --json`` (admitted, then replay, then done) and
                ``cli archive inspect --json`` (a segment, nothing
                quarantined) as subprocesses.  The walls of (a) and (c),
                the recovery seconds, the peak memory and the journal's
                bytes are printed beside the card's name and power limit;
                (6) the fleet on check 1's four requests and singleton
                runs: (a) an in-process fleet of two (``wire="binary"``, a
                journal root): each response its singleton's bits, all four
                routed to one home worker (``router.routed.*``), the
                launches exactly (engine launches + lone members) x a
                singleton's; (c) ``serve_fleet_http`` on an ephemeral
                loopback port over (a)'s fleet: one request POSTed as an
                ``x-ia-f32`` frame with a fresh idempotency key and an
                ``X-IA-Trace``, its singleton's bits, the caller's trace id,
                one singleton's launches; ``/healthz`` the fleet view,
                ``/metrics`` Prometheus 0.0.4 with ``worker=`` series; (b)
                a subprocess fleet of two ``worker_main`` children on the
                card: each spawn's seconds and the card's compute pids at
                its entry, the four requests sent and their home SIGKILLed
                once its ``/healthz`` journal shows them admitted and
                dispatched, not done, three seconds into the batch (its
                kernels running); the card's used memory at the kill and
                at the replacement's spawn; the health loop's replacement
                is generation 1 on the
                same directory (stale lock swept), the corpse not on the
                card when it spawns, ``router.deaths`` 1 and ``handoffs``
                1, every future answered with its singleton's bits, and
                the children's ``launch.*`` counters, read through the
                federated ``/metrics.json`` snapshot, exactly their runs'
                (the corpse's launches die with it); the handoff and
                recovery seconds, each child's ``hbm.peak_bytes`` and how
                it ended at shutdown (0 drained, -9 killed after 15 s);
                (d) ``cli fleet --selftest 6 --transport subprocess`` and
                ``cli fleet --selftest 6 --autoscale`` as subprocesses
                (started after (1)), exit 0, the autoscaled summary's
                ``control.autoscale`` true; (e) no ``worker_main`` process
                left alive or on the card, ``live_workers()`` empty and
                ``reap_orphans()`` 0.  It checks bits and counts, not
                times.
20. chaos      — the seeded fault plane (``chaos/``) on the card: (a)
                ``cli chaos --selftest --json`` as a subprocess: exit 0,
                each of the thirteen drill kinds ok with an injection, the
                determinism check ok, then no ``worker_main`` left
                (``live_workers()`` empty, ``reap_orphans()`` 0, none in
                /proc); (b) beside it, npr_1024 on the seed-7 oracle
                inputs in a metrics run, cold, clean, then armed: a
                transient and an oom at level 0's ``level.dispatch`` visit
                (``level_retry`` 1), a hang there past a watchdog of three
                times the clean run's slowest level dispatch (the hang
                twice the watchdog: ``watchdog.timeouts`` 1,
                ``watchdog.abandoned`` 1, ``level_retry`` 1, a
                flight-recorder dump, the abandoned attempt waited for
                and its launches counted: none), a ``corrupt`` at
                ``ckpt.save`` and the disarmed resume
                (``ckpt.quarantined`` 1, 4,093 + 253 launches), then clean
                again.  Every run MAIN_DIGEST's bits, exactly
                6,138 packed_best + 1,783 argmin_l2 launches and its
                counters reconciled with its plan by the port's
                ``_reconcile``; the walls and the retries' and resume's
                costs beside the card's name and power limit (recorded,
                not claimed).
21. soak       — the trace-driven soak (``soak/``, ``ia soak``) and the
                run-log readers: (a) ``cli soak --seed 7 --json`` as a
                subprocess twice (the second with ``--workdir``): exit 0,
                ``ia soak: PASS``, loss 0, at least two kills, a handoff
                for each, both ``REQUIRED_SITES`` injected, the two
                verdict lists equal; (b) ``cli soak --full --json
                --workdir`` once: green, ``p999_ms`` within the spec's
                bound; (c) the soak serves on the host oracle as the JAX
                soak does: every ``launch.*`` counter in (a)'s and (b)'s
                facts 0, while the engine's own counters reach them
                (``level_retry`` at least the injected transients); each
                run's wall, ``p999_ms``, kills and handoffs; (d) one warm
                npr_1024 run at 1024^2 on the seed-7 oracle inputs in a
                metrics run with a log: ``cli report --json`` on it shows
                five levels with device ms, ``kernel.flops`` above 0 and
                the launch counters the run made (6,138 packed_best, 1,783
                argmin_l2), ``cli report`` a ``kernel cost`` line, ``cli
                trace`` events on the host and device tracks; ``cli top
                --once --from-archive`` on (a)'s and (b)'s archive roots
                (exit 0 where a sealed timeline document survived the
                plan's torn segment, else 2 with ``no archived timeline
                documents``); ``cli blackbox --all`` on any flight-recorder
                dump the workdirs hold (none: said so).
22. parity     — the packed scans at full size against the fp32 argmin:
                each application run twice on the card on the same inputs,
                at its preset's match mode and at ``match_mode="exact_hi"``
                (``argmin_l2`` at every level), each call's inputs, params
                and levels recorded (``recording_calls``): super_resolution
                on RGB sources with ``color_mode="source_rgb"`` at 1024^2
                (packed2kw at 832 and 688 lanes), the same with
                ``match_mode="exact_hi2"`` at 512^2 (packed3w at every
                level), then at 512^2 texture_by_numbers, artistic_filter
                with ``oil_filter``, super_resolution and
                texture_synthesis (packed2k at level 0).  Both runs' launches held to
                ``want_launches``; the levels that ran exact_hi in both
                (below ``PACKED_CROSSOVER_ROWS``) the same bits; the
                tie-audit of the preset run's levels against the exact_hi
                run's at the main path's limits (unexplained <= 1e-4 of the
                mismatches, the first divergence a tie) and SSIM >= 0.98,
                but for the limits ``PARITY_REPORTED`` names (the JAX
                package's own packed scan does not keep them on that
                application): SSIM printed, the unexplained mismatches and
                the first divergence each held to be the packed scan's own
                pick (the audit's ``packed_pick``); one line a pair
                (mismatches by kind, the
                first divergence and its gap, max fp band, audit seconds,
                both walls).  Every pair runs; then any that did not hold
                fails the phase.

card_vs_cpu's CPU runs run in a side process started with the script
(they need no card).  The modes, video, ann, mesh, serve, chaos, soak and
parity phases run in side processes of their own (this script with
``--phases modes --inline`` and so on), started once the ``driver`` phase
is done, beside the lanes and tune phases (the modes and video phases run
after the ``driver`` phase, to keep the whole script well inside its
limit); but the soak's starts after card_vs_cpu, so that its timed runs
(request latencies against deadlines on the host oracle) share the host
with the modes_small and driver phases only, and its card part (d) waits
for the others to start: their output is printed when each has ended, and
a side phase that fails fails the script.  Each phase's seconds, and the
seconds since the script began, are a ``[time]`` line after it (a side
phase's own, inside its output; the line after it here, the seconds this
process waited for it).

The kernels phase also runs each kernel of the lane path at four lanes'
query rows (packed_best at M = 1,408, argmin_l2 at 352, argmin_l2_bf16 at
4,096): every row's pick and score bits must be those of a singleton-sized
call on the same rows; its ms beside the singleton call's, the plain
version's, the yardstick's and the bound are a row of the table each.

The kernels phase also runs packed_best at the widths the applications
reach (M = 352, N = 2^20: 304-368 lanes on packed2k_best.cu, 608-1,040 on
packed2kw_best.cu, its row in the table at 832 lanes, its launches from
the parity phase's RGB run), and at 832 lanes at M = 64, 128 and 192 too
(the query-tile sweep); with ``--parent`` the parent's packed_best at
every one of these shapes, its ms and the counts of equal picks and val
bits.

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
import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "kernels", "main", "oracle", "exact_hi2", "rescue",
          "two_pass", "batched", "gate", "card_vs_cpu", "modes_small",
          "modes", "video", "driver", "lanes", "tune", "ann", "mesh",
          "serve", "chaos", "soak", "parity")

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
# the query-tile sweep at the row's width: M = 64, 128 and 192 beside the
# headline 352 (one to six query tiles of 64 rows), so that the kernel's
# dependence on L2 -> SM traffic (each query tile re-reads the DB) stays
# on record
P2KW_SWEEP_M = (64, 128, 192)
# the superseded packed forms: the row in the table (M = 64, N = 65,536),
# then the shape of the other packed rows (M = 352, N = 2^20), L = 55
FORMS_SHAPES = (dict(m=64, npad=65536), dict(m=352, npad=1048576))
FORMS_LW = 55

# the lane engine (batch/engine.py): k = 4 targets, the B planes of
# make_structured(1024, seed) against seed 7's A and A'; the bucketed
# batched run crops them to these heights (one query bucket at every
# level); each kernel of the lane path at four lanes' rows, beside the
# singleton's widest call: packed2k M = 4 x 352 (level 0), argmin_l2 M =
# 4 x 88 (level 2), argmin_l2_bf16 M = 4 x 1,024 (batched level 0)
LANE_SEEDS = (7, 13, 21, 42)
# the lanes phase's batched and bucketed runs (the wavefront lanes stay at
# 1024^2), and the ann phase's batched run: cut from 1024^2 so that the
# script ends inside its time limit with the mesh phase
LANES_BATCHED_SIZE = 512
ANN_BATCHED_SIZE = 512
LANE_HEIGHTS = (1024, 1000, 960, 1024)
LANES = len(LANE_SEEDS)

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
# the main path's bits on seed 7's inputs (``bits_digest``): the tune phase
# holds every metrics run, tuned or not, to them
MAIN_DIGEST = "eb610f5475a13e63"
# the bucketed level build's inputs: make_structured(1000, 7), whose levels'
# A rows (10^6 ... 3,969) bucket to 2^20, 2^18, 2^16, 2^14 and 2^12 rows
BUCKET_SIZE = 1000
# the ann phase: the gate's synthesis, the lanes' and the catalog
# mechanics' sizes (the full-width runs are 1024^2; the lanes and the
# catalog mechanics are cut so the whole script stays inside its limit:
# the two-stage path takes 35-52 s a 1024^2 wavefront run on the card)
ANN_GATE_SIZE = 64
ANN_LANE_SIZE = 256
ANN_CATALOG_SIZE = 128
# the slab the port resolves with no tune row (tune/geometry.py)
DEFAULT_ANN_TOP_M = 64
# the parity phase's sizes: RGB super-resolution at its preset's
# match_mode (packed2kw), the same with exact_hi2 (packed3w), and the other
# four applications at 512^2, where level 0's 262,144 rows still take the
# packed scan at the same widths (cut from 1024^2 by the rule set with the
# phase: the whole script took 1,096 s on a slow host, past 950)
PARITY_RGB_SIZE = 1024
PARITY_EXACT_HI2_SIZE = 512
PARITY_APP_SIZE = 512
# the video side's clips (``video_cases``): the video preset at 512^2,
# where level 0 (262,144 rows) takes the packed scan and levels 1-2 the
# fp32 argmin; the RGB clips' frames, cut from 3 to 2 by the rule set with
# the side (the whole script took 966.3 s on a slow host, past 950, and
# the video side 348.0 s, past 340): each keeps one phase-2 call
VIDEO_SIZE = 512
VIDEO_RGB_FRAMES = 2
# the limits of a pair that the JAX package's own packed scan does not
# keep against its fp32 scan on the same application: SSIM reported, not
# held; the unexplained fraction and the first divergence held instead to
# the packed scan's own arithmetic (``parity_hold``: each such pixel the
# pick the packed2k scores make)
# (tests/test_torch_app_parity.py test_jax_packed_scan_against_its_fp32_scan
# shows each on the JAX package's Pallas kernels).  A tie flip re-routes
# every later causal window, and where the coherence term is weak the
# texture comes out another (SSIM); texture synthesis's first near-tie can
# resolve apart past the audit's band (the first divergence), and the new
# context leads to a few more like it, whose count does not grow with the
# mismatches that follow (the unexplained fraction: 1.1e-4 at 512^2).  The
# luminance video clips (the oil filter pair, with and without the temporal
# block) first diverge at level 0's first pixel, a near-tie 7.8e-6 to
# 9.3e-6 apart that the JAX package's packed scan resolves as the card's
# does, with a handful more like it (1.3e-4 to 1.6e-4), and a few calls'
# textures come out another (tests/test_torch_video_parity.py
# test_jax_packed_scan_leaves_the_clips_first_pixel_past_the_band and
# test_jax_packed_scan_with_the_temporal_block_against_its_fp32_scan)
LUMINANCE_VIDEO_REPORTED = ("ssim", "first_divergence_is_tie",
                            "unexplained_fraction")
PARITY_REPORTED = {
    "texture_by_numbers": ("ssim",),
    "super_resolution": ("ssim",),
    "texture_synthesis": ("ssim", "first_divergence_is_tie",
                          "unexplained_fraction"),
    "video_two_phase": LUMINANCE_VIDEO_REPORTED,
    "video_sequential": LUMINANCE_VIDEO_REPORTED,
}


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def say(phase: str, /, **fields) -> None:
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
    read once, (idx, val) written once; 2 M N F operations (the package's
    work count, ``obs/device.py argmin_work``)."""
    from image_analogies_tpu_torch.obs.device import argmin_work

    return bound(*argmin_work(m, npad, f), PEAK_FP32_FLOP_S)


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
    phase_lane_kernels(rows)
    return rows


def lane_rows_equal(name, match, call, q):
    """``call`` on LANES lanes' query rows ``q`` (one launch) against
    ``call`` on each lane's block (a singleton's launch): every row's pick
    and score bits must be equal.  Returns the lane call's (idx, val)."""
    import torch

    key = name.split()[0]
    match.reset_launch_counts()
    idx, val = call(q)
    parts = [call(part) for part in q.chunk(LANES)]
    torch.cuda.synchronize()
    if match.LAUNCHES[key] != 1 + LANES:
        fail(f"{name}: {match.LAUNCHES[key]} launches, not {1 + LANES}")
    one_i = torch.cat([pt[0] for pt in parts])
    one_v = torch.cat([pt[1] for pt in parts])
    if not (torch.equal(idx, one_i) and torch.equal(
            val.view(torch.int32), one_v.view(torch.int32))):
        fail(f"{name}: {int((idx != one_i).sum())} picks and "
             f"{int((val.view(torch.int32) != one_v.view(torch.int32)).sum())}"
             " scores differ from the singleton-sized calls' on the same "
             "rows")
    return idx, val


def phase_lane_kernels(rows):
    """Each kernel of the lane path at the rows of LANES lanes: packed_best
    (packed2k) at M = 4 x 352 against N = 2^20, argmin_l2 at M = 4 x 88
    against 65,536 rows, argmin_l2_bf16 at M = 4 x 1,024 against 2^20 rows
    (``lane_rows_equal``: the bits of a singleton-sized call on every row),
    held against the plain version as the headline cases, and timed beside
    the singleton-sized call, the plain version, the yardstick and the
    bound at the lane width.  argmin_l2_bf16's plain version and yardstick
    run in four calls of 1,024 rows: one call's (4,096 x 2^20) fp32 scores
    and their temporaries would take ~50 GB.  Each is a row of the table,
    its launches from the lanes phase."""
    import torch

    from image_analogies_tpu_torch.ops import match

    flush = flusher(torch.device("cuda", 0))
    sm = match._sm_count(0)

    # packed2k, level 0 of the main path
    s = PACKED_SHAPE
    m, lw = LANES * s["m"], s["lw"]
    width = 4 * lw + 3
    ((_, npad, _, _, qa, wk, k_used, n_real, lo),) = packed_cases(
        match, [("lanes", s["npad"], m, 0)], lw)
    call = lambda q: match.packed_best(q, wk, k_used)
    idx, val = lane_rows_equal("packed_best lanes", match, call, qa)
    scores = match._packed_scores_plain(qa, wk, k_used, None, None, None,
                                        False)
    ref_idx, ref_val = match._first_max(scores)
    second = torch.topk(scores, 2, dim=1).values[:, 1]
    del scores
    err, ndiff = check_picks("packed_best lanes", idx, val, ref_idx, ref_val,
                             second, PACKED_ATOL)
    if int(idx[0]) != lo or int(idx.max()) >= n_real:
        fail("packed_best lanes: duplicate/padding rule broken")
    k_ms = cuda_time_ms(lambda: call(qa), reps=20, flush=flush)
    one_ms = cuda_time_ms(lambda: call(qa[:s["m"]]), reps=20, flush=flush)
    p_ms = cuda_time_ms(lambda: match.packed_best_plain(qa, wk, k_used),
                        reps=3, flush=flush)
    wkt = wk.T
    l_ms = cuda_time_ms(
        lambda: torch.mm(qa, wkt, out_dtype=torch.float32).max(dim=1),
        reps=10, flush=flush)
    b = packed_bound(m, npad, width)
    name = f"packed_best ({LANES} lanes)"
    rows[name] = kernel_row(name, "packed2k_best.cu", 523, err, k_ms, p_ms,
                            l_ms, b)
    say("kernels", kernel="packed_best", lanes=LANES, m=m, npad=npad,
        width=width, plan=match._packed2k_plan(m, npad, sm, k_used)._asdict(),
        max_abs_err=err, picks_differing_in_band=ndiff, ms=k_ms,
        singleton_ms=one_ms, ms_per_lane=k_ms / LANES, plain_ms=p_ms,
        library_ms=l_ms, bound_ms=b[0], bound_by=b[1])
    del qa, wk, wkt, idx, val, ref_idx, ref_val, second
    torch.cuda.empty_cache()

    # argmin_l2, level 2 of the main path
    s = ARGMIN_SHAPE
    m, npad, f = LANES * s["m"], s["npad"], s["f"]
    arrays = argmin_operands(m, npad, f, s["fp"], seed=11, dup=(1000, 64000))
    n_real = arrays[3]
    qd, dbd, dbnd = (torch.from_numpy(x).cuda() for x in arrays[:3])
    call = lambda q: match.argmin_l2(q, dbd, dbnd)
    idx, val = lane_rows_equal("argmin_l2 lanes", match, call, qd)
    scores = dbnd[None, :] - 2.0 * (qd @ dbd[:, :f].T)
    ref_idx, ref_val = match.argmin_l2_plain(qd, dbd, dbnd)
    second = torch.topk(scores, 2, dim=1, largest=False).values[:, 1]
    err, ndiff = check_picks("argmin_l2 lanes", idx, val, ref_idx, ref_val,
                             second, ARGMIN_ATOL)
    if int(idx[0]) != 1000 or int(idx.max()) >= n_real:
        fail("argmin_l2 lanes: duplicate/padding rule broken")
    k_ms = cuda_time_ms(lambda: call(qd), reps=50)
    one_ms = cuda_time_ms(lambda: call(qd[:s["m"]]), reps=50)
    p_ms = cuda_time_ms(lambda: match.argmin_l2_plain(qd, dbd, dbnd),
                        reps=20)
    dbt = dbd[:, :f].T
    l_ms = cuda_time_ms(
        lambda: torch.addmm(dbnd, qd, dbt, alpha=-2.0).min(dim=1), reps=20)
    b = argmin_bound(m, npad, f)
    name = f"argmin_l2 ({LANES} lanes)"
    rows[name] = kernel_row(name, "argmin_l2.cu", 51, err, k_ms, p_ms, l_ms,
                            b)
    say("kernels", kernel="argmin_l2", lanes=LANES, m=m, npad=npad, f=f,
        plan=match._argmin_plan(m, npad, sm, f)._asdict(), max_abs_err=err,
        picks_differing_in_band=ndiff, ms=k_ms, singleton_ms=one_ms,
        ms_per_lane=k_ms / LANES, plain_ms=p_ms, library_ms=l_ms,
        bound_ms=b[0], bound_by=b[1])
    del qd, dbd, dbnd, dbt, scores

    # argmin_l2_bf16, level 0 of the batched strategy
    level, npad, m1, _, f = batched_level_shapes()[0]
    m = LANES * m1
    k_used = (f + 15) // 16 * 16
    ((_, _, _, _, q, dbp, dbn, n_real, lo, _),) = argmin2_cases(
        [(level, npad, m, 0, f)], center=False)
    call = lambda qq: match.argmin_l2_bf16(qq, dbp, dbn, k_used)
    idx, val = lane_rows_equal("argmin_l2_bf16 lanes", match, call, q)
    dbt = dbp.T
    err = ndiff = 0
    for blk, i_b, v_b in zip(q.chunk(LANES), idx.chunk(LANES),
                             val.chunk(LANES)):
        qk = match._scan_queries(blk, False)
        second = torch.topk(dbn[None, :] - 2.0 * match._dots(qk, dbp, k_used),
                            2, dim=1, largest=False).values[:, 1]
        ref_idx, ref_val = match.argmin_l2_bf16_plain(blk, dbp, dbn, k_used)
        e, nd = check_picks("argmin_l2_bf16 lanes", i_b, v_b, ref_idx,
                            ref_val, second, PACKED_ATOL)
        err, ndiff = max(err, e), ndiff + nd
        del qk, second, ref_idx, ref_val
    if int(idx[0]) != lo or int(idx.max()) >= n_real:
        fail("argmin_l2_bf16 lanes: duplicate/padding rule broken")
    k_ms = cuda_time_ms(lambda: call(q), reps=20, flush=flush)
    one_ms = cuda_time_ms(lambda: call(q[:m1]), reps=20, flush=flush)
    blocks = q.chunk(LANES)
    p_ms = cuda_time_ms(lambda: [match.argmin_l2_bf16_plain(
        blk, dbp, dbn, k_used) for blk in blocks], reps=3, flush=flush)
    qks = [match._scan_queries(blk, False) for blk in blocks]
    l_ms = cuda_time_ms(lambda: [(dbn[None, :] - 2.0 * torch.mm(
        qk, dbt, out_dtype=torch.float32)).min(dim=1) for qk in qks],
        reps=10, flush=flush)
    b = argmin_bf16_bound(m, npad, f)
    name = f"argmin_l2_bf16 ({LANES} lanes)"
    rows[name] = kernel_row(name, "argmin_bf16.cu", 51, err, k_ms, p_ms,
                            l_ms, b)
    say("kernels", kernel="argmin_l2_bf16", lanes=LANES, m=m, npad=npad,
        f=f, k_used=k_used,
        plan=match._argmin_bf16_plan(m, npad, sm, k_used)._asdict(),
        max_abs_err=err, picks_differing_in_band=ndiff, ms=k_ms,
        singleton_ms=one_ms, ms_per_lane=k_ms / LANES, plain_ms=p_ms,
        plain_calls=LANES, library_ms=l_ms, library_calls=LANES,
        bound_ms=b[0], bound_by=b[1])
    del q, dbp, dbn, dbt, qks, blocks
    torch.cuda.empty_cache()


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
    {"<lw>/<m>": (idx, val, device ms)}, timed from a cold L2 (the
    ``--parent`` child of the packed2k widths); one DB per run of shapes
    that share (lw, npad)."""
    import torch

    flush = flusher(torch.device("cuda", 0))
    out = {}
    for (lw, npad), group in itertools.groupby(shapes, key=lambda s: s[:2]):
        for _, _, m, _, qa, wk, k_used, _, _ in packed_cases(
                match, [(0, npad, m, 0) for *_, m in group], lw):
            idx, val = match.packed_best(qa, wk, k_used)
            ms = cuda_time_ms(lambda: match.packed_best(qa, wk, k_used),
                              reps=20, flush=flush)
            out[f"{lw}/{m}"] = (idx.cpu().numpy(), val.cpu().numpy(), ms)
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
    bf16 operations (the package's work count, ``obs/device.py
    packed2k_work``)."""
    from image_analogies_tpu_torch.obs.device import packed2k_work

    return bound(*packed2k_work(m, npad, width), PEAK_BF16_FLOP_S)


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
    = 2^20, and at P2KW_ROW_LW also at the query-tile sweep's M
    (P2KW_SWEEP_M): the width rule's kernel (packed2k_best.cu up to 512
    lanes, packed2kw_best.cu past them, its launch plan printed) held
    against its plain version (scores within PACKED_ATOL and picks equal
    outside SCORE_BAND up to 512 lanes; past them within P3W_ATOL, picks
    outside that band: the tensor cores' fp32 sum over 38-65 k steps), the
    duplicate and padding rules, timed from a cold L2 beside the
    ``torch.mm(out_dtype=float32) + max`` yardstick, the plain version and
    the bound.  The 832-lane shape at M = 352 is packed2kw_best's row in
    the table; a last line gives its ms at each M of the sweep.  With
    ``parent``: that tree's packed_best on every shape, its ms and the
    counts of equal picks and val bits."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch.ops import match

    npad, m_row = PACKED_SHAPE["npad"], PACKED_SHAPE["m"]
    cases = [(lw, (m_row, *P2KW_SWEEP_M) if lw == P2KW_ROW_LW else (m_row,))
             for lw in P2K_WIDTHS]
    theirs = None
    if parent:
        theirs, parent_ms = parent_bits(
            "packed_widths", parent,
            [[lw, npad, m] for lw, ms in cases for m in ms])
    flush = flusher(torch.device("cuda", 0))
    sweep = {}
    for lw, ms in cases:
        width = 4 * lw + 3
        for _, _, m, _, qa, wk, k_used, n_real, lo in packed_cases(
                match, [(0, npad, m, 0) for m in ms], lw):
            route = match._packed2k_route(k_used)
            wide = route == "packed2kw_best"
            plan = (match._packed2kw_plan if wide else match._packed2k_plan)(
                m, npad, match._sm_count(0), k_used)
            name = f"{route} {k_used} lanes, M = {m}"
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
            if theirs is not None:
                key = f"{lw}/{m}"
                ti, tv = theirs[f"idx/{key}"], theirs[f"val/{key}"]
                seg.update(parent_ms=parent_ms[key],
                           picks_equal_parent=int(
                               (ti == idx.cpu().numpy()).sum()),
                           val_bits_equal_parent=int(
                               (tv.view(np.int32) == val.cpu().numpy().view(
                                   np.int32)).sum()))
            say("kernels", kernel="packed_best", **seg)
            if lw == P2KW_ROW_LW:
                sweep[m] = {k: seg[k] for k in ("ms", "library_ms",
                                                 "parent_ms") if k in seg}
                if m == m_row:
                    rows["packed2kw_best"] = kernel_row(
                        "packed2kw_best", "packed2kw_best.cu", 523, err,
                        k_ms, p_ms, l_ms, b)
            del qa, wk, wkt
        torch.cuda.empty_cache()
    say("kernels", kernel="packed_best", query_tile_sweep=4 * P2KW_ROW_LW + 3,
        npad=npad, by_m={str(m): sweep[m] for m in sorted(sweep)})


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


def level_launches(params, size: int, modes=None):
    """(kernel, launches) of each level of a size x size run, finest
    first.  Wavefront: c(h-1)+w steps a level, each on its level's anchor
    kernel (``modes``: the mode each level ran, finest first; default the
    resolution of match_mode).  Batched and rowwise: one ``argmin_l2_bf16``
    launch per scan row.  Exact: none (kernel None)."""
    from image_analogies_tpu_torch.backends.cuda import resolve_match_mode
    from image_analogies_tpu_torch.ops.pyramid import num_feasible_levels

    levels = num_feasible_levels((size, size), params.levels,
                                 params.patch_size)
    c = params.patch_size // 2 + 1
    out = []
    h = size
    for level in range(levels):
        if params.strategy in ("batched", "rowwise"):
            out.append(("argmin_l2_bf16", h))
        elif params.strategy in ("auto", "wavefront"):
            mode = (modes[level] if modes is not None
                    else resolve_match_mode(params.match_mode, h * h))
            out.append((ANCHOR_KERNEL[mode], c * (h - 1) + h))
        else:
            out.append((None, 0))
        h = (h + 1) // 2
    return out


def expected_launches(params, size: int, modes=None, levels=None):
    """Kernel launches of a size x size run (``level_launches`` summed;
    ``levels``: only those levels)."""
    out = {}
    for level, (key, n) in enumerate(level_launches(params, size, modes)):
        if key and (levels is None or level in levels):
            out[key] = out.get(key, 0) + n
    return out


def bits_digest(result) -> str:
    """sha256 of a run's B' plane and source map: equal digests, equal
    bits (compares runs of two trees, one process each)."""
    import hashlib

    import numpy as np

    h = hashlib.sha256(np.ascontiguousarray(result.bp_y, np.float32))
    h.update(np.ascontiguousarray(result.source_map, np.int32))
    return h.hexdigest()[:16]


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
            bits=bits_digest(result),
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
        packed_pick=audit["packed_pick"],
        packed_replay=audit["packed_replay"],
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


def card_vs_cpu_cases():
    """card_vs_cpu's cases: [(params kwargs, (a, ap, b))]."""
    import numpy as np

    from image_analogies_tpu_torch.utils.assets import make_structured

    gray = make_structured(96, 7)
    rgb = tuple(np.stack([x, x * x, 1 - x], -1).astype(np.float32)
                for x in gray)
    rgb64 = tuple(np.ascontiguousarray(x[16:80, 16:80]) for x in rgb)
    return [(dict(match_mode=mode), gray) for mode in NEW_MODES] + [
        (dict(match_mode=mode, color_mode="source_rgb"), rgb)
        for mode in ("exact_hi2", "scan_rescue")] + [
        (dict(match_mode="exact_hi2", color_mode="source_rgb", patch_size=7,
              levels=2), rgb64)] + [
        (dict(strategy=strategy), make_structured(size, 7))
        for strategy, size in (("batched", 96), ("rowwise", 64),
                               ("exact", 48))]


def card_vs_cpu_params(kw):
    from image_analogies_tpu_torch import AnalogyParams

    return AnalogyParams(**{"levels": 3, "kappa": 5.0, **kw})


def cpu_refs(out):
    """card_vs_cpu's CPU runs (``--cpu-refs OUT``, a side process started
    with the script: it needs no card and runs on the host's cores while
    the card works): each case's B' and source map into the npz OUT."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.backends.cuda import CudaMatcher

    torch.set_num_threads(4)  # the main process keeps the other cores
    os.environ["IA_EXPERIMENTAL"] = "1"
    refs = {}
    for i, (kw, (a, ap, b)) in enumerate(card_vs_cpu_cases()):
        params = card_vs_cpu_params(kw)
        cpu = create_image_analogy(a, ap, b, params, backend=CudaMatcher(
            params, "cpu", bf16_approx=params.strategy in ("batched",
                                                           "rowwise")))
        refs[f"bp{i}"], refs[f"s{i}"] = cpu.bp_y, cpu.source_map
    np.savez(out + ".tmp.npz", **refs)
    os.replace(out + ".tmp.npz", out)


def cpu_refs_start():
    """Start :func:`cpu_refs` in a side process; returns (process, npz
    path) for :func:`phase_card_vs_cpu`."""
    import tempfile

    out = os.path.join(tempfile.mkdtemp(prefix="ia_cpu_refs_"), "refs.npz")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--cpu-refs", out], cwd=HERE,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def phase_card_vs_cpu(refs):
    """exact_hi2, scan_rescue[_1p] and two_pass[_1p] at 96^2 (3 levels) on
    the card and on the CPU, exact_hi2 and scan_rescue on RGB sources;
    exact_hi2 on RGB sources at patch 7 (64^2, 2 levels: 2L = 414 and 342
    lanes, packed3w_best.cu at every wavefront step); then
    batched (96^2) and rowwise (64^2) against a CPU run of the same bf16
    approximate match (the kernel's plain version, through the level's
    approx_fn), and exact (48^2) against the CPU's fp32 scan.  The CPU
    runs come from ``refs`` (:func:`cpu_refs_start`, started with the
    script)."""
    import numpy as np

    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.utils.ssim import ssim

    os.environ["IA_EXPERIMENTAL"] = "1"
    gpus = []
    wide = None
    for kw, (a, ap, b) in card_vs_cpu_cases():
        params = card_vs_cpu_params(kw)
        match.reset_launch_counts()
        gpus.append(create_image_analogy(a, ap, b, params))
        if kw.get("patch_size") == 7:
            wide = dict(match.LAUNCHES)
            want = sum(expected_launches(params, a.shape[0]).values())
            if wide["packed3w_best"] != want or wide["packed3_best"]:
                fail(f"card_vs_cpu: {kw} launched "
                     f"{ {k: v for k, v in wide.items() if v} }, expected "
                     f"packed3w_best once per wavefront step ({want})")
    proc, path = refs
    t0 = time.perf_counter()
    _, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        fail(f"card_vs_cpu: the CPU runs' process exit {proc.returncode}: "
             f"{err[-2000:]}")
    cpu = np.load(path)
    say("card_vs_cpu", cpu_refs_wait_s=time.perf_counter() - t0)
    for i, ((kw, (a, ap, b)), gpu) in enumerate(zip(card_vs_cpu_cases(),
                                                    gpus)):
        diff = float((gpu.source_map != cpu[f"s{i}"]).mean())
        s = ssim(gpu.bp_y, cpu[f"bp{i}"])
        say("card_vs_cpu", size=a.shape[0], **kw, source_map_differs=diff,
            ssim=s)
        if not (diff < CARD_CPU_MISMATCH_MAX and s >= CARD_CPU_SSIM_MIN
                and np.isfinite(gpu.bp).all()):
            fail(f"card_vs_cpu: {kw} differs from its CPU run (source maps "
                 f"{diff:.4f}, SSIM {s:.4f})")


def level_route(params, level, levels, mode, src_channels, temporal=False):
    """(kernel, width) of one level of a wavefront call: the launch-count
    key its resolved match mode runs at the level's lane width (packed2k
    past 512 lanes: packed2kw_best; packed3 past 256: packed3w_best) and
    that width (the packed lanes, rounded to 16, or the fp32 argmin's F)."""
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.ops.features import spec_for_level

    spec = spec_for_level(params, level, levels, src_channels,
                          temporal=temporal)
    lw = int(spec.query_live_mask().sum())
    if mode == "exact_hi2_2p":
        lanes = (4 * lw + 3 + 15) // 16 * 16
        return match._packed2k_route(lanes), lanes
    if mode == "exact_hi2":
        lanes = (2 * lw + 15) // 16 * 16
        return match._packed3_route(lanes), lanes
    return ANCHOR_KERNEL[mode], spec.total


def want_launches(params, b_shape, stats, src_channels, temporal=False):
    """Kernel launches of one wavefront ``create_image_analogy`` call from
    its level stats: c(h-1)+w steps a level (B's plane at that level), each
    on the kernel its resolved match mode runs at the level's lane width
    (``level_route``)."""
    levels = len(stats)
    c = params.patch_size // 2 + 1
    out = {}
    for st in stats:
        level = st["level"]
        hb, wb = b_shape
        for _ in range(level):
            hb, wb = (hb + 1) // 2, (wb + 1) // 2
        key, _ = level_route(params, level, levels, st["match_mode"],
                             src_channels, temporal)
        out[key] = out.get(key, 0) + c * (hb - 1) + wb
    return out


def source_channels(a, ap, b, params):
    """The channels a call's source planes carry (1, or 3 for RGB sources
    with ``color_mode="source_rgb"``), as ``models/analogy.py``'s
    ``_prep_planes`` builds them."""
    from image_analogies_tpu_torch.models.analogy import _prep_planes

    a_src = _prep_planes(a, ap, b, params)[0]
    return 1 if a_src.ndim == 2 else a_src.shape[-1]


def want_video_launches(params, b_shape, stats, src_channels):
    """``want_launches`` summed over a clip's calls (its stats grouped by
    frame and phase; the temporal block in phase 2 and in every sequential
    frame but the first) on sources of ``src_channels``
    (``source_channels`` of the clip's A, A' and first frame)."""
    groups = {}
    for st in stats:
        groups.setdefault((st["phase"], st["frame"]), []).append(st)
    out = {}
    for (phase, frame), sts in groups.items():
        temporal = phase == "phase2" or (phase == "seq" and frame > 0)
        for k, v in want_launches(params, b_shape, sts, src_channels,
                                  temporal).items():
            out[k] = out.get(k, 0) + v
    return out


def run_app(phase, label, fn, want=None):
    """One application run on the card: every launch count set to 0 just
    before ``fn()`` and read just after, held to ``want(result)`` where
    given (each kernel once per wavefront step of its levels, no other
    kernel); prints each level's mode, scan ms and coherence ratio, the
    wall-clock and the peak device memory.  Returns (result, launches, wall
    seconds)."""
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
    expected = want(result) if want else None
    levels = [dict(level=st["level"], mode=st.get("match_mode"),
                   ms=st["ms"], coherence=st["coherence_ratio"],
                   **{k: st[k] for k in ("frame", "phase") if k in st})
              for st in result.stats]
    say(phase, run=label, wall_s=wall, levels=levels, launches=launches,
        expected_launches=expected,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if expected is not None and launches != {k: v for k, v in
                                             expected.items() if v}:
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
        want = ((lambda r: want_video_launches(params, shape, r.stats,
                                                chans))
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
    level 0 and 688 at level 1)."""
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


def rgb_video_inputs(size, n=3, seed=5):
    """An RGB clip for ``color_mode="source_rgb"`` at side ``size``: A
    three seeded ``_perlin_ish`` planes, A' each through ``_oil_filter``
    (``make_all``'s filter pair in color), and ``n`` frames of a tinted
    blob drifting right over three more planes (``make_all``'s video frames
    in color), so that the temporal term has motion to follow."""
    import numpy as np

    from image_analogies_tpu_torch.utils.assets import (_oil_filter,
                                                        _perlin_ish)

    rng = np.random.default_rng(seed)
    planes = lambda: np.stack([_perlin_ish(size, size, rng)
                               for _ in range(3)], -1)
    a = planes()
    ap = np.stack([_oil_filter(a[..., c]) for c in range(3)], -1)
    base = planes()
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    tint = np.array([1.0, 0.6, 0.3], np.float32)
    frames = []
    for t in range(n):
        blob = np.exp(-((yy - size * 0.5) ** 2
                        + (xx - size * (0.3 + 0.1 * t)) ** 2)
                      / (2 * (0.08 * size) ** 2))
        frames.append((0.7 * base + 0.5 * blob[..., None] * tint).clip(
            0, 1).astype(np.float32))
    return a, ap, frames


def video_cases(size=VIDEO_SIZE, **overrides):
    """The video side's clips in order, as (label, a, ap, frames, params,
    scheme; ``overrides`` on every preset), all with ``PRESETS["video"]``:
    ``make_all(size, 0)``'s three frames and filter pair two_phase and
    sequential, then ``rgb_video_inputs(size, VIDEO_RGB_FRAMES)`` with
    ``color_mode="source_rgb"`` two_phase, at the preset's match mode and
    with ``match_mode="exact_hi2"``."""
    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.utils.assets import make_all

    P = lambda **kw: PRESETS["video"].replace(**kw, **overrides)
    x = make_all(size, 0)
    lum = (x["filter_a"], x["filter_ap"], [x[f"video_f{t}"]
                                           for t in range(3)])
    rgb = rgb_video_inputs(size, VIDEO_RGB_FRAMES)
    return [
        ("video_two_phase", *lum, P(), "two_phase"),
        ("video_sequential", *lum, P(), "sequential"),
        ("video_rgb", *rgb, P(color_mode="source_rgb"), "two_phase"),
        ("video_rgb_exact_hi2", *rgb,
         P(color_mode="source_rgb", match_mode="exact_hi2"), "two_phase"),
    ]


def video_pair(label, a, ap, frames, params, scheme):
    """One clip held call by call to ``exact_hi``: ``video_analogy``
    through ``run_app`` (``flicker()`` printed), each of its
    ``create_image_analogy`` calls recorded (``recording_calls`` on
    ``models.video``) and its own launches held to ``want_launches`` on
    the clip's source channels, the temporal block where it rode (their
    sum is ``want_video_launches``); then each call once more with
    ``match_mode="exact_hi"`` on the recorded inputs, previous frame and
    anchor, held to the recorded call by ``parity_hold`` (the clip is not
    run again: phase 2 would then read the exact run's own phase-1
    frames).  Returns (the clip's launches, the calls' records)."""
    from image_analogies_tpu_torch import create_image_analogy, video_analogy
    from image_analogies_tpu_torch.models import video

    chans = source_channels(a, ap, frames[0], params)
    shape = frames[0].shape[:2]
    calls = []
    with recording_calls(calls, video):
        res, launches, _ = run_app(
            "video", f"{label} {params.match_mode}",
            lambda: video_analogy(a, ap, frames, params, scheme=scheme))
    say("video", run=label, flicker=res.flicker())
    recs = []
    for ca, cap, cb, cp, cres, claunches, cwall, prev, anchor in calls:
        temporal = cp.temporal_weight > 0 and prev is not None
        frame, phase = cres.stats[0]["frame"], cres.stats[0]["phase"]
        tag = f"{label} frame {frame} {phase}"
        want = want_launches(cp, shape, cres.stats, chans, temporal)
        if claunches != want:
            fail(f"video {tag}: launched {claunches}, expected {want}")
        ep = cp.replace(match_mode="exact_hi")
        eres, elaunches, ewall = run_app(
            "video", f"{tag} exact_hi",
            lambda: create_image_analogy(ca, cap, cb, ep, temporal_prev=prev,
                                         remap_anchor=anchor,
                                         keep_levels=True),
            lambda r: want_launches(ep, shape, r.stats, chans, temporal))
        recs.append(parity_hold(
            label, (ca, cap, cb, cp, cres, claunches, cwall),
            (ca, cap, cb, ep, eres, elaunches, ewall), temporal_prev=prev,
            remap_anchor=anchor, frame=frame, phase=phase, temporal=temporal,
            routes={st["level"]: level_route(
                cp, st["level"], len(cres.stats), st["match_mode"], chans,
                temporal) for st in cres.stats}))
    return launches, recs


def phase_video(size=VIDEO_SIZE):
    """``video_analogy`` with ``PRESETS["video"]`` on 512^2 clips
    (``video_cases``): level 0 (262,144 rows) runs the packed scan, levels
    1-2 the fp32 argmin (F = 93 and, at the coarsest, 75 with the
    temporal block).  The luminance clip two_phase cold (packed2k at 224
    lanes, 336 where the temporal block rides: phase 2, and every
    sequential frame but the first), then each clip of ``video_cases``
    held call by call to its exact_hi run (``video_pair``): luminance
    two_phase and sequential, RGB sources with ``color_mode="source_rgb"``
    (packed2kw at 608 lanes with the block) and the same with
    ``match_mode="exact_hi2"`` (packed3w at 2L = 296, 304 lanes as
    launched, with the block).  Each clip's launches and ``flicker()``,
    one parity line per call; every pair runs, then the phase fails if any
    call did not hold or an RGB clip did not launch its wide kernel."""
    from image_analogies_tpu_torch import video_analogy

    t0 = time.perf_counter()
    cases = video_cases(size)
    _, a, ap, frames, params, _ = cases[0]
    res, _, _ = run_app(
        "video", "two_phase cold",
        lambda: video_analogy(a, ap, frames, params, scheme="two_phase"),
        lambda r: want_video_launches(params, frames[0].shape, r.stats,
                                      source_channels(a, ap, frames[0],
                                                      params)))
    say("video", run="two_phase cold", flicker=res.flicker())
    launches, recs = {}, []
    for label, *case in cases:
        launches[label], got = video_pair(label, *case)
        recs += got
    parity_verdict(recs)
    for label, kernel in (("video_rgb", "packed2kw_best"),
                          ("video_rgb_exact_hi2", "packed3w_best")):
        if not launches[label].get(kernel):
            fail(f"video: {label} launched {launches[label]}, no {kernel}")
    say("video", calls=len(recs), launches=launches,
        s=time.perf_counter() - t0, card=nvidia_smi())


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


def driver_run(label, params, a, ap, b, want=None, **kw):
    """One ``create_image_analogy`` call of the driver phase: every launch
    count set to 0 just before it and read just after (held to ``want``
    when given), the peak device memory reset before it.  Returns (result,
    launches, wall seconds, peak GiB)."""
    import torch

    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.ops import match

    match.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = create_image_analogy(a, ap, b, params, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in match.LAUNCHES.items() if v}
    if want is not None and launches != {k: v for k, v in want.items() if v}:
        fail(f"driver {label}: launched {launches}, expected {want}")
    return (result, launches, wall,
            torch.cuda.max_memory_allocated() / 2**30)


def same_bits(label, res, ref):
    """B', the finest plane and the source map must be the reference's."""
    import numpy as np

    for name in ("bp", "bp_y", "source_map"):
        if not np.array_equal(getattr(res, name), getattr(ref, name)):
            fail(f"driver {label}: {name} differs from the clean run's")


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def phase_driver(a, ap, b):
    """The driver's surroundings on the main path (``PRESETS["npr_1024"]``
    at 1024^2, warm): a clean run, pipelined runs, checkpoints with the log
    and saved levels, then resume and a quarantined level, a retry, the
    watchdog, a profile at 256^2 and the CLI with its new flags."""
    import tempfile

    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.utils.assets import make_structured

    params = PRESETS["npr_1024"]
    want = expected_launches(params, a.shape[0])
    driver_run("cold", params, a, ap, b, want)
    # 1-2: clean and pipelined, in the order clean, pipelined, pipelined,
    # clean (walls and peaks recorded, not claimed)
    walls = []
    ref = None
    for label in ("clean", "pipelined", "pipelined", "clean"):
        p = params.replace(level_sync=False) if label == "pipelined" \
            else params
        res, launches, wall, peak = driver_run(label, p, a, ap, b, want)
        walls.append(dict(run=label, wall_s=wall, peak_mem_gib=peak))
        if ref is None:
            ref = res
            say("driver", step="clean", launches=launches,
                timing=res.timing,
                level_ms={st["level"]: st["ms"] for st in res.stats})
            continue
        same_bits(label, res, ref)
        if label == "pipelined":
            t = res.timing
            need = ("host_gap_ms", "prep_ms", "wait_ms", "host_hidden_ms")
            lookahead = len(res.stats) - 1
            if (t.get("prepped_levels") != lookahead
                    or t.get("donated_levels") != lookahead
                    or any(k not in t for k in need)):
                fail(f"driver pipelined: timing {t}")
            if t["prefetch_errors"]:
                fail(f"driver pipelined: {t['prefetch_errors']:g} "
                     "prefetches raised")
            if not all("enqueue_ms" in st for st in res.stats):
                fail("driver pipelined: a level without enqueue_ms")
            say("driver", step="pipelined", launches=launches, timing=t,
                level_enqueue_ms={st["level"]: st["enqueue_ms"]
                                  for st in res.stats})
    say("driver", step="walls", order=walls)
    res, _, wall, peak = driver_run(
        "undonated", params.replace(donate_buffers=False), a, ap, b, want)
    same_bits("undonated", res, ref)
    if "donated_levels" in res.timing:
        fail(f"driver undonated: timing {res.timing}")
    say("driver", step="undonated", wall_s=wall, peak_mem_gib=peak)
    with tempfile.TemporaryDirectory() as tmp:
        driver_files(params, a, ap, b, ref, want, tmp)
        driver_retry(params, a, ap, b, ref, want, tmp)
        driver_watchdog(params, a, ap, b, ref, want, tmp)
        driver_profile(tmp)
        driver_cli(make_structured(256, 7), tmp)


def driver_files(params, a, ap, b, ref, want, tmp):
    """Step 3: checkpoints, the log and saved levels; a resume; a resume
    past a damaged level 2 (quarantined and recomputed)."""
    ck, lv = os.path.join(tmp, "ck"), os.path.join(tmp, "levels")
    log = os.path.join(tmp, "run.jsonl")
    size = a.shape[0]
    levels = len(ref.stats)
    coarse = list(range(levels - 1, 0, -1))  # what a resume from 0 loads
    p = params.replace(checkpoint_dir=ck, log_path=log, save_levels_dir=lv)
    res, launches, wall, _ = driver_run("checkpointed", p, a, ap, b, want)
    same_bits("checkpointed", res, ref)
    names = [f"level_{i:02d}" for i in range(levels)]
    if sorted(os.listdir(ck)) != [n + ".npz" for n in names] or \
            sorted(os.listdir(lv)) != [n + ".png" for n in names]:
        fail(f"driver checkpointed: files {sorted(os.listdir(ck))}, "
             f"{sorted(os.listdir(lv))}")
    recs = read_log(log)
    keys = ("level", "db_rows", "pixels", "coherence_ratio", "ms", "backend",
            "ts")
    if [r.get("level") for r in recs] != coarse + [0] or not all(
            k in r for r in recs for k in keys):
        fail(f"driver checkpointed: log records {recs}")
    say("driver", step="checkpointed", wall_s=wall, launches=launches,
        npz_bytes=sum(os.path.getsize(os.path.join(ck, f))
                      for f in os.listdir(ck)))
    # resume from level 0: every coarser level from disk, level 0 scanned
    log2 = os.path.join(tmp, "resume.jsonl")
    res, launches, wall, _ = driver_run(
        "resumed", p.replace(resume_from_level=0, log_path=log2), a, ap, b,
        expected_launches(params, size, levels=(0,)))
    same_bits("resumed", res, ref)
    resumed = [r["level"] for r in read_log(log2)
               if r.get("event") == "resume_level"]
    if resumed != coarse:
        fail(f"driver resumed: resume_level records for {resumed}")
    say("driver", step="resumed", wall_s=wall, launches=launches,
        resumed=resumed)
    # damage level 2's file: quarantined, level 2 recomputed
    path = os.path.join(ck, "level_02.npz")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 3)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    log3 = os.path.join(tmp, "quarantine.jsonl")
    res, launches, wall, _ = driver_run(
        "quarantined", p.replace(resume_from_level=0, log_path=log3),
        a, ap, b, expected_launches(params, size, levels=(0, 2)))
    same_bits("quarantined", res, ref)
    recs = read_log(log3)
    resumed = [r["level"] for r in recs if r.get("event") == "resume_level"]
    quarantined = [r["path"] for r in recs
                   if r.get("event") == "ckpt_quarantined"]
    if (resumed != [lvl for lvl in coarse if lvl != 2]
            or quarantined != [path]
            or not os.path.exists(path + ".corrupt")):
        fail(f"driver quarantined: resumed {resumed}, quarantined "
             f"{quarantined}")
    say("driver", step="quarantined", wall_s=wall, launches=launches,
        resumed=resumed, quarantined=[os.path.basename(q)
                                      for q in quarantined])


def driver_retry(params, a, ap, b, ref, want, tmp):
    """Step 4: an injected fault in the first level's first attempt."""
    from image_analogies_tpu_torch.utils import failure

    log = os.path.join(tmp, "retry.jsonl")
    failure.inject_failures(1)
    res, launches, wall, _ = driver_run(
        "retry", params.replace(level_retries=1, log_path=log), a, ap, b,
        want)
    same_bits("retry", res, ref)
    retries = [r for r in read_log(log) if r.get("event") == "level_retry"]
    if len(retries) != 1 or retries[0]["error"] != "InjectedFailure":
        fail(f"driver retry: level_retry records {retries}")
    say("driver", step="retry", wall_s=wall, launches=launches,
        level_retry=retries[0])


def driver_watchdog(params, a, ap, b, ref, want, tmp):
    """Step 5: the first attempt of the coarsest level (4) opens with a
    spin kernel longer than the deadline; the watchdog abandons it and the retry, on a stream
    of its own, gives the clean bits.  The abandoned attempt's launches
    (those after the timeout apart) are counted by thread, beside the
    retry's."""
    import threading

    import torch

    from image_analogies_tpu_torch.backends import cuda as cuda_backend
    from image_analogies_tpu_torch.ops import match

    deadline = 10.0  # above any level's scan (level 0: ~3-6 s)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    cycles_per_s = 100_000_000 / (start.elapsed_time(end) / 1e3)
    spin_s = deadline + 2.0
    top = len(ref.stats) - 1  # the coarsest level, the first dispatched
    key = level_launches(params, a.shape[0])[top][0]
    mark = threading.local()  # set on the thread of the attempt to abandon
    wedged = []
    abandoned = []  # times of the abandoned attempt's launches
    orig = cuda_backend.CudaMatcher.synthesize_level
    kernel = getattr(cuda_backend, key)

    def tally(*args, **kw):
        if getattr(mark, "wedged", False):
            abandoned.append(time.time())
        return kernel(*args, **kw)

    def spin_first(self, db, job):
        if job.level == top and not wedged:
            wedged.append(1)
            mark.wedged = True
            torch.cuda._sleep(int(spin_s * cycles_per_s))
        return orig(self, db, job)

    log = os.path.join(tmp, "watchdog.jsonl")
    cuda_backend.CudaMatcher.synthesize_level = spin_first
    setattr(cuda_backend, key, tally)
    try:
        res, _, wall, _ = driver_run(
            "watchdog", params.replace(level_retries=1,
                                       dispatch_timeout_s=deadline,
                                       log_path=log), a, ap, b)
        for t in threading.enumerate():  # the abandoned attempt runs on
            if t.name == "ia-watchdog-body":
                t.join(timeout=300)
                if t.is_alive():
                    fail("driver watchdog: the abandoned attempt never "
                         "ended")
        torch.cuda.synchronize()
    finally:
        cuda_backend.CudaMatcher.synthesize_level = orig
        setattr(cuda_backend, key, kernel)
    launches = {k: v for k, v in match.LAUNCHES.items() if v}
    same_bits("watchdog", res, ref)
    recs = read_log(log)
    timeouts = [r for r in recs if r.get("event") == "watchdog_timeout"]
    retries = [r for r in recs if r.get("event") == "level_retry"]
    if (len(timeouts) != 1 or len(retries) != 1
            or retries[0]["error"] != "WatchdogTimeout"
            or timeouts[0]["level"] != top):
        fail(f"driver watchdog: records {timeouts}, {retries}")
    late = sum(ts > timeouts[0]["ts"] for ts in abandoned)
    kept = dict(launches, **{key: launches[key] - len(abandoned)})
    if kept != {k: v for k, v in want.items() if v}:
        fail(f"driver watchdog: the run's launches {kept} (the abandoned "
             f"attempt's {len(abandoned)} apart), expected {want}")
    say("driver", step="watchdog", wall_s=wall, deadline_s=deadline,
        spin_s=spin_s, launches_kept=kept,
        abandoned_launches=len(abandoned), abandoned_after_timeout=late,
        watchdog_timeout=timeouts[0], level_retry=retries[0])


def driver_profile(tmp):
    """Step 6: a profiled 256^2 run (every level below the crossover:
    argmin_l2 at every level) writes a trace holding its kernels."""
    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.utils.assets import make_structured

    a, ap, b = make_structured(256, 7)
    prof = os.path.join(tmp, "prof")
    params = PRESETS["npr_1024"].replace(profile_dir=prof)
    t0 = time.perf_counter()
    res, launches, _, _ = driver_run(
        "profiled", params, a, ap, b, expected_launches(params, 256))
    wall = time.perf_counter() - t0
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    if len(traces) != 1:
        fail(f"driver profile: trace files {traces}")
    path = os.path.join(prof, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    argmin = sum("argmin_l2_kernel" in e.get("name", "") for e in kernels)
    if argmin != launches["argmin_l2"]:
        fail(f"driver profile: {argmin} argmin_l2 kernel events in the "
             f"trace, {launches['argmin_l2']} launches")
    say("driver", step="profile", size=256, levels=len(res.stats),
        wall_s=wall, trace_bytes=os.path.getsize(path),
        kernel_events=len(kernels), argmin_kernel_events=argmin,
        launches=launches)


def driver_cli(inputs, tmp):
    """Step 7: the CLI's run with the new flags, as a subprocess."""
    from image_analogies_tpu_torch.utils.imageio import save_image

    paths = {}
    for name, img in zip(("a", "ap", "b"), inputs):
        paths[name] = os.path.join(tmp, f"cli_{name}.png")
        save_image(paths[name], img)
    out = os.path.join(tmp, "cli_out.png")
    ck = os.path.join(tmp, "cli_ck")
    log = os.path.join(tmp, "cli.jsonl")
    cmd = [sys.executable, "-m", "image_analogies_tpu_torch.cli", "run",
           "--mode", "filter", "--a", paths["a"], "--ap", paths["ap"],
           "--b", paths["b"], "--out", out, "--checkpoint-dir", ck,
           "--log-path", log, "--no-level-sync"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"driver cli: exit {proc.returncode}: {proc.stderr[-2000:]}")
    npz = sorted(os.listdir(ck))
    levels = [r["level"] for r in read_log(log)]
    if not os.path.exists(out) or npz != [f"level_{i:02d}.npz"
                                          for i in range(3)] \
            or levels != [2, 1, 0]:
        fail(f"driver cli: out {os.path.exists(out)}, checkpoints {npz}, "
             f"log levels {levels}")
    say("driver", step="cli", wall_s=wall, checkpoints=npz,
        log_levels=levels)


def lane_run(label, params, a, ap, targets, runs=("cold", "warm")):
    """``create_image_analogy_batch`` on the card once per label in
    ``runs``, every launch count set to 0 just before each run and read
    just after: the k-lane run must launch exactly what one singleton of
    the tallest target does (each level's kernel once per wavefront step
    or scan row, for all lanes), and nothing else.  Then each target's
    singleton, warm: every lane's B', source map and coherence (and
    refined) ratios must be its singleton's bits.  Prints the walls, the
    per-lane wall against the singletons' mean, peak memory and the lane
    run's per-level scan and build ms.  Returns the last lane run's
    launches."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch import (create_image_analogy,
                                           create_image_analogy_batch)
    from image_analogies_tpu_torch.ops import match

    want = expected_launches(params, max(b.shape[0] for b in targets))
    walls = {}
    for run in runs:
        match.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = create_image_analogy_batch(a, ap, targets, params)
        torch.cuda.synchronize()
        walls[run] = time.perf_counter() - t0
        launches = dict(match.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for i, res in enumerate(results):
            if isinstance(res, Exception):
                fail(f"lanes {label}: lane {i} failed: {res!r}")
        stats = sorted(results[0].stats, key=lambda st: st["level"])
        say("lanes", run=f"{label} {run}", strategy=params.strategy,
            lanes=len(targets), heights=[b.shape[0] for b in targets],
            wall_s=walls[run], wall_per_lane_s=walls[run] / len(targets),
            level_ms={st["level"]: st["ms"] for st in stats},
            level_build_ms={st["level"]: st["total_ms"] - st["ms"]
                            for st in stats},
            launches={k: v for k, v in launches.items() if v},
            expected_launches=want, peak_mem_gib=peak,
            bits=[bits_digest(res) for res in results])
        for name, n in launches.items():
            if n != want.get(name, 0):
                fail(f"lanes {label}: {name} launched {n} times, expected "
                     f"{want.get(name, 0)} (one per wavefront step or scan "
                     "row, for all lanes)")
    singles, peaks = [], []
    for i, (b, res) in enumerate(zip(targets, results)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ref = create_image_analogy(a, ap, b, params)
        torch.cuda.synchronize()
        singles.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        same = (np.array_equal(res.bp_y.view(np.int32),
                               ref.bp_y.view(np.int32))
                and np.array_equal(res.source_map, ref.source_map)
                and [(st["coherence_ratio"], st.get("refined_ratio"))
                     for st in res.stats]
                == [(st["coherence_ratio"], st.get("refined_ratio"))
                    for st in ref.stats])
        if not same:
            fail(f"lanes {label}: lane {i} differs from its singleton "
                 f"(B' pixels differing: "
                 f"{int((res.bp_y != ref.bp_y).sum())}, source map: "
                 f"{int((res.source_map != ref.source_map).sum())})")
    last = walls[runs[-1]]
    say("lanes", run=f"{label} singletons", strategy=params.strategy,
        singleton_wall_s=singles, singleton_mean_s=sum(singles) / len(
            singles), lane_wall_s=last,
        per_lane_over_singleton=last / len(targets) / (
            sum(singles) / len(singles)),
        singleton_peak_mem_gib=max(peaks), lanes_bit_identical=True)
    return launches


def phase_lanes(a, ap, size=1024):
    """The lane engine on the card: npr_1024 with remap_luminance=False
    (the serve configuration: with the remap on, differing targets refuse
    by design) on seed 7's A and A' and the B planes of LANE_SEEDS, a
    wavefront and a batched lane run (cold, warm, then the singletons), a
    bucketed batched run of heights LANE_HEIGHTS (scaled to the batched
    size: one query bucket at every level, checked here), and a remap-on
    batch, which must refuse (remap_divergence) before any launch.
    ``size`` scales the inputs and heights (a rehearsal on the CPU);
    the batched and bucketed runs take make_structured at
    LANES_BATCHED_SIZE scaled by ``size`` / 1024 (the script's time
    limit).  Returns each run's launches."""
    from image_analogies_tpu_torch import PRESETS, BatchIncompatible
    from image_analogies_tpu_torch import create_image_analogy_batch
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.tune.buckets import (bucket_rows,
                                                        pad_waste_frac)
    from image_analogies_tpu_torch.utils.assets import make_structured

    targets = [make_structured(size, seed)[2] for seed in LANE_SEEDS]
    params = dataclasses.replace(PRESETS["npr_1024"], remap_luminance=False)
    out = {"wavefront": lane_run("wavefront", dataclasses.replace(
        params, strategy="wavefront"), a, ap, targets)}
    size = LANES_BATCHED_SIZE * size // 1024
    if size != len(a):
        a, ap = make_structured(size, 7)[:2]
        targets = [make_structured(size, seed)[2] for seed in LANE_SEEDS]
    out["batched"] = lane_run("batched", dataclasses.replace(
        params, strategy="batched"), a, ap, targets)

    heights = [h * size // 1024 for h in LANE_HEIGHTS]
    cropped = [b[:h] for b, h in zip(targets, heights)]
    buckets, waste, hs = [], 0.0, heights
    for level in range(params.levels):
        if level:
            hs = [(h + 1) // 2 for h in hs]
        w = size >> level
        bks = {bucket_rows(h * w) for h in hs}
        if len(bks) != 1:
            fail(f"lanes: heights {hs} at level {level} span buckets {bks}")
        buckets.append(bks.pop())
        if level == 0:
            waste = max(pad_waste_frac(h * w) for h in hs)
    say("lanes", bucketed_heights=heights, buckets=buckets, pad_waste=waste)
    out["bucketed"] = lane_run("bucketed", dataclasses.replace(
        params, strategy="batched", shape_buckets=True), a, ap, cropped,
        runs=("first",))

    match.reset_launch_counts()
    try:
        create_image_analogy_batch(a, ap, targets, PRESETS["npr_1024"])
    except BatchIncompatible as e:
        reason = e.reason
    else:
        reason = None
    launched = {k: v for k, v in match.LAUNCHES.items() if v}
    say("lanes", remap_on_refused=reason, launches=launched)
    if reason != "remap_divergence" or launched:
        fail(f"lanes: a remap-on batch gave {reason!r} after launches "
             f"{launched}; it must refuse (remap_divergence) before any")
    return out


def cli_json(phase, args, timeout=900):
    """``python -m image_analogies_tpu_torch.cli ARGS`` as a subprocess of
    this checkout; fails unless it exits 0.  Returns (its stdout parsed as
    one JSON document, seconds)."""
    return cli_wait(phase, cli_start(args), timeout)


def cli_start(args):
    """Start ``python -m image_analogies_tpu_torch.cli ARGS`` as a
    subprocess of this checkout and return at once (for a command that
    needs no card: it runs on the host's cores while the card works)."""
    cmd = [sys.executable, "-m", "image_analogies_tpu_torch.cli", *args]
    return (subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            args, time.perf_counter())


def cli_wait(phase, started, timeout=900):
    """Wait for a subprocess of :func:`cli_start`; fails unless it exits
    0.  Returns (its stdout parsed as one JSON document, seconds from its
    start)."""
    proc, args, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{phase}: {' '.join(args[:2])} ran past {timeout} s")
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{phase}: {' '.join(args[:2])} exit {proc.returncode}: "
             f"{err[-2000:]}")
    return json.loads(out), secs


def tune_sweeps(tmp):
    """Steps 1-2 of the tune phase: the dry run (on the host's cores beside
    the live runs: it touches no card), then two live runs into a fresh
    store.  Returns the store's path."""
    dry = cli_start(["tune", "--dry-run"])
    store = os.path.join(tmp, "tune.json")
    runs = []
    for i in (1, 2):
        res, secs = cli_json("tune", ["tune", "--store", store])
        runs.append(res)
        for sw in res["sweeps"]:
            say("tune", step=f"sweep {i}", kernel=sw["kernel"], s=secs,
                card=res["device_kind"], power_limit=res.get("power_limit"),
                verified=sw["verified"], winner=sw["winner"],
                winner_ms=sw["winner_ms"],
                winner_spread_ms=sw["winner_spread_ms"],
                default_ms=sw.get("default_ms"),
                beats_default_by_more_than_spread=sw.get(
                    "beats_default_by_more_than_spread"),
                candidates=[[r["candidate"], r["ms"], r["spread_ms"],
                             r["same_bits"], r["plan"]]
                            for r in sw["results"]])
            if not sw["verified"]:
                fail(f"tune: the {sw['kernel']} candidates gave different "
                     "bits")
        if not res["persisted"]:
            fail("tune: verified winners were not persisted")
    plan, secs = cli_wait("tune", dry)
    say("tune", step="dry_run", s=secs, device_kind=plan["device_kind"],
        sweeps={sw["kernel"]: dict(knobs=sw["knobs"],
                                   candidates=len(sw["candidates"]),
                                   shape=sw["shape"])
                for sw in plan["sweeps"]})
    same = {a["kernel"]: a["winner"] == b["winner"]
            for a, b in zip(runs[0]["sweeps"], runs[1]["sweeps"])}
    with open(store) as f:
        say("tune", step="winners", same_winner_both_runs=same,
            store=json.load(f)["entries"])
    return store


def tune_main_runs(a, ap, b, tmp, store):
    """Step 3: npr_1024 with metrics=True, empty store, tuned, tuned,
    empty, each held to the main path's digest and launches, its counters
    to ``LAUNCHES`` and ``max_memory_allocated``, its manifest and log to
    the store it ran with."""
    import torch

    from image_analogies_tpu_torch import PRESETS, create_image_analogy
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.tune import resolve as tresolve

    base = PRESETS["npr_1024"]
    want = {k: v for k, v in expected_launches(base, 1024).items() if v}
    empty = os.path.join(tmp, "empty.json")  # never written
    with open(store) as f:
        entries = json.load(f)["entries"]
    for i, (label, path) in enumerate((("empty", empty), ("tuned", store),
                                       ("tuned", store), ("empty", empty))):
        os.environ["IA_TUNE_STORE"] = path
        tresolve.reset_provenance()
        log = os.path.join(tmp, f"main_{i}.jsonl")
        params = dataclasses.replace(base, metrics=True, log_path=log)
        match.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = create_image_analogy(a, ap, b, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in match.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        recs = read_log(log)
        man = [r for r in recs if r.get("event") == "run_manifest"]
        snap = [r for r in recs if r.get("event") == "run_end"][-1]["metrics"]
        counters, gauges = snap["counters"], snap["gauges"]
        counted = {k[len("launch."):]: v for k, v in counters.items()
                   if k.startswith("launch.")}
        resolved = {r["key"]: {k: r[k] for k in ("chunks_per_sm",
                                                 "ring_stages", "origin")}
                    for r in recs if r.get("event") == "tune_resolved"}
        stats = sorted(res.stats, key=lambda st: st["level"])
        say("tune", step=f"main {label}", wall_s=wall,
            bits=bits_digest(res),
            level_ms={st["level"]: st["ms"] for st in stats},
            launches=launches, launch_counters=counted,
            kernel_flops=counters.get("kernel.flops"),
            kernel_bytes=counters.get("kernel.bytes"),
            hbm_peak_d0=gauges.get("hbm.peak_bytes.d0"), peak=peak,
            manifest={k: man[0].get(k) for k in (
                "tune_store", "tune_entries", "device_kind", "power_limit",
                "capability")} if man else None,
            resolved=resolved)
        if bits_digest(res) != MAIN_DIGEST:
            fail(f"tune: main {label} bits {bits_digest(res)} != "
                 f"{MAIN_DIGEST}")
        if launches != want or counted != launches:
            fail(f"tune: main {label} launched {launches} (counted "
                 f"{counted}), expected {want}")
        if gauges.get("hbm.peak_bytes.d0") != float(peak):
            fail(f"tune: main {label} hbm.peak_bytes.d0 "
                 f"{gauges.get('hbm.peak_bytes.d0')} != {peak}")
        n_entries = len(entries) if label == "tuned" else 0
        if (len(man) != 1 or man[0].get("tune_store") != path
                or man[0].get("tune_entries") != n_entries or not resolved):
            fail(f"tune: main {label}: manifest {man} or resolved keys "
                 f"{list(resolved)} do not name the store {path}")
        hits = [key for key, r in resolved.items()
                if "store_wildcard" in r["origin"].values()]
        if (label == "tuned") != bool(hits):
            fail(f"tune: main {label}: store hits {hits}")
    os.environ.pop("IA_TUNE_STORE")


def tune_warmups(tmp):
    """Step 4: ``ia warmup`` twice into one fresh library directory."""
    from image_analogies_tpu_torch.backends.cuda import resolve_match_mode

    libs = {"exact_hi": "argmin_l2", "exact_hi2_2p": "packed2k_best"}
    want = len({libs[resolve_match_mode("auto", h * h)] for h in (256, 128)})
    cache = os.path.join(tmp, "libs")
    args = ["warmup", "--size", "256x256", "--levels", "2",
            "--compile-cache-dir", cache]
    first, s1 = cli_json("tune", args)
    built = sorted(f for f in (os.listdir(cache) if os.path.isdir(cache)
                               else ()) if f.endswith(".so"))
    second, s2 = cli_json("tune", args)
    say("tune", step="warmup", first=first, first_s=s1, second=second,
        second_s=s2, libraries=built, want=want)
    if (first["compile_count"] != want or len(built) != want
            or first["compile_cache_hits"] != 0
            or second["compile_count"] != 0
            or second["compile_cache_hits"] != want):
        fail(f"tune: warmup built {first['compile_count']} and found "
             f"{second['compile_cache_hits']} of {want} libraries")


def tune_buckets():
    """Step 5: npr_1024 on make_structured(1000, 7), wavefront and batched,
    unbucketed then bucketed: the same bits and launches; the packed2k and
    argmin_l2 launches of the bucketed wavefront move more bytes (their
    DB rows padded to the buckets)."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch import PRESETS, create_image_analogy
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.tune.buckets import bucket_rows
    from image_analogies_tpu_torch.utils.assets import make_structured

    a, ap, b = make_structured(BUCKET_SIZE, 7)
    sizes = [BUCKET_SIZE]
    for _ in range(PRESETS["npr_1024"].levels - 1):
        sizes.append((sizes[-1] + 1) // 2)
    say("tune", step="buckets", a_rows=[h * h for h in sizes],
        buckets=[bucket_rows(h * h) for h in sizes])
    for strategy in ("wavefront", "batched"):
        out = {}
        for bucketed in (False, True):
            params = dataclasses.replace(
                PRESETS["npr_1024"], strategy=strategy, metrics=True,
                shape_buckets=bucketed)
            match.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with obs_trace.run_scope(params):  # the run joins it
                res = create_image_analogy(a, ap, b, params)
                kbytes = obs_metrics.snapshot()["counters"].get(
                    "kernel.bytes")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out[bucketed] = (res, {k: v for k, v in match.LAUNCHES.items()
                                   if v}, kbytes)
            say("tune", step=f"buckets {strategy}", bucketed=bucketed,
                wall_s=wall, bits=bits_digest(res), launches=out[bucketed][1],
                kernel_bytes=kbytes,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        (r0, l0, k0), (r1, l1, k1) = out[False], out[True]
        if not (np.array_equal(r0.bp_y.view(np.int32), r1.bp_y.view(np.int32))
                and np.array_equal(r0.source_map, r1.source_map)
                and l0 == l1):
            fail(f"tune: bucketed {strategy} differs from unbucketed "
                 f"(B' pixels {int((r0.bp_y != r1.bp_y).sum())}, source map "
                 f"{int((r0.source_map != r1.source_map).sum())}, launches "
                 f"{l0} vs {l1})")
        if strategy == "wavefront" and not (k0 and k1 and k1 > k0):
            fail(f"tune: the bucketed wavefront's kernels moved {k1} bytes "
                 f"against {k0}: its DB rows were not padded")


def phase_tune(a, ap, b):
    """The tune phase (see the module docstring, 16)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        store = tune_sweeps(tmp)
        tune_main_runs(a, ap, b, tmp, store)
        tune_warmups(tmp)
    tune_buckets()
    say("tune", phase_s=time.perf_counter() - t0)


def ann_run(label, params, a, ap, b, runs=("first",), keep_levels=False):
    """``create_image_analogy`` with ``params`` and metrics on, inside a run
    scope of its own, once per label in ``runs``, every launch count set to
    0 just before each run and read just after.  Prints each run's wall,
    bits, per-level ms, build ms (total_ms - ms) and mode, its launches,
    its ``ann.*`` counters and peak memory.  Returns (the last result, its
    launches, its ann counters)."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.ops import match

    params = dataclasses.replace(params, metrics=True)
    for run in runs:
        match.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with obs_trace.run_scope(params) as ctx:
            result = create_image_analogy(a, ap, b, params,
                                          keep_levels=keep_levels)
            torch.cuda.synchronize()
            counters = {k: v for k, v in ctx.registry.snapshot()[
                "counters"].items() if k.startswith("ann.")}
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in match.LAUNCHES.items() if v}
        stats = sorted(result.stats, key=lambda st: st["level"])
        say("ann", run=f"{label} {run}", size=a.shape[0],
            strategy=params.strategy, wall_s=wall, bits=bits_digest(result),
            level_ms={st["level"]: st["ms"] for st in stats},
            level_build_ms={st["level"]: st["total_ms"] - st["ms"]
                            for st in stats},
            level_mode={st["level"]: st.get("match_mode", st["strategy"])
                        for st in stats},
            launches=launches, counters=counters,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not bool(np.isfinite(result.bp_y).all()):
        fail(f"ann {label}: B' is not finite")
    return result, launches, counters


def _ann_modes(result):
    return [st.get("match_mode") for st in sorted(result.stats,
                                                  key=lambda s: s["level"])]


def ann_gate(dev):
    """The gate in force at ANN_GATE_SIZE: both strategies' verdicts on this
    card, then a run each whose levels must run what the verdict allows."""
    import numpy as np

    from image_analogies_tpu_torch import PRESETS, create_image_analogy
    from image_analogies_tpu_torch.backends import gate
    from image_analogies_tpu_torch.backends.cuda import resolve_match_mode
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.utils.assets import make_structured

    gate.reset_ann_gate()
    a, ap, b = make_structured(ANN_GATE_SIZE, 7)
    for strategy in ("wavefront", "batched"):
        params = dataclasses.replace(PRESETS["npr_1024"], strategy=strategy,
                                     ann_prefilter=True)
        match.reset_launch_counts()
        t0 = time.perf_counter()
        allowed = gate.ann_gate_allows(params, dev, strategy)
        say("ann", gate=strategy, device=gate.device_key(dev),
            probe_s=time.perf_counter() - t0,
            probe_launches={k: v for k, v in match.LAUNCHES.items() if v},
            **gate.ann_gate_verdict(dev, strategy))
        res, launches, counters = ann_run(f"gate {strategy}", params, a, ap,
                                          b)
        levels = len(res.stats)
        if strategy == "wavefront":
            want = ["ann_rescue" if allowed else resolve_match_mode(
                "auto", (ANN_GATE_SIZE >> lv) ** 2) for lv in range(levels)]
            if _ann_modes(res) != want:
                fail(f"ann gate: levels ran {_ann_modes(res)}, the verdict "
                     f"allows {want}")
        elif allowed == bool(launches.get("argmin_l2_bf16")):
            fail(f"ann gate: batched launched {launches} under a verdict "
                 f"{'allowing' if allowed else 'refusing'} the prefilter")
        if allowed and counters.get("ann.prefilter_used") != levels:
            fail(f"ann gate: ann.prefilter_used {counters} at {levels} "
                 "levels")
        if not allowed:
            ref = create_image_analogy(a, ap, b, dataclasses.replace(
                params, ann_prefilter=False))
            if not (np.array_equal(ref.bp_y.view(np.int32),
                                   res.bp_y.view(np.int32))
                    and np.array_equal(ref.source_map, res.source_map)):
                fail(f"ann gate: a refused {strategy} run differs from the "
                     "run without the flag")


def ann_stage_times():
    """Stage 1 and 2 alone at the level-0 wavefront shape (M = 352, N =
    2^20, F = 68, Kp = 32; seeded, 8 rows tied at the slab boundary):
    CUDA-event ms of the product with its half-norm subtract, of
    ``torch.topk(65)`` over the scores, of the whole of stage 1 (with the
    tie fix-up and its host sync) and of stage 2, beside stage 1's bound
    (2 M N Kp fp32 operations; the bytes it must move are 0.14 GB)."""
    import torch

    from image_analogies_tpu_torch.ops import ann

    m, n, f, kp, top_m = 352, 1 << 20, 68, 32, 64
    g = torch.Generator(device="cuda").manual_seed(5)
    dev = torch.device("cuda", 0)
    q = torch.randn((m, f), generator=g, device=dev)
    proj = torch.linalg.qr(torch.randn((f, kp), generator=g, device=dev))[0]
    mean = 0.1 * torch.randn((f,), generator=g, device=dev)
    dbp = torch.randn((n, kp), generator=g, device=dev)
    dbp[n // 3::n // 100] = dbp[n // 3]  # 67 equal rows
    dbnh = 0.5 * (dbp * dbp).sum(dim=1)
    q[:8] = mean + proj @ dbp[n // 3]
    db = torch.randn((n, f), generator=g, device=dev)
    qp = (q - mean) @ proj

    def product():
        return (qp @ dbp.T).sub_(dbnh[None, :])

    scores = product()
    cand = ann.ann_topm_candidates(q, proj, mean, dbp, dbnh, n, top_m)
    times = {
        "product_ms": cuda_time_ms(product, 10),
        "topk_ms": cuda_time_ms(lambda: torch.topk(scores, top_m + 1,
                                                   dim=1), 10),
        "stage1_ms": cuda_time_ms(lambda: ann.ann_topm_candidates(
            q, proj, mean, dbp, dbnh, n, top_m), 10),
        "stage2_ms": cuda_time_ms(lambda: ann.ann_rescore_slab(
            q, db, cand, n), 10)}
    b_ms, b_by = bound(0.14e9, 2.0 * m * n * kp, PEAK_FP32_FLOP_S)
    say("ann", stage_shape=dict(m=m, n=n, f=f, kp=kp, top_m=top_m),
        **times, stage1_bound_ms=b_ms, stage1_bound_by=b_by)


def ann_full_width(a, ap, b, tmp):
    """The gate bypassed at 1024^2: the wavefront with its bases built
    fresh on the card (what ``--ann-prefilter`` alone gives; audited), then
    again from the bases ``build_style`` sealed on the host, which must
    give the same bits; batched once, its bases built fresh on the card;
    four wavefront lanes at ANN_LANE_SIZE against their singletons."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch import (PRESETS, create_image_analogy,
                                           create_image_analogy_batch)
    from image_analogies_tpu_torch.backends import cuda as tcuda
    from image_analogies_tpu_torch.backends import gate
    from image_analogies_tpu_torch.catalog import build as catalog_build
    from image_analogies_tpu_torch.utils.assets import make_structured
    from image_analogies_tpu_torch.utils.ssim import ssim

    params = dataclasses.replace(PRESETS["npr_1024"], ann_prefilter=True)
    root = os.path.join(tmp, "cat1024")
    with gate.ann_gate_bypass():
        fresh, launches, counters = ann_run("wavefront fresh", params, a,
                                            ap, b, keep_levels=True)
        if (set(_ann_modes(fresh)) != {"ann_rescue"} or launches
                or counters.get("ann.prefilter_used") != params.levels
                or counters.get("ann.projection_built") != params.levels
                or "ann.artifact_hits" in counters):
            fail(f"ann: the 1024^2 wavefront ran {_ann_modes(fresh)}, "
                 f"launched {launches}, counted {counters}")
        phase_oracle(a, ap, b, params, fresh, phase="ann",
                     ssim_min=PROBE_SSIM_MIN, unexplained_max=None)
        t0 = time.perf_counter()
        catalog_build.build_style(a, ap, PRESETS["npr_1024"], root_dir=root,
                                  target=b)
        say("ann", catalog_1024_build_s=time.perf_counter() - t0)
        sealed = dataclasses.replace(params, catalog_dir=root)
        res, launches, counters = ann_run("wavefront sealed", sealed, a,
                                          ap, b)
        same = (np.array_equal(res.bp_y.view(np.int32),
                               fresh.bp_y.view(np.int32))
                and np.array_equal(res.source_map, fresh.source_map))
        say("ann", sealed_bits_equal_fresh=same)
        if (set(_ann_modes(res)) != {"ann_rescue"} or launches
                or counters.get("ann.prefilter_used") != params.levels
                or counters.get("ann.artifact_hits") != params.levels
                or "ann.projection_built" in counters or not same):
            fail(f"ann: the sealed 1024^2 wavefront ran {_ann_modes(res)}, "
                 f"launched {launches}, counted {counters}, bits equal to "
                 f"the fresh bases' run: {same}")
        del res, fresh
        bparams = dataclasses.replace(params, strategy="batched")
        bsize = ANN_BATCHED_SIZE * len(a) // 1024
        ba, bap, bb = ((a, ap, b) if bsize == len(a)
                       else make_structured(bsize, 7))
        res, launches, counters = ann_run("batched", bparams, ba, bap, bb)
        if (launches or counters.get("ann.prefilter_used") != params.levels
                or counters.get("ann.projection_built") != params.levels):
            fail(f"ann: the {bsize}^2 batched run launched {launches}, "
                 f"counted {counters}")
        if bsize == 1024:
            ref = np.load(os.path.join(HERE, "bench_cache",
                                       "oracle_1024_seed7.npz"))["bp_y"]
        else:  # no oracle at this size: the exact batched path's plane
            ref = create_image_analogy(ba, bap, bb, dataclasses.replace(
                bparams, ann_prefilter=False)).bp_y
        say("ann", batched_size=bsize, batched_ssim_vs_reference=ssim(
            res.bp_y, ref), reference="oracle" if bsize == 1024
            else "exact batched")
        del res

        size = ANN_LANE_SIZE
        la, lap = (a, ap) if size == 1024 else make_structured(size, 7)[:2]
        targets = [make_structured(size, s)[2] for s in LANE_SEEDS]
        lparams = dataclasses.replace(params, remap_luminance=False)
        rows = []
        real = tcuda.ann_topm_candidates

        def spy(queries, *args):
            rows.append(int(queries.shape[0]))
            return real(queries, *args)

        tcuda.ann_topm_candidates = spy
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lanes = create_image_analogy_batch(la, lap, targets, lparams)
            torch.cuda.synchronize()
            lane_wall = time.perf_counter() - t0
            lane_peak = torch.cuda.max_memory_allocated() / 2**30
            lane_rows = list(rows)
            rows.clear()
            singles, walls = [], []
            for tb in targets:
                t0 = time.perf_counter()
                singles.append(create_image_analogy(la, lap, tb, lparams))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        finally:
            tcuda.ann_topm_candidates = real
        per = len(rows) // len(targets)
        same = []
        for res, ref in zip(lanes, singles):
            if isinstance(res, Exception):
                fail(f"ann lanes: a lane failed: {res!r}")
            same.append(bool(np.array_equal(res.bp_y.view(np.int32),
                                            ref.bp_y.view(np.int32))
                             and np.array_equal(res.source_map,
                                                ref.source_map)))
        stats = sorted(lanes[0].stats, key=lambda st: st["level"])
        say("ann", lanes=len(targets), size=size, lane_wall_s=lane_wall,
            singleton_wall_s=walls, lane_peak_mem_gib=lane_peak,
            level_ms={st["level"]: st["ms"] for st in stats},
            stage1_calls=len(lane_rows), singleton_stage1_calls=per,
            stage1_rows_max=max(lane_rows),
            singleton_stage1_rows_max=max(rows[:per]),
            lanes_bits_equal_singletons=same,
            bits=[bits_digest(r) for r in lanes])
        if len(lane_rows) != per or max(lane_rows) != len(targets) * max(
                rows[:per]):
            fail("ann lanes: the lanes did not share one stage-1 product a "
                 "step")


def ann_catalog_start(tmp):
    """Write the catalog mechanics' planes (make_structured at
    ANN_CATALOG_SIZE) under ``tmp`` and start ``ia catalog build`` on them
    (host only: it runs while the card works).  Returns what
    :func:`ann_catalog` takes."""
    import numpy as np

    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.utils.assets import make_structured

    planes = make_structured(ANN_CATALOG_SIZE, 7)
    paths = []
    for name, x in zip(("a", "ap", "b"), planes):
        paths.append(os.path.join(tmp, f"{name}.npy"))
        np.save(paths[-1], x)
    root = os.path.join(tmp, "cat")
    started = cli_start(["catalog", "build", "--a", paths[0], "--ap",
                         paths[1], "--b", paths[2], "--dir", root,
                         "--levels", str(PRESETS["npr_1024"].levels)])
    return planes, root, started


def ann_catalog(planes, root, started):
    """The catalog mechanics at ANN_CATALOG_SIZE, the gate bypassed, on
    the catalog :func:`ann_catalog_start` built."""
    import numpy as np

    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.backends import gate
    from image_analogies_tpu_torch.backends.cuda import resolve_match_mode
    from image_analogies_tpu_torch.catalog import ann as catalog_ann

    size = ANN_CATALOG_SIZE
    params = dataclasses.replace(PRESETS["npr_1024"], ann_prefilter=True,
                                 catalog_dir=root)
    rep, secs = cli_wait("ann", started)
    levels = rep["levels"]
    bases = sorted(os.listdir(os.path.join(root, catalog_ann.ANN_DIR)))
    say("ann", catalog_build_s=secs, size=size, levels=levels,
        entries=len(rep["entries"]), bases=len(bases),
        ann_dims=[e["ann_dims"] for e in rep["entries"]])
    if len(rep["entries"]) != levels or len(bases) != levels:
        fail(f"ann catalog: {len(rep['entries'])} entries and {len(bases)} "
             f"bases for {levels} levels")
    with gate.ann_gate_bypass():
        first, launches, c = ann_run("catalog", params, *planes)
        if (c.get("ann.artifact_hits") != levels
                or "ann.projection_built" in c or launches):
            fail(f"ann catalog: counted {c}, launched {launches}")
        key0 = next(e["key"] for e in rep["entries"] if e["level"] == 0)
        path = catalog_ann.artifact_path(root, key0)
        catalog_ann.damage_artifact(path, seed=3)
        hurt, launches, c = ann_run("catalog damaged", params, *planes)
        want0 = resolve_match_mode("auto", size * size)
        if (_ann_modes(hurt)[0] != want0
                or set(_ann_modes(hurt)[1:]) != {"ann_rescue"}
                or not os.path.exists(path + ".corrupt")
                or not os.path.exists(path)
                or c.get("ann.fallback_exact") != 1
                or c.get("ann.artifacts_rebuilt") != 1
                or c.get("ann.artifact_hits") != levels - 1):
            fail(f"ann catalog: the damaged basis ran {_ann_modes(hurt)} "
                 f"and counted {c}")
        again, launches, c = ann_run("catalog recovered", params, *planes)
        same = (np.array_equal(again.bp_y.view(np.int32),
                               first.bp_y.view(np.int32))
                and np.array_equal(again.source_map, first.source_map))
        say("ann", catalog_recovered_bits_equal_first=same)
        if c.get("ann.artifact_hits") != levels or not same:
            fail(f"ann catalog: the resealed catalog counted {c}, bits "
                 f"equal to the first run's: {same}")


def phase_ann(a, ap, b):
    """The ann phase (see the module docstring, 17)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        catalog = ann_catalog_start(tmp)
        ann_gate(torch.device("cuda", 0))
        ann_stage_times()
        ann_full_width(a, ap, b, tmp)
        ann_catalog(*catalog)
    res, secs = cli_json("ann", ["tune", "--knob", "ann", "--no-persist",
                                 "--reps", "3"])
    for sw in res["sweeps"]:
        say("ann", tune_s=secs, card=res["device_kind"],
            power_limit=res.get("power_limit"), verified=sw["verified"],
            winner=sw["winner"], winner_ms=sw["winner_ms"],
            default_ms=sw["default_ms"],
            beats_default_by_more_than_spread=sw[
                "beats_default_by_more_than_spread"],
            candidates=[[r["candidate"]["ann_top_m"], r["ms"],
                         r["spread_ms"], r["tie_ok"], r["mismatches"],
                         r["unexplained"]] for r in sw["results"]])
        default = [r for r in sw["results"]
                   if r["candidate"]["ann_top_m"] == DEFAULT_ANN_TOP_M]
        if not (default and default[0]["tie_ok"]):
            fail(f"ann tune: the default slab {DEFAULT_ANN_TOP_M} is not "
                 f"tie-clean on the probe pair: {default}")
    say("ann", phase_s=time.perf_counter() - t0)


# the mesh phase's sizes below 1024^2: batched and the query-parallel
# wavefront at 512^2, the frame-sharded clip at 256^2 (frames 0-2)
MESH_SIZE = 512
MESH_VIDEO_SIZE = 256
MESH_BATCHED_SSIM_MIN = 0.99  # tests/test_sharded.py's limits
MESH_BATCHED_AGREE_MIN = 0.95
MESH_VIDEO_ATOL = 1e-5


def mesh_nccl():
    """NCCL in a world of one, in this process: the sharded argmin
    (HIGHEST: ``argmin_l2``; DEFAULT: ``argmin_l2_bf16``), the packed
    all-reduce (packed2k) and the ring at the main path's level-0 and
    level-2 shapes, each pick held to the single-card kernel's on the same
    inputs, through real NCCL collectives."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.parallel import sharded_match as sm
    from image_analogies_tpu_torch.parallel.launch import _free_port

    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        g = dist.group.WORLD
        got = {}
        shapes = (("level 2", ARGMIN_SHAPE["m"], ARGMIN_SHAPE["npad"]),
                  ("level 0", PACKED_SHAPE["m"], PACKED_SHAPE["npad"]))
        for name, m, npad in shapes:
            q, db, dbn, _, _ = argmin_operands(m, npad)
            q, db, dbn = (torch.from_numpy(x).to(dev) for x in (q, db, dbn))
            ref, _ = match.argmin_l2(q, db, dbn)
            idx, _ = sm.local_argmin_allreduce(q, db, dbn, g)
            ring, _ = sm.make_ring_argmin(g)(q, db, dbn)
            dbh = db.to(torch.bfloat16)
            ref_h, _ = match.prepadded_argmin_queries(q, dbh, dbn)
            idx_h, _ = sm.local_argmin_allreduce(q, dbh, dbn, g,
                                                 precision="default")
            got[f"argmin {name}"] = bool(torch.equal(idx, ref))
            got[f"ring {name}"] = bool(torch.equal(ring, ref))
            got[f"argmin_bf16 {name}"] = bool(torch.equal(idx_h, ref_h))
        for level in PACKED_LEVELS:
            npad = PACKED_SHAPE["npad"] >> (2 * level)
            m = PACKED_SHAPE["m"] >> level
            wk, shift, x_lo, _, _ = packed_db(match, npad)
            qa = packed_queries(match, m, shift, x_lo, wk.shape[1])
            lw = PACKED_SHAPE["lw"]
            ref, _ = match.packed_best(qa, wk, (4 * lw + 3 + 15) // 16 * 16)
            q1, q2 = qa[:, :lw].contiguous(), qa[:, 2 * lw + 3:3 * lw + 3]
            idx, _ = sm.packed_champion_allreduce(q1, q2.contiguous(), wk, g)
            got[f"packed level {level}"] = bool(torch.equal(idx, ref))
        say("mesh", nccl_version=".".join(
            str(v) for v in torch.cuda.nccl.version()), world=1,
            picks_equal_single_card=got)
        if not all(got.values()):
            fail(f"mesh: NCCL world-of-one picks differ from the single "
                 f"card's: {got}")
    finally:
        dist.destroy_process_group()


def mesh_rank(rank, out_dir):
    """One rank of the mesh phase's gloo world (two ranks on cuda:0): the
    npr_1024 wavefront at db_shards=2 on the seed-7 oracle's inputs (rank
    0 writes its planes for the parent's audit, then goes on), batched at
    db_shards=2 and the query-parallel wavefront (data_shards=2) at
    MESH_SIZE^2, and the frame-sharded two_phase clip (data_shards=2) at
    MESH_VIDEO_SIZE^2.  Each run: every launch count, the staged bytes
    and the peak memory set to 0 just before it and read just after."""
    import numpy as np
    import torch

    from image_analogies_tpu_torch import (PRESETS, create_image_analogy,
                                           video_analogy)
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.parallel import mesh as pmesh
    from image_analogies_tpu_torch.utils.assets import (make_all,
                                                        make_structured)

    out = {}
    go = os.path.join(out_dir, "go")
    while not os.path.exists(go):  # the parent's single-card runs first
        time.sleep(0.1)

    def run(label, fn):
        match.reset_launch_counts()
        pmesh.reset_staged()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, extra = fn()
        torch.cuda.synchronize()
        out[label] = dict(
            wall_s=time.perf_counter() - t0,
            launches={k: v for k, v in match.LAUNCHES.items() if v},
            staged_bytes=pmesh.STAGED["bytes"],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, **extra)
        return res

    a, ap, b = make_structured(1024, 7)
    params = dataclasses.replace(PRESETS["npr_1024"], db_shards=2)

    def wavefront():
        with obs_trace.run_scope(dataclasses.replace(params,
                                                     metrics=True)) as ctx:
            res = create_image_analogy(a, ap, b, params, keep_levels=True)
            counters = ctx.registry.snapshot()["counters"]
        stats = sorted(res.stats, key=lambda st: st["level"])
        return res, dict(
            bits=bits_digest(res),
            level_ms={st["level"]: st["ms"] for st in stats},
            level_build_ms={st["level"]: st["total_ms"] - st["ms"]
                            for st in stats},
            level_mode={st["level"]: st["match_mode"] for st in stats},
            psum_gather_bytes=counters.get("mesh.psum_gather_bytes"),
            level_steps=counters.get("mesh.level_steps"))

    res = run("wavefront 1024", wavefront)
    if rank == 0:
        levels = {f"{k}_l{i}": x for i, (bp, sm) in enumerate(res.levels)
                  for k, x in (("bp", bp), ("s", sm))}
        path = os.path.join(out_dir, "wavefront.npz")
        np.savez(path + ".tmp.npz", bp_y=res.bp_y,
                 source_map=res.source_map, **levels)
        os.replace(path + ".tmp.npz", path)
    del res
    size = MESH_SIZE
    sa, sap, sb = make_structured(size, 7)
    for label, kw in (("batched", dict(strategy="batched", db_shards=2)),
                      ("query_parallel", dict(data_shards=2))):
        p = dataclasses.replace(PRESETS["npr_1024"], **kw)
        res = run(f"{label} {size}", lambda: (
            create_image_analogy(sa, sap, sb, p, keep_levels=True), {}))
        out[f"{label} {size}"].update(
            bits=bits_digest(res), bp_y=res.bp_y, source_map=res.source_map,
            levels=res.levels if rank == 0 else None)
    x = make_all(MESH_VIDEO_SIZE, 0)
    frames = [x[f"video_f{t}"] for t in range(3)]
    vp = dataclasses.replace(PRESETS["video"], data_shards=2)
    res = run("video", lambda: (video_analogy(
        x["filter_a"], x["filter_ap"], frames, vp), {}))
    out["video"].update(frames_y=res.frames_y,
                        mesh=[st["mesh"] for st in res.stats][:1])
    return out


def mesh_wait_audit(a, ap, b, params, path, box):
    """Audit the 1024^2 mesh run against the seed-7 oracle as soon as rank
    0 has written its planes, while the ranks go on."""
    import types

    import numpy as np

    while not os.path.exists(path):
        if "error" in box or "out" in box:
            return
        time.sleep(0.5)
    z = np.load(path)
    levels = [(z[f"bp_l{i}"], z[f"s_l{i}"]) for i in range(params.levels)]
    phase_oracle(a, ap, b, params, types.SimpleNamespace(
        bp_y=z["bp_y"], source_map=z["source_map"], levels=levels),
        phase="mesh")


def phase_mesh(a, ap, b):
    """The mesh path (``parallel/``): NCCL in a world of one
    (:func:`mesh_nccl`), then one gloo world of two ranks on cuda:0
    (:func:`mesh_rank`) held to single-card references computed first:
    the npr_1024 wavefront at db_shards=2 (each rank 6,138 packed2k and
    1,783 argmin launches, both ranks the same bits, the oracle's SSIM and
    tie-audit limits, audited here while the ranks go on; whether its bits
    are the main path's), batched at db_shards=2 (one argmin_l2_bf16 a
    scan row; SSIM and source-map agreement against the single card), the
    query-parallel wavefront (the single card's bits, or a first
    divergence that is a tie) and the frame-sharded clip (every frame the
    serial clip's within MESH_VIDEO_ATOL)."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from image_analogies_tpu_torch import (PRESETS, create_image_analogy,
                                           video_analogy)
    from image_analogies_tpu_torch.parallel.launch import spawn_local
    from image_analogies_tpu_torch.utils.assets import (make_all,
                                                        make_structured)
    from image_analogies_tpu_torch.utils.parity import (
        audit_source_map_mismatches)
    from image_analogies_tpu_torch.utils.ssim import ssim

    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="ia_mesh_")
    box = {}

    def world():
        try:
            box["out"] = spawn_local(mesh_rank, 2, backend="gloo",
                                     device="cuda:0", args=(tmp,))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    # the ranks start up (imports, CUDA contexts, kernel libraries) while
    # this process runs NCCL and the single-card references; they run
    # their measured work once told to go, with the card to themselves
    t0 = time.perf_counter()
    th = threading.Thread(target=world)
    th.start()
    params = dataclasses.replace(PRESETS["npr_1024"], db_shards=2)
    try:
        mesh_nccl()
        size = MESH_SIZE
        sa, sap, sb = make_structured(size, 7)
        single = {kw.get("strategy", "wavefront"): create_image_analogy(
            sa, sap, sb, dataclasses.replace(PRESETS["npr_1024"], **kw),
            keep_levels=True) for kw in (dict(strategy="batched"), {})}
        x = make_all(MESH_VIDEO_SIZE, 0)
        frames = [x[f"video_f{t}"] for t in range(3)]
        serial = video_analogy(x["filter_a"], x["filter_ap"], frames,
                               PRESETS["video"])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        open(os.path.join(tmp, "go"), "w").close()
        mesh_wait_audit(a, ap, b, params, os.path.join(tmp,
                                                       "wavefront.npz"), box)
    finally:
        open(os.path.join(tmp, "go"), "w").close()  # never leave ranks waiting
        th.join()
    if "error" in box:
        fail(f"mesh: the gloo world failed: {box['error']!r}")
    outs = box["out"]
    say("mesh", world=2, backend="gloo", device="cuda:0",
        world_s=time.perf_counter() - t0)

    want = expected_launches(params, 1024)
    recs = [o["wavefront 1024"] for o in outs]
    for rank, rec in enumerate(recs):
        say("mesh", run="wavefront 1024", rank=rank, db_shards=2,
            **{k: rec[k] for k in ("wall_s", "bits", "level_ms",
                                   "level_build_ms", "level_mode",
                                   "launches", "peak_mem_gib",
                                   "psum_gather_bytes", "level_steps",
                                   "staged_bytes")},
            expected_launches=want)
        if rec["launches"] != want:
            fail(f"mesh: rank {rank} launched {rec['launches']}, expected "
                 f"{want} (one per wavefront step of its levels)")
    if recs[0]["bits"] != recs[1]["bits"]:
        fail(f"mesh: the ranks' bits differ ({recs[0]['bits']} != "
             f"{recs[1]['bits']})")
    say("mesh", run="wavefront 1024", bits_equal_main_digest=(
        recs[0]["bits"] == MAIN_DIGEST), main_digest=MAIN_DIGEST)

    bparams = dataclasses.replace(PRESETS["npr_1024"], strategy="batched")
    bwant = expected_launches(bparams, size)
    ref = single["batched"]
    for rank, o in enumerate(outs):
        rec = o[f"batched {size}"]
        sv = ssim(ref.bp_y, rec["bp_y"])
        agree = float((ref.source_map == rec["source_map"]).mean())
        say("mesh", run=f"batched {size}", rank=rank, db_shards=2,
            wall_s=rec["wall_s"], launches=rec["launches"],
            expected_launches=bwant, peak_mem_gib=rec["peak_mem_gib"],
            staged_bytes=rec["staged_bytes"], ssim_vs_single=sv,
            agreement=agree, bits_equal_single=(
                rec["bits"] == bits_digest(ref)))
        if rec["launches"] != bwant:
            fail(f"mesh: batched rank {rank} launched {rec['launches']}, "
                 f"expected {bwant} (one per scan row)")
        if not (sv >= MESH_BATCHED_SSIM_MIN
                and agree >= MESH_BATCHED_AGREE_MIN):
            fail(f"mesh: batched at db_shards=2: SSIM {sv:.4f}, agreement "
                 f"{agree:.4f} against the single card")

    ref = single["wavefront"]
    qwant = expected_launches(PRESETS["npr_1024"], size)
    qp = [o[f"query_parallel {size}"] for o in outs]
    same = qp[0]["bits"] == bits_digest(ref)
    tie = None
    if not same:  # the JAX test's rule: the first divergence is a tie
        tie = audit_source_map_mismatches(
            sa, sap, sb, PRESETS["npr_1024"], qp[0]["levels"],
            ref.levels)["first_divergence_is_tie"]
    for rank, rec in enumerate(qp):
        say("mesh", run=f"query_parallel {size}", rank=rank, data_shards=2,
            wall_s=rec["wall_s"], launches=rec["launches"],
            expected_launches=qwant, peak_mem_gib=rec["peak_mem_gib"],
            staged_bytes=rec["staged_bytes"], bits=rec["bits"],
            bits_equal_single=rec["bits"] == bits_digest(ref),
            first_divergence_is_tie=tie)
        if rec["launches"] != qwant:
            fail(f"mesh: query-parallel rank {rank} launched "
                 f"{rec['launches']}, expected {qwant}")
    if qp[1]["bits"] != qp[0]["bits"] or not (same or tie is True):
        fail("mesh: the query-parallel ranks' bits differ, or from the "
             "single card's with a first divergence that is not a tie")

    for rank, o in enumerate(outs):
        rec = o["video"]
        err = max(float(np.abs(f - g).max())
                  for f, g in zip(rec["frames_y"], serial.frames_y))
        say("mesh", run=f"video {MESH_VIDEO_SIZE}", rank=rank,
            data_shards=2, frames=len(rec["frames_y"]), mesh=rec["mesh"],
            wall_s=rec["wall_s"], launches=rec["launches"],
            peak_mem_gib=rec["peak_mem_gib"],
            staged_bytes=rec["staged_bytes"], max_abs_vs_serial=err)
        if len(rec["frames_y"]) != len(frames) or not err <= MESH_VIDEO_ATOL:
            fail(f"mesh: the frame-sharded clip differs from the serial "
                 f"clip by {err}")


# phases a full run starts in child processes of their own once the
# driver phase is done, beside the lanes and tune phases (every one of
# them host-bound, the card idle much of the time): their checks hold
# whatever else runs, their walls are then not alone (``--phases ann`` or
# ``--phases env,mesh`` measures them alone)
SERVE_SIZE = 1024  # check 1: loadgen.selftest at full width
SERVE_N = 4  # its requests (never below two)
SERVE_SMALL = 256  # checks 3 and 4
SERVE_WINDOW_MS = 1000.0  # a batch's window: it closes at max_batch


def serve_counts():
    """The launch counts of this process, nonzero ones only."""
    from image_analogies_tpu_torch.ops import match

    return {k: v for k, v in match.LAUNCHES.items() if v}


def serve_selftest(params):
    """Check 1: ``loadgen.selftest`` at full width, SERVE_N requests of
    one 1024^2 shape class (seed 7), two workers, batches of up to four.
    Every response must be its singleton's bits with no error, the lane
    engine must run (completions > engine launches >= 1), and the card's
    launches of the whole selftest must be what its singleton runs (the
    sequential baseline's SERVE_N, the served run's engine launches and
    one-by-one members) each launch (``expected_launches``).  Returns the
    load and its singleton runs, in load order, which check 5 reuses."""
    import torch

    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.serve import ServeConfig, loadgen
    from image_analogies_tpu_torch.soak.trace import trace_plan

    cfg = ServeConfig(params=params, workers=2, max_batch=4,
                      batch_window_ms=SERVE_WINDOW_MS)
    match.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    baselines = {}
    summary = loadgen.selftest(cfg, SERVE_N, seed=7,
                               shapes=((SERVE_SIZE, SERVE_SIZE),),
                               baselines=baselines)
    torch.cuda.synchronize()
    launched = serve_counts()
    be = summary["batch_engine"]
    single = expected_launches(params, SERVE_SIZE)
    runs = SERVE_N + be["launches"] + be["completed"] - be["lanes"]
    want = {k: v * runs for k, v in single.items()}
    say("serve", check="selftest", size=SERVE_SIZE, n=SERVE_N,
        sequential_s=summary["sequential_s"], served_s=summary["served_s"],
        p50_ms=summary["p50_ms"], p99_ms=summary["p99_ms"],
        queue_ms=summary["queue_ms"], dispatch_ms=summary["dispatch_ms"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        cost_rate_s_per_unit=summary["cost_rate"],
        cost_prior=summary["cost_prior"],
        batch_size_hist=summary["batch_size_hist"], batch_engine=be,
        singleton_launches=single, launches=launched,
        expected_launches=want, bit_identical=summary["bit_identical"],
        errors=summary["errors"], card=nvidia_smi())
    if not summary["bit_identical"] or summary["errors"]:
        fail(f"serve: selftest bit_identical={summary['bit_identical']}, "
             f"errors={summary['errors']}")
    if summary["completed"] != SERVE_N or not \
            summary["completed"] > be["launches"] >= 1:
        fail(f"serve: the lane engine did not run: {be}")
    if launched != want:
        fail(f"serve: the selftest launched {launched}; {runs} singleton "
             f"runs launch {want}")
    # the selftest's own load (loadgen.selftest draws it so)
    load = trace_plan(SERVE_N, ((SERVE_SIZE, SERVE_SIZE),), 7)[0]
    return ([(it["a"], it["ap"], it["b"]) for it in load],
            [baselines[it["index"]] for it in load])


def serve_cli_start(tmp):
    """Check 2: ``cli serve --selftest 12`` at its default shapes, as a
    subprocess (its tune store a file of its own)."""
    cmd = [sys.executable, "-m", "image_analogies_tpu_torch.cli", "serve",
           "--selftest", "12"]
    env = dict(os.environ, IA_TUNE_STORE=os.path.join(tmp, "tune.json"))
    return subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def serve_cli_wait(proc):
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail("serve: cli serve --selftest 12 ran past 600 s")
    if proc.returncode != 0:
        fail(f"serve: cli serve --selftest 12 exit {proc.returncode}: "
             f"{out[-1500:]} {err[-1500:]}")
    summary = json.loads(err.strip().splitlines()[-1])
    say("serve", check="cli_selftest", rc=proc.returncode,
        completed=summary["completed"], errors=summary["errors"],
        bit_identical=summary["bit_identical"],
        fallbacks=summary["batch_engine"]["fallbacks"],
        served_s=summary["served_s"], sequential_s=summary["sequential_s"])


def serve_behaviours(params, a, ap, b):
    """Check 3, at SERVE_SMALL^2: a transient fault retried inside the
    server (the response the library call's bits); an expired deadline
    cancelled before dispatch with no launch; a gated worker's queue of
    one refusing at once; an unmeetable live deadline served degraded
    with the bits of a library run at the degraded params; the breaker
    failing fast after ``breaker_threshold`` failures."""
    import threading

    import numpy as np

    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.serve import (DeadlineExceeded, Rejected,
                                                 Server, ServeConfig)
    from image_analogies_tpu_torch.serve import degrade as serve_degrade
    from image_analogies_tpu_torch.serve.worker import WorkerPool
    from image_analogies_tpu_torch.utils import failure

    ref = create_image_analogy(a, ap, b, params)
    one = dict(workers=1, max_batch=1, batch_window_ms=0.0)

    with Server(ServeConfig(params=params, request_retries=1,
                            **one)) as srv:
        failure.inject_failures(1)
        resp = srv.request(a, ap, b, timeout=300)
    retried = failure._INJECT["n"] == 0 and resp.status == "ok" and \
        np.array_equal(resp.bp, ref.bp)

    with Server(ServeConfig(params=params, **one)) as srv:
        match.reset_launch_counts()
        try:
            srv.request(a, ap, b, deadline_s=0.0, timeout=300)
            expired = "served"
        except DeadlineExceeded:
            expired = "DeadlineExceeded"
        expired_launches = serve_counts()

    gate = threading.Event()
    run_batch = WorkerPool._run_batch

    def gated(self, batch):
        gate.wait(120)
        run_batch(self, batch)

    WorkerPool._run_batch = gated
    try:
        with Server(ServeConfig(params=params, queue_depth=1,
                                **one)) as srv:
            first = srv.submit(a, ap, b)
            while srv.queue_depth:  # the worker pops it and waits
                time.sleep(0.001)
            second = srv.submit(a, ap, b)
            t0 = time.perf_counter()
            try:
                srv.submit(a, ap, b)
                full = "admitted"
            except Rejected as e:
                full = e.reason
            full_ms = (time.perf_counter() - t0) * 1e3
            gate.set()
            queued_ok = all(np.array_equal(f.result(timeout=300).bp, ref.bp)
                            for f in (first, second))
    finally:
        WorkerPool._run_batch = run_batch
        gate.set()

    with Server(ServeConfig(params=params, **one)) as srv:
        # the EWMA set so that full fidelity estimates 8 s against a 3 s
        # deadline; the same levels at patch 3 (9/25 of the work) fit
        srv.cost_model.observe(serve_degrade.work_units(
            a.size, params.levels, params.patch_size), 8.0)
        deg = srv.request(a, ap, b, deadline_s=3.0, timeout=300)
    dref = create_image_analogy(a, ap, b, params.replace(
        levels=deg.degraded["levels"], patch_size=deg.degraded["patch_size"]
    )) if deg.degraded else None
    degraded_ok = dref is not None and np.array_equal(deg.bp, dref.bp)

    with Server(ServeConfig(params=params, request_retries=0,
                            breaker_threshold=2, breaker_cooldown_s=600.0,
                            **one)) as srv:
        failure.inject_failures(2)
        failed = 0
        for _ in range(2):
            try:
                srv.request(a, ap, b, timeout=300)
            except failure.InjectedFailure:
                failed += 1
        match.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            srv.request(a, ap, b, timeout=300)
            fast = "served"
        except Rejected as e:
            fast = e.reason
        fast_ms = (time.perf_counter() - t0) * 1e3
        breaker = srv._pool.breaker.state
        fast_launches = serve_counts()
    failure.inject_failures(0)
    say("serve", check="behaviours", size=len(a), retried_bits_equal=retried,
        expired=expired, expired_launches=expired_launches,
        queue_full=full, queue_full_ms=full_ms, queued_bits_equal=queued_ok,
        degraded=deg.degraded, degraded_bits_equal=degraded_ok,
        breaker_failures=failed, breaker=breaker, breaker_fast=fast,
        breaker_fast_ms=fast_ms, breaker_fast_launches=fast_launches)
    if not retried:
        fail("serve: the injected fault was not retried to the library "
             "call's bits")
    if expired != "DeadlineExceeded" or expired_launches:
        fail(f"serve: an expired deadline gave {expired} after launches "
             f"{expired_launches}")
    if full != "queue_full" or full_ms > 1000 or not queued_ok:
        fail(f"serve: a full queue gave {full} in {full_ms:.1f} ms "
             f"(queued bits equal: {queued_ok})")
    if deg.status != "degraded" or not degraded_ok:
        fail(f"serve: an unmeetable deadline gave {deg.status} "
             f"{deg.degraded} (bits equal: {degraded_ok})")
    if (failed, breaker, fast) != (2, "open", "breaker_open") or \
            fast_launches:
        fail(f"serve: the breaker after {failed} failures is {breaker}, "
             f"the next request {fast}, launches {fast_launches}")


def serve_two_workers(params, planes):
    """Check 4: eight SERVE_SMALL^2 requests over two exemplars (two batch
    keys), four each, on two workers at once: every response must be its
    singleton's bits, at least two lane-engine launches (a key's burst
    may split, as the queue lets a waiting worker lead a follower that
    arrives inside another's window: then one member runs alone), and the
    served run's launches exactly its batches' (each engine launch and
    each lone member a singleton's: ``expected_launches``), which the
    counters under threads must hold."""
    import numpy as np

    from image_analogies_tpu_torch import create_image_analogy
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.serve import Server, ServeConfig

    load = [(a, ap, b) for a, ap, bs in planes for b in bs]
    refs = [create_image_analogy(a, ap, b, params) for a, ap, b in load]
    cfg = ServeConfig(params=params, workers=2, max_batch=4,
                      batch_window_ms=SERVE_WINDOW_MS)
    with Server(cfg) as srv:
        match.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [srv.submit(a, ap, b) for a, ap, b in load]
        resps = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        counters = obs_metrics.snapshot()["counters"]
        launched = serve_counts()
    engine = counters.get("batch.launches", 0)
    runs = engine + len(load) - counters.get("batch.lanes", 0)
    single = expected_launches(params, SERVE_SMALL)
    want = {k: runs * v for k, v in single.items()}
    equal = [bool(np.array_equal(r.bp, f.bp) and
                  np.array_equal(r.bp_y, f.bp_y)) for r, f in
             zip(resps, refs)]
    say("serve", check="two_workers", size=SERVE_SMALL, requests=len(load),
        wall_s=wall, batch_sizes=[r.batch_size for r in resps],
        engine_launches=engine, lanes=counters.get("batch.lanes", 0),
        singleton_launches=single, launches=launched,
        expected_launches=want, bits_equal=equal)
    if not all(equal):
        fail(f"serve: two workers' responses differ from their singletons: "
             f"{equal}")
    if engine < 2 or launched != want:
        fail(f"serve: two batch keys launched {launched} in {engine} "
             f"engine launches; want {want} ({runs} singletons' worth) in "
             "two or more")


SERVE_TRACE = "c5feed0123"  # check 5's caller trace id (X-IA-Trace)
# a Prometheus 0.0.4 sample line: name, optional labels, a float value
PROM_SAMPLE = (r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
               r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
               r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? (\S+)$')


def serve_http_call(base, path, body=None, headers=None):
    """One loopback HTTP call: (status, headers, body bytes)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def prometheus_families(text):
    """The metric families of a Prometheus 0.0.4 exposition, {name:
    (type, help)}; fails on any line the format does not allow (a sample
    of a family with no TYPE line, a value that is not a float)."""
    import re

    fams, sample = {}, re.compile(PROM_SAMPLE)
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            _, kind, name, rest = line.split(" ", 3)
            entry = fams.setdefault(name, ["untyped", ""])
            if kind == "TYPE":
                if rest not in ("counter", "gauge", "histogram", "summary",
                                "untyped"):
                    fail(f"serve: /metrics TYPE line {line!r}")
                entry[0] = rest
            else:
                entry[1] = rest
            continue
        if line.startswith("#") or not line:
            continue
        m = sample.match(line)
        if m is None:
            fail(f"serve: /metrics line {line!r} is not 0.0.4")
        float(m.group(4))
        name = m.group(1)
        base = next((name[:-len(x)] for x in ("_bucket", "_sum", "_count")
                     if name.endswith(x) and name[:-len(x)] in fams), name)
        if base not in fams:
            fail(f"serve: /metrics sample {name} has no TYPE line")
    return {k: tuple(v) for k, v in fams.items()}


class _Killed(BaseException):
    """What a held worker raises once its server is killed and the check
    has resolved its futures: no launch, and the crash containment, with
    nothing left to requeue, lets the thread exit."""


def serve_hold(gate, held, lock):
    """Wrap the two engine entry points the worker calls (the lane engine
    for a batch, ``create_image_analogy`` one by one) so that a worker
    that reaches one holds there: past its members' ``dispatched`` lines,
    before any launch.  Returns the undo."""
    from image_analogies_tpu_torch.batch import engine as batch_engine
    from image_analogies_tpu_torch.models import analogy as models_analogy

    saved = (batch_engine.create_image_analogy_batch,
             models_analogy.create_image_analogy)

    def hold(lanes):
        with lock:
            held.append(lanes)
        gate.wait(600)
        raise _Killed()

    batch_engine.create_image_analogy_batch = \
        lambda a, ap, targets, params, **kw: hold(len(targets))
    models_analogy.create_image_analogy = lambda *a, **kw: hold(1)

    def undo():
        (batch_engine.create_image_analogy_batch,
         models_analogy.create_image_analogy) = saved
    return undo


def serve_journal(params, load, singles):
    """Check 5: check 1's four 1024^2 requests (their derived idempotency
    keys, their singleton runs) through a journaled server (fsync on):
    (a) request 1 POSTed as a frame over HTTP with its key and a trace,
    the archive armed; (b) requests 2-4 in process, the workers held past
    their ``dispatched`` lines and before any launch, then ``kill()``;
    (c) a new server on the directory recovers them; (d) all four keys
    POSTed again dedupe from the journal with no launch; (e) the offline
    readers ``journal inspect``, ``why`` and ``archive inspect`` as
    subprocesses."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from image_analogies_tpu_torch.obs import archive as obs_archive
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.serve import Server, ServeConfig, batcher
    from image_analogies_tpu_torch.serve import journal as sj
    from image_analogies_tpu_torch.serve import wire
    from image_analogies_tpu_torch.serve.http import serve_http

    jdir = tempfile.mkdtemp(prefix="ia_journal_")
    adir = tempfile.mkdtemp(prefix="ia_archive_")
    keys = [sj.idem_key(batcher.key_str(batcher.batch_key(a, ap, b, params)),
                        b) for a, ap, b in load]
    digests = [sj.response_digest(r.bp, r.bp_y) for r in singles]
    cfg = ServeConfig(params=params, workers=2, max_batch=4,
                      batch_window_ms=SERVE_WINDOW_MS, journal_dir=jdir,
                      journal_fsync=True)
    f32 = {"Content-Type": wire.CONTENT_TYPE, "Accept": wire.CONTENT_TYPE}

    def front(srv):
        httpd = serve_http(srv, 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(base, i, **hdr):
        return serve_http_call(base, "/v1/analogy",
                               wire.encode_planes(load[i]),
                               dict(f32, **{"X-IA-Idempotency-Key": keys[i]},
                                    **hdr))

    torch.cuda.reset_peak_memory_stats()
    obs_archive.arm(root=adir)
    try:
        # (a) request 1 over HTTP
        srv = Server(cfg).start()
        httpd, base = front(srv)
        t0 = time.perf_counter()
        code, hdrs, body = post(base, 0, **{"X-IA-Trace":
                                            f"{SERVE_TRACE}/-/-"})
        wall_a = time.perf_counter() - t0
        if code != 200:
            fail(f"serve: check 5 POST 1 gave {code}: {body[:300]!r}")
        plane = wire.decode_planes(body)[0]
        a_bits = bool(np.array_equal(plane, singles[0].bp))
        trace_hdr = hdrs.get("X-IA-Trace") or ""
        health = json.loads(serve_http_call(base, "/healthz")[2])
        mcode, mhdrs, mbody = serve_http_call(base, "/metrics")
        fams = prometheus_families(mbody.decode())
        journal_fam = "ia_serve_journal_done_total"
        httpd.shutdown()
        httpd.server_close()

        # (b) requests 2-4 held past their dispatched lines, then kill()
        gate, held, lock = threading.Event(), [], threading.Lock()
        undo = serve_hold(gate, held, lock)
        try:
            match.reset_launch_counts()
            futs = [srv.submit(*load[i], idempotency_key=keys[i])
                    for i in (1, 2, 3)]
            end = time.monotonic() + 120
            while sum(held) < 3 and time.monotonic() < end:
                time.sleep(0.01)
            held_lanes = sorted(held)
            srv.kill()
            # a killed process's clients see nothing; here the check
            # fails their futures so that the held workers, released,
            # find nothing to requeue, raise _Killed before any launch
            # and exit: every thread of the killed server is joined
            # before (c) counts
            for f in futs:
                f.set_exception(RuntimeError("server killed"))
            gate.set()
            threads = list(srv._pool._threads)
            for t in threads:
                t.join(60)
            alive = [t.name for t in threads if t.is_alive()]
        finally:
            gate.set()
            undo()
        killed_launches = serve_counts()
        rep = sj.RequestJournal(jdir).replay()
        dispatched = {k: rep.entries[k].dispatched for k in keys[1:]}

        # (c) a new server recovers
        match.reset_launch_counts()
        t0 = time.perf_counter()
        srv2 = Server(cfg).start()
        recovery_s = time.perf_counter() - t0
        stats = dict(srv2.recovery_stats)
        outcomes = srv2.wait_recovered(timeout=600)
        wall_c = time.perf_counter() - t0
        torch.cuda.synchronize()
        recovered = {k: srv2.recovery[k].result() for k in keys[1:]}
        counters = obs_metrics.snapshot()["counters"]
        launched = serve_counts()
        engine = counters.get("batch.launches", 0)
        lanes = counters.get("batch.lanes", 0)
        runs = engine + 3 - lanes
        single = expected_launches(params, SERVE_SIZE)
        want = {k: runs * v for k, v in single.items()}
        c_bits = [bool(np.array_equal(recovered[k].bp, r.bp) and
                       np.array_equal(recovered[k].bp_y, r.bp_y))
                  for k, r in zip(keys[1:], singles[1:])]

        # (d) every key again, as frames: answered from the journal
        httpd, base = front(srv2)
        match.reset_launch_counts()
        answers = [post(base, i) for i in range(SERVE_N)]
        dedupe_launches = serve_counts()
        obs_archive.current().sample(force=True)
        httpd.shutdown()
        httpd.server_close()
        srv2.shutdown()
    finally:
        for _ in range(8):
            if obs_archive.current() is None:
                break
            obs_archive.disarm()
    peak = torch.cuda.max_memory_allocated()
    rep = sj.RequestJournal(jdir).replay()
    recorded = {k: (rep.entries[k].done or {}) for k in keys}
    d_ok = [code == 200 and bool(np.array_equal(
        wire.decode_planes(body)[0], r.bp)) and
        recorded[k].get("response_digest") == dg and
        hdrs.get("X-IA-Request") == str(recorded[k].get("rid"))
        for (code, hdrs, body), k, r, dg in zip(answers, keys, singles,
                                                digests)]
    seg_bytes = sum(os.path.getsize(os.path.join(jdir, n))
                    for n in os.listdir(jdir) if n.startswith("segment-"))
    disk_bytes = sum(os.path.getsize(os.path.join(d, n))
                     for d, _, names in os.walk(jdir) for n in names)

    # (e) the offline readers, as subprocesses side by side (no card)
    readers = [("journal", "inspect", jdir, "--json"),
               ("why", keys[1], "--root", jdir, "--json"),
               ("archive", "inspect", adir, "--json")]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "image_analogies_tpu_torch.cli", *args],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args in readers]
    docs = []
    for args, proc in zip(readers, procs):
        out, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            fail(f"serve: cli {' '.join(args)} exit {proc.returncode}: "
                 f"{err[-800:]}")
        docs.append(json.loads(out))
    inspect, why, archive = docs
    chain = why["chain"]
    order = [next((i for i, step in enumerate(chain) if step.startswith(p)),
                  -1) for p in ("admitted", "replay(", "done")]
    say("serve", check="journal", size=SERVE_SIZE, keys=keys,
        a_wall_s=wall_a, a_bits_equal=a_bits, a_trace=trace_hdr,
        a_healthz_journal=health.get("journal"), a_metrics_status=mcode,
        a_metrics_type=mhdrs.get("Content-Type"),
        a_metrics_families=len(fams),
        a_metrics_journal_done=fams.get(journal_fam),
        b_held_lanes=held_lanes, b_dispatched=dispatched,
        b_threads_alive=alive, b_launches=killed_launches,
        c_recovery_stats=stats, c_outcomes=outcomes, c_recovery_s=recovery_s,
        c_wall_s=wall_c, c_bits_equal=c_bits, c_engine_launches=engine,
        c_lanes=lanes, c_launches=launched, c_expected_launches=want,
        d_answers_ok=d_ok, d_launches=dedupe_launches,
        peak_mem_gib=peak / 2**30, journal_segment_bytes=seg_bytes,
        journal_disk_bytes=disk_bytes, e_inspect_states=inspect["states"],
        e_inspect_requests=inspect["requests"], e_why_chain=chain,
        e_archive={k: archive.get(k) for k in ("segments", "bytes",
                                               "quarantined", "kinds")},
        card=nvidia_smi())
    if not a_bits or not trace_hdr.startswith(SERVE_TRACE + "/"):
        fail(f"serve: check 5(a) bits equal {a_bits}, trace {trace_hdr!r}")
    if (health.get("journal") or {}).get("done") != 1 or mcode != 200 or \
            fams.get(journal_fam, ("", ""))[1] != "counter serve.journal.done":
        fail(f"serve: check 5(a) healthz journal {health.get('journal')}, "
             f"/metrics {mcode} {fams.get(journal_fam)}")
    if sum(held_lanes) != 3 or alive or killed_launches or \
            dispatched != {k: 1 for k in keys[1:]}:
        fail(f"serve: check 5(b) held {held_lanes}, threads alive {alive}, "
             f"launches {killed_launches}, dispatched {dispatched}")
    if {k: stats[k] for k in ("done", "replayed", "poisoned",
                              "unrecoverable")} != \
            {"done": 1, "replayed": 3, "poisoned": 0, "unrecoverable": 0} \
            or outcomes != {k: "ok" for k in keys[1:]} or not all(c_bits) \
            or launched != want:
        fail(f"serve: check 5(c) recovery {stats}, outcomes {outcomes}, "
             f"bits {c_bits}, launched {launched} (want {want})")
    if not all(d_ok) or dedupe_launches:
        fail(f"serve: check 5(d) answers {d_ok}, launches {dedupe_launches}")
    if inspect["requests"] != SERVE_N or \
            inspect["states"] != {"done": SERVE_N} or \
            not 0 <= order[0] < order[1] < order[2]:
        fail(f"serve: check 5(e) inspect {inspect['states']}, why {chain}")
    if not archive.get("segments") or archive.get("quarantined"):
        fail(f"serve: check 5(e) archive {archive}")
    shutil.rmtree(jdir, ignore_errors=True)
    shutil.rmtree(adir, ignore_errors=True)


FLEET_TRACE = "f1ee7c0de6"  # check 6(c)'s caller trace id (X-IA-Trace)
FLEET_KILL_AFTER_S = 3.0  # check 6(b): the kill, this long after dispatch
WORKER_MAIN = "image_analogies_tpu_torch.serve.worker_main"


def card_pids():
    """{pid: used memory} of the compute processes nvidia-smi lists on the
    card (empty where the machine shows it none)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi compute apps exit {out.returncode}: "
             f"{out.stderr.strip()}")
    pids = {}
    for line in out.stdout.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            pids[int(pid)] = mem.strip()
    return pids


def card_memory_used_mib():
    """The card's used memory, MiB, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi memory.used exit {out.returncode}: "
             f"{out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def worker_main_pids(own_group=True):
    """Pids of every live ``worker_main`` process of this process group
    (read from /proc), or with ``own_group=False`` of the whole machine.
    Each side phase runs in a process group of its own, and a fleet's
    children stay in their parent's group after it exits, so a side counts
    its own fleets' leftovers and not another side's live fleet."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            if (WORKER_MAIN in cmd and "python" in cmd
                    and (not own_group
                         or os.getpgid(int(name)) == os.getpgrp())):
                found.append(int(name))
        except OSError:
            continue
    return sorted(found)


def fleet_cli_start(tmp):
    """Check 6(d): ``cli fleet --selftest 6`` over the subprocess
    transport and with ``--autoscale``, at their default shapes, as
    subprocesses side by side (a tune store each)."""
    procs = []
    for i, extra in enumerate((["--transport", "subprocess"],
                               ["--autoscale"])):
        env = dict(os.environ,
                   IA_TUNE_STORE=os.path.join(tmp, f"fleet_tune{i}.json"))
        procs.append((extra, subprocess.Popen(
            [sys.executable, "-m", "image_analogies_tpu_torch.cli", "fleet",
             "--selftest", "6", *extra], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return procs


def fleet_cli_wait(procs):
    for extra, proc in procs:
        label = " ".join(["fleet --selftest 6", *extra])
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"serve: cli {label} ran past 600 s")
        if proc.returncode != 0:
            fail(f"serve: cli {label} exit {proc.returncode}: "
                 f"{out[-1500:]} {err[-1500:]}")
        summary = json.loads(err.strip().splitlines()[-1])
        say("serve", check="fleet_cli", args=label, rc=proc.returncode,
            transport=summary["transport"], completed=summary["completed"],
            errors=summary["errors"], bit_identical=summary["bit_identical"],
            routed=summary["routed"], codecs=summary["codecs"],
            wire_bytes=summary["wire_bytes"], control=summary["control"],
            served_s=summary["served_s"],
            sequential_s=summary["sequential_s"])
        if summary["errors"] or not summary["bit_identical"] or \
                summary["completed"] != 6:
            fail(f"serve: cli {label}: {summary}")
        if "--autoscale" in extra and \
                (summary["control"] or {}).get("autoscale") is not True:
            fail(f"serve: cli {label} control {summary['control']}")
        if "subprocess" in extra and summary["transport"] != "subprocess":
            fail(f"serve: cli {label} transport {summary['transport']}")


def fleet_runs(counters):
    """Singleton runs' worth of launches a worker's counters say it
    launched: each lane-engine launch and each member run alone."""
    return (counters.get("batch.launches", 0)
            + counters.get("serve.completed", 0)
            - counters.get("batch.lanes", 0))


def fleet_launches(counters):
    """A worker's own launch counts (``launch.*``, counted in its run)."""
    return {k.split(".", 1)[1]: int(v) for k, v in counters.items()
            if k.startswith("launch.") and v}


def fleet_inproc_and_http(params, load, singles, single, root):
    """Check 6(a) and (c): an in-process fleet of two, binary wire, a
    journal root; check 1's four requests through the router, then one
    more over ``serve_fleet_http``."""
    import threading

    import numpy as np
    import torch

    from image_analogies_tpu_torch.obs import fleet as obs_fleet
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.ops import match
    from image_analogies_tpu_torch.serve import FleetConfig, ServeConfig
    from image_analogies_tpu_torch.serve import wire
    from image_analogies_tpu_torch.serve.fleet import Fleet
    from image_analogies_tpu_torch.serve.http import serve_fleet_http

    cfg = FleetConfig(
        serve=ServeConfig(params=params, workers=1, max_batch=4,
                          batch_window_ms=SERVE_WINDOW_MS,
                          cost_persist=False, journal_fsync=True),
        size=2, wire="binary", journal_root=root)
    with Fleet(cfg) as fl:
        # (a)
        match.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [fl.submit(*planes) for planes in load]
        resps, errors = [], []
        for f in futs:
            try:
                resps.append(f.result(timeout=600))
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(repr(exc))
        wall_a = time.perf_counter() - t0
        torch.cuda.synchronize()
        launched = serve_counts()
        counters = obs_fleet.merge_snapshots(
            fl.metrics_snapshots())["counters"]
        routed = {k.split("router.routed.", 1)[1]: int(v) for k, v in
                  obs_metrics.snapshot()["counters"].items()
                  if k.startswith("router.routed.")}
        runs = fleet_runs(counters)
        want = {k: runs * v for k, v in single.items()}
        bits = [bool(np.array_equal(r.bp, s.bp) and
                     np.array_equal(r.bp_y, s.bp_y))
                for r, s in zip(resps, singles)]
        wire_a = int(obs_metrics.snapshot()["counters"].get(
            "router.wire_bytes", 0))

        # (c) the fleet's HTTP front, one request as a frame
        httpd = serve_fleet_http(fl, 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            match.reset_launch_counts()
            t0 = time.perf_counter()
            code, hdrs, body = serve_http_call(
                base, "/v1/analogy", wire.encode_planes(load[0]),
                {"Content-Type": wire.CONTENT_TYPE,
                 "Accept": wire.CONTENT_TYPE,
                 "X-IA-Idempotency-Key": "fleet-c-0",
                 "X-IA-Trace": f"{FLEET_TRACE}/-/-"})
            wall_c = time.perf_counter() - t0
            torch.cuda.synchronize()
            c_launched = serve_counts()
            if code != 200:
                fail(f"serve: check 6(c) POST gave {code}: {body[:300]!r}")
            c_bits = bool(np.array_equal(wire.decode_planes(body)[0],
                                         singles[0].bp))
            trace_hdr = hdrs.get("X-IA-Trace") or ""
            health = json.loads(serve_http_call(base, "/healthz")[2])
            mcode, mhdrs, mbody = serve_http_call(base, "/metrics")
            text = mbody.decode()
            fams = prometheus_families(text)
            solo = serve_http_call(base, "/metrics?worker=w0")[0]
            unknown = serve_http_call(base, "/metrics?worker=w9")[0]
        finally:
            httpd.shutdown()
            httpd.server_close()
    labeled = sorted({w for w in ("w0", "w1")
                      if f'worker="{w}"' in text})
    say("serve", check="fleet_inproc", size=SERVE_SIZE, wire="binary",
        a_wall_s=wall_a, a_errors=errors, a_bits_equal=bits,
        a_routed=routed, a_engine_launches=counters.get("batch.launches", 0),
        a_lanes=counters.get("batch.lanes", 0),
        a_completed=counters.get("serve.completed", 0),
        a_launches=launched, a_expected_launches=want, a_wire_bytes=wire_a,
        c_wall_s=wall_c, c_bits_equal=c_bits, c_trace=trace_hdr,
        c_launches=c_launched, c_healthz_size=health.get("size"),
        c_healthz_ring=health.get("ring"),
        c_healthz_workers=sorted(health.get("workers") or {}),
        c_metrics_status=mcode, c_metrics_type=mhdrs.get("Content-Type"),
        c_metrics_families=len(fams), c_metrics_labeled=labeled,
        c_worker_metrics=solo, c_unknown_worker=unknown,
        card=nvidia_smi())
    if errors or len(resps) != len(load) or not all(bits):
        fail(f"serve: check 6(a) errors {errors}, bits {bits}")
    if sorted(routed.values()) != [len(load)]:
        fail(f"serve: check 6(a) routed {routed}: the key's requests are "
             "not on one home worker")
    if launched != want or counters.get("serve.completed") != len(load):
        fail(f"serve: check 6(a) launched {launched}; {runs} singleton "
             f"runs launch {want}")
    if not c_bits or not trace_hdr.startswith(FLEET_TRACE + "/") or \
            c_launched != single:
        fail(f"serve: check 6(c) bits {c_bits}, trace {trace_hdr!r}, "
             f"launches {c_launched} (one singleton's: {single})")
    if health.get("size") != 2 or sorted(health.get("workers") or {}) != \
            ["w0", "w1"] or health.get("transport") != "inproc":
        fail(f"serve: check 6(c) healthz {health}")
    if mcode != 200 or not labeled or (solo, unknown) != (200, 404):
        fail(f"serve: check 6(c) /metrics {mcode}, labeled {labeled}, "
             f"?worker=w0 {solo}, ?worker=w9 {unknown}")


def fleet_subprocess(params, load, singles, single, root):
    """Check 6(b): a subprocess fleet of two children on the card, a
    journal root; check 1's four requests sent, their home SIGKILLed once
    its journal shows them admitted and not all done; the health loop
    replaces it as generation 1 on the same directory."""
    import signal

    import numpy as np

    from image_analogies_tpu_torch.obs import fleet as obs_fleet
    from image_analogies_tpu_torch.obs import metrics as obs_metrics
    from image_analogies_tpu_torch.serve import FleetConfig, ServeConfig
    from image_analogies_tpu_torch.serve.fleet import Fleet

    cfg = FleetConfig(
        serve=ServeConfig(params=params, workers=1, max_batch=4,
                          batch_window_ms=SERVE_WINDOW_MS,
                          cost_persist=False, journal_fsync=True),
        size=2, wire="binary", transport="subprocess", journal_root=root)
    fl = Fleet(cfg)
    spawns = []
    real_spawn = fl.transport.spawn

    def timed_spawn(wid, generation, *args, **kw):
        # what is alive, and on the card, as the spawn begins: the
        # corpse of a replaced child must be reaped (its /proc entry
        # gone) and off the card before its replacement starts
        at_entry = card_pids()
        alive = [sp["pid"] for sp in spawns
                 if os.path.exists(f"/proc/{sp['pid']}")]
        mib = card_memory_used_mib()
        t0 = time.perf_counter()
        handle = real_spawn(wid, generation, *args, **kw)
        spawns.append({"wid": wid, "generation": generation,
                       "pid": handle.pid, "s": time.perf_counter() - t0,
                       "card_pids_at_entry": sorted(at_entry),
                       "children_alive_at_entry": alive,
                       "card_mib_at_entry": mib})
        return handle

    fl.transport.spawn = timed_spawn
    t_start = time.perf_counter()
    with fl:
        start_s = time.perf_counter() - t_start
        children = {w: h.pid for w, h in fl.workers.items()}
        t0 = time.perf_counter()
        futs = [fl.submit(*planes) for planes in load]
        homes = sorted({e.wid for w in children
                        for e in fl.router.pending_for(w)})
        if len(homes) != 1:
            fail(f"serve: check 6(b) the key's requests went to {homes}")
        home = homes[0]
        handle = fl.workers[home]
        # the kill comes once the batch is dispatched and its kernels run
        # (FLEET_KILL_AFTER_S past the dispatched lines; a 1024^2 batch
        # takes ten seconds or more), so the corpse holds a context and
        # memory on the card
        journal = {}
        end = time.monotonic() + 300
        while time.monotonic() < end:
            journal = handle.health().get("journal") or {}
            if journal.get("dispatched", 0) >= len(load):
                break
            time.sleep(0.05)
        time.sleep(FLEET_KILL_AFTER_S)
        journal = handle.health().get("journal") or {}
        on_card = card_pids()
        mib_at_kill = card_memory_used_mib()
        corpse = handle.pid
        done_at_kill = journal.get("done", 0)
        os.kill(corpse, signal.SIGKILL)
        t_kill = time.perf_counter()
        while not fl.handoffs and time.perf_counter() - t_kill < 300:
            time.sleep(0.02)
        handoff_s = time.perf_counter() - t_kill
        resps, errors = [], []
        for f in futs:
            try:
                resps.append(f.result(timeout=600))
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(repr(exc))
        recovery_s = time.perf_counter() - t_kill
        wall = time.perf_counter() - t0
        snaps = fl.metrics_snapshots()
        health = fl.health()
        fleet_counters = obs_metrics.snapshot()["counters"]
        pending = fl.router.pending_count()
    procs = {w: h.proc.returncode for w, h in fl.workers.items()}
    merged = obs_fleet.merge_snapshots(snaps)["counters"]
    per_worker = {w: {"launches": fleet_launches(s["counters"]),
                      "runs": fleet_runs(s["counters"]),
                      "completed": s["counters"].get("serve.completed", 0),
                      "engine_launches": s["counters"].get(
                          "batch.launches", 0),
                      "hbm_peak_bytes": {k: v for k, v in
                                         s["gauges"].items()
                                         if k.startswith("hbm.peak_bytes")}}
                  for w, s in snaps.items()}
    want = {k: fleet_runs(merged) * v for k, v in single.items()}
    replacement = [s for s in spawns if s["generation"] == 1]
    bits = [bool(np.array_equal(r.bp, s.bp) and
                 np.array_equal(r.bp_y, s.bp_y))
            for r, s in zip(resps, singles)]
    wh = health["workers"][home]
    say("serve", check="fleet_subprocess", size=SERVE_SIZE, home=home,
        start_s=start_s, spawns=spawns, children=children,
        children_on_card={w: p in on_card for w, p in children.items()},
        admitted_at_kill=journal.get("admitted"),
        dispatched_at_kill=journal.get("dispatched"),
        card_mib_at_kill=mib_at_kill,
        done_at_kill=done_at_kill, handoff_s=handoff_s,
        recovery_s=recovery_s, wall_s=wall, errors=errors,
        bits_equal=bits, handoffs=health["handoffs"],
        deaths=fleet_counters.get("router.deaths", 0),
        router_handoffs=fleet_counters.get("router.handoffs", 0),
        resubmitted=fleet_counters.get("router.resubmitted", 0),
        hop_disconnects=fleet_counters.get("router.hop_disconnects", 0),
        wire_bytes=int(fleet_counters.get("router.wire_bytes", 0)),
        pending=pending, home_generation=wh.get("generation"),
        home_journal=wh.get("journal"), recovered=fl.handoffs[0]["recovered"]
        if fl.handoffs else None, per_worker=per_worker,
        launches=fleet_launches(merged), expected_launches=want,
        shutdown_returncodes=procs, card=nvidia_smi())
    if errors or len(resps) != len(load) or not all(bits) or pending:
        fail(f"serve: check 6(b) errors {errors}, bits {bits}, pending "
             f"{pending}")
    if done_at_kill >= len(load) or \
            journal.get("admitted", 0) != len(load) or \
            journal.get("dispatched", 0) != len(load):
        fail(f"serve: check 6(b) the kill came at journal {journal}")
    if (health["handoffs"], fleet_counters.get("router.deaths"),
            fleet_counters.get("router.handoffs")) != (1, 1, 1) or \
            wh.get("generation") != 1 or \
            (wh.get("journal") or {}).get("stale_lock_swept") != 1:
        fail(f"serve: check 6(b) handoffs {health['handoffs']}, counters "
             f"{fleet_counters}, home {wh}")
    if len(replacement) != 1 or corpse in replacement[0][
            "card_pids_at_entry"] or corpse in replacement[0][
            "children_alive_at_entry"]:
        fail(f"serve: check 6(b) the corpse {corpse} was still alive or on "
             f"the card when its replacement spawned: {replacement}")
    if fleet_launches(merged) != want or sorted(snaps) != sorted(children):
        fail(f"serve: check 6(b) the children launched "
             f"{fleet_launches(merged)}; their runs launch {want}")


def serve_fleet(params, load, singles, tmp):
    """Check 6 (a)-(c): the fleet on check 1's four requests and their
    singleton runs: (a) and (c) in process, (b) over the subprocess
    transport."""
    single = expected_launches(params, SERVE_SIZE)
    fleet_inproc_and_http(params, load, singles, single,
                          os.path.join(tmp, "fleet_a"))
    fleet_subprocess(params, load, singles, single,
                     os.path.join(tmp, "fleet_b"))


def fleet_orphans():
    """Check 6(e), once every fleet and CLI of the phase has ended."""
    from image_analogies_tpu_torch.serve import transport

    live = transport.live_workers()
    reaped = transport.reap_orphans()
    alive = worker_main_pids()
    on_card = card_pids()
    say("serve", check="fleet_orphans", live_workers=len(live),
        reaped=reaped, worker_main_alive=alive,
        card_compute_pids=sorted(on_card))
    if live or reaped or alive or set(alive) & set(on_card):
        fail(f"serve: check 6(e) live {live}, reaped {reaped}, worker_main "
             f"alive {alive}, on the card {sorted(on_card)}")


def phase_serve():
    """The serving path (``serve/``) on the card: checks 1-6 of the
    docstring's serve phase, on npr_1024 with ``remap_luminance=False``
    (the serve configuration: with the remap on, differing targets refuse
    the lane engine by design)."""
    import tempfile

    import numpy as np

    from image_analogies_tpu_torch import PRESETS

    params = dataclasses.replace(PRESETS["npr_1024"], remap_luminance=False)
    tmp = tempfile.mkdtemp(prefix="ia_serve_")
    cli = serve_cli_start(tmp)
    t0 = time.perf_counter()
    load, singles = serve_selftest(params)
    t1 = time.perf_counter()
    # after check 1, whose walls are recorded: three more processes on
    # the card (the CLIs and the subprocess one's two children)
    fleet_cli = fleet_cli_start(tmp)
    # two exemplar pairs with four targets each, seeded planes
    rng = np.random.RandomState(11)
    shape = (SERVE_SMALL, SERVE_SMALL)
    planes = [(rng.rand(*shape).astype(np.float32),
               rng.rand(*shape).astype(np.float32),
               [rng.rand(*shape).astype(np.float32) for _ in range(4)])
              for _ in range(2)]
    serve_behaviours(params, planes[0][0], planes[0][1], planes[0][2][0])
    t2 = time.perf_counter()
    serve_two_workers(params, planes)
    t3 = time.perf_counter()
    serve_journal(params, load, singles)
    t4 = time.perf_counter()
    serve_fleet(params, load, singles, tmp)
    t5 = time.perf_counter()
    serve_cli_wait(cli)
    fleet_cli_wait(fleet_cli)
    fleet_orphans()
    say("serve", selftest_s=t1 - t0, behaviours_s=t2 - t1,
        two_workers_s=t3 - t2, journal_s=t4 - t3, fleet_s=t5 - t4,
        cli_extra_wait_s=time.perf_counter() - t5)


CHAOS_KINDS = 13  # runner.DRILL_KINDS: the JAX package's, flash_crowd too


def chaos_selftest_start(tmp):
    """Check (a): ``cli chaos --selftest --json`` as a subprocess on the
    card (its tune store a file of its own)."""
    cmd = [sys.executable, "-m", "image_analogies_tpu_torch.cli", "chaos",
           "--selftest", "--json"]
    env = dict(os.environ, IA_TUNE_STORE=os.path.join(tmp, "tune.json"))
    return (subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            time.perf_counter())


def chaos_selftest_wait(started):
    """Check (a): exit 0, each of the thirteen kinds ok with an injection,
    the determinism check ok, and no ``worker_main`` left."""
    from image_analogies_tpu_torch.serve import transport

    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail("chaos: cli chaos --selftest ran past 600 s")
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"chaos: cli chaos --selftest exit {proc.returncode}: "
             f"{out[-2000:]} {err[-2000:]}")
    doc = json.loads(err.strip().splitlines()[-1])
    reports = {r["kind"]: r for r in doc["reports"]}
    for kind, r in reports.items():
        say("chaos", check="selftest", kind=kind, ok=r["ok"],
            injected=r.get("injected"), sites=r.get("sites"),
            outcomes=r.get("outcomes"), problems=r.get("problems"))
    kinds = [k for k in reports if k != "determinism"]
    bad = [k for k, r in reports.items()
           if not r["ok"] or (k != "determinism" and not r["injected"])]
    if (not doc["ok"] or bad or len(kinds) != CHAOS_KINDS
            or "determinism" not in reports):
        fail(f"chaos: selftest kinds {kinds}, failing {bad}")
    live = transport.live_workers()
    reaped = transport.reap_orphans()
    alive = worker_main_pids()
    say("chaos", check="selftest_done", kinds=len(kinds), seconds=secs,
        live_workers=len(live), reaped=reaped, worker_main_alive=alive)
    if live or reaped or alive:
        fail(f"chaos: worker_main left after the selftest: live {live}, "
             f"reaped {reaped}, alive {alive}")
    return secs


def chaos_run(label, params, a, ap, b, want, plan=None, dump_dir=None,
              resume=None):
    """Check (b): one ``create_image_analogy`` of npr_1024 in a metrics
    run, armed with ``plan`` when given (``resume``: then a disarmed
    resume from level 0 in the same run, held to its own launches): its
    launch counts set to 0 just before it and read just after, the bits
    MAIN_DIGEST's, the launches exactly ``want``, the counters reconciled
    with the plan by the port's ``_reconcile``.  A hang's abandoned
    attempt is waited for before the launches are read.  Returns the
    run's wall, counters and stats (and the resume's wall)."""
    import threading

    import torch

    from image_analogies_tpu_torch import chaos, create_image_analogy
    from image_analogies_tpu_torch.chaos import runner
    from image_analogies_tpu_torch.obs import trace as obs_trace
    from image_analogies_tpu_torch.ops import match

    p = params.replace(metrics=True)
    walls = {}
    with obs_trace.run_scope(p) as ctx:
        ctx.scope.dump_dir = dump_dir
        match.reset_launch_counts()
        t0 = time.perf_counter()
        with (chaos.plan_scope(plan) if plan is not None
              else contextlib.nullcontext()):
            res = create_image_analogy(a, ap, b, p)
            torch.cuda.synchronize()
            walls["wall_s"] = time.perf_counter() - t0
            sites = chaos.snapshot()
        # an abandoned attempt runs on past the result: wait for it to
        # end, so that a launch it made would be counted below
        for t in threading.enumerate():
            if t.name == "ia-watchdog-body":
                t.join(timeout=600)
                if t.is_alive():
                    fail(f"chaos {label}: the abandoned attempt never ended")
        torch.cuda.synchronize()
        launches = {k: v for k, v in match.LAUNCHES.items() if v}
        digest = bits_digest(res)
        stats = res.stats
        resumed = None
        if resume is not None:
            match.reset_launch_counts()
            t1 = time.perf_counter()
            resumed = create_image_analogy(
                a, ap, b, p.replace(resume_from_level=0))
            torch.cuda.synchronize()
            walls["resume_wall_s"] = time.perf_counter() - t1
            resume_launches = {k: v for k, v in match.LAUNCHES.items() if v}
        counters = dict(ctx.registry.snapshot()["counters"])
    problems = runner._reconcile(plan, counters) if plan is not None else []
    if digest != MAIN_DIGEST:
        problems.append(f"bits {digest} != MAIN_DIGEST {MAIN_DIGEST}")
    if launches != {k: v for k, v in want.items() if v}:
        problems.append(f"launched {launches}, expected {want}")
    if resumed is not None:
        if bits_digest(resumed) != MAIN_DIGEST:
            problems.append(f"resume bits {bits_digest(resumed)}")
        if resume_launches != {k: v for k, v in resume.items() if v}:
            problems.append(f"resume launched {resume_launches}, expected "
                            f"{resume}")
    say("chaos", check="full_width", run=label, bits=digest, **walls,
        launches=launches, sites=sites if plan is not None else None,
        counters={k: v for k, v in counters.items()
                  if k.startswith(("chaos.", "level_retry", "retry.",
                                   "watchdog.", "ckpt.", "obs.blackbox"))},
        level_total_ms={st["level"]: st["total_ms"] for st in stats},
        problems=problems)
    if problems:
        fail(f"chaos {label}: {problems}")
    return walls, counters, stats


def chaos_full_width(a, ap, b, tmp, selftest_start):
    """Check (b): npr_1024 at 1024^2 on seed 7's inputs, cold and clean
    (then ``selftest_start()``, so check (a) runs beside the armed runs),
    armed with a transient and an oom at level 0's ``level.dispatch``
    visit, a hang there past a watchdog of at least three times the clean
    run's slowest level dispatch, and a ``corrupt`` at ``ckpt.save``
    followed by the disarmed resume, then clean again.  Returns
    selftest_start's handle."""
    from image_analogies_tpu_torch import PRESETS
    from image_analogies_tpu_torch.chaos import ChaosPlan, SiteRule
    from image_analogies_tpu_torch.obs import recorder as obs_recorder

    params = PRESETS["npr_1024"]
    want = expected_launches(params, a.shape[0])
    # the process's first run pays its own start-up: the clean run that
    # times the levels is the second
    chaos_run("cold", params, a, ap, b, want)
    clean, _, stats = chaos_run("clean", params, a, ap, b, want)
    started = selftest_start()
    top = len(stats) - 1  # dispatch visits run coarsest first
    visit0 = top  # level 0's visit of level.dispatch
    slowest_s = max(st["total_ms"] for st in stats) / 1e3

    def plan(name, site, rule):
        return ChaosPlan(seed=7, sites=((site, rule),), name=f"card-{name}")

    out = {"clean_wall_s": clean["wall_s"], "slowest_level_s": slowest_s}
    for kind in ("transient", "oom"):
        walls, counters, _ = chaos_run(
            kind, params.replace(level_retries=1), a, ap, b, want,
            plan(kind, "level.dispatch",
                 SiteRule(kind=kind, schedule=(visit0,))))
        if counters.get("level_retry") != 1:
            fail(f"chaos {kind}: level_retry {counters.get('level_retry')}")
        out[f"{kind}_wall_s"] = walls["wall_s"]
        out[f"{kind}_cost_s"] = walls["wall_s"] - clean["wall_s"]
    timeout_s = 3.0 * slowest_s
    hang_ms = 2.0 * timeout_s * 1e3
    dumps = os.path.join(tmp, "dumps")
    walls, counters, _ = chaos_run(
        "hang", params.replace(level_retries=1, dispatch_timeout_s=timeout_s),
        a, ap, b, want,
        plan("hang", "level.dispatch",
             SiteRule(kind="latency", schedule=(visit0,),
                      latency_ms=hang_ms, hang=True)), dump_dir=dumps)
    found = [obs_recorder.load_dump(d) for d in obs_recorder.list_dumps(dumps)]
    if (counters.get("watchdog.timeouts") != 1
            or counters.get("level_retry") != 1
            or counters.get("watchdog.abandoned") != 1
            or [d["reason"] for d in found] != ["watchdog_timeout"]):
        fail(f"chaos hang: counters {counters}, dumps "
             f"{[d['reason'] for d in found]}")
    out.update(hang_wall_s=walls["wall_s"],
               hang_cost_s=walls["wall_s"] - clean["wall_s"],
               hang_timeout_s=timeout_s, hang_latency_s=hang_ms / 1e3,
               hang_dump_records=len(found[0]["records"]))
    walls, counters, _ = chaos_run(
        "corrupt", params.replace(checkpoint_dir=os.path.join(tmp, "ck")),
        a, ap, b, want,
        plan("corrupt", "ckpt.save", SiteRule(kind="corrupt", schedule=(0,))),
        resume=expected_launches(params, a.shape[0], levels=(0, top)))
    if counters.get("ckpt.quarantined") != 1:
        fail(f"chaos corrupt: ckpt.quarantined "
             f"{counters.get('ckpt.quarantined')}")
    out.update(corrupt_wall_s=walls["wall_s"],
               resume_wall_s=walls["resume_wall_s"],
               resume_cost_s=walls["resume_wall_s"] - clean["wall_s"])
    # the first clean run had the card's other users but not check (a):
    # a second one brackets the armed runs
    walls, _, _ = chaos_run("clean_after", params, a, ap, b, want)
    say("chaos", check="full_width_walls", **out,
        clean_after_wall_s=walls["wall_s"], card=nvidia_smi())
    return started


def phase_chaos(a, ap, b):
    """The chaos plane on the card: (a) the drills' selftest as a
    subprocess, started after (b)'s first clean run and beside its armed
    runs of the main path."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="ia_chaos_")
    t0 = time.perf_counter()
    started = chaos_full_width(a, ap, b, tmp,
                               lambda: chaos_selftest_start(tmp))
    t1 = time.perf_counter()
    secs = chaos_selftest_wait(started)
    say("chaos", full_width_s=t1 - t0, selftest_s=secs,
        selftest_extra_wait_s=time.perf_counter() - t1)


SOAK_TIMEOUT_S = 600  # one ia soak subprocess
SOAK_REPORT_LEVELS = 5  # npr_1024's levels at 1024^2


def soak_cli(args, tmp, timeout=SOAK_TIMEOUT_S):
    """``python -m image_analogies_tpu_torch.cli ARGS`` as a subprocess
    (its tune store a file of its own).  Returns (exit code, stdout,
    stderr, seconds)."""
    cmd = [sys.executable, "-m", "image_analogies_tpu_torch.cli", *args]
    env = dict(os.environ, IA_TUNE_STORE=os.path.join(tmp, "tune.json"))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"soak: cli {' '.join(args[:2])} ran past {timeout} s")
    return (proc.returncode, proc.stdout, proc.stderr,
            time.perf_counter() - t0)


def soak_run(label, args, tmp):
    """Checks (a)-(c) on one ``cli soak ... --json`` run: exit 0, PASS,
    loss 0, kills with their handoffs, the required sites injected, no
    kernel launched while the engine's counters reach the facts.  Returns
    the result document."""
    from image_analogies_tpu_torch.soak import driver as soak_driver

    rc, out, err, secs = soak_cli(["soak", *args, "--json"], tmp)
    if rc != 0 or "ia soak: PASS" not in out:
        fail(f"soak {label}: exit {rc}: {out[-3000:]} {err[-2000:]}")
    doc = json.loads(err.strip().splitlines()[-1])
    facts = doc["facts"]
    counters = facts["counters"]
    sites = {k: v.get("injected", 0) for k, v in facts["sites"].items()}
    launches = {k: v for k, v in counters.items() if k.startswith("launch.")}
    problems = []
    if not doc["ok"] or doc["loss"] != 0:
        problems.append(f"ok {doc['ok']} loss {doc['loss']}")
    if len(facts["kills"]) < 2 or len(facts["handoffs"]) < len(facts["kills"]):
        problems.append(f"kills {facts['kills']} handoffs "
                        f"{len(facts['handoffs'])}")
    silent = [s for s in soak_driver.REQUIRED_SITES if not sites.get(s)]
    if silent:
        problems.append(f"required sites silent: {silent}")
    if sum(launches.values()) != 0:
        problems.append(f"the soak launched kernels: {launches}")
    if counters.get("level_retry", 0) < sites.get("level.dispatch", 0):
        problems.append(f"level_retry {counters.get('level_retry')} < "
                        f"{sites.get('level.dispatch')} injected")
    say("soak", check="run", run=label, seconds=secs,
        wall_s=facts["wall_s"], p999_ms=doc["p999_ms"], loss=doc["loss"],
        p999_bound_ms=facts["spec"]["p999_bound_ms"],
        kills=facts["kills"], handoffs=len(facts["handoffs"]),
        answered=facts["answered"], submitted=facts["submitted"],
        sites=sites, launches=launches,
        level_retry=counters.get("level_retry", 0),
        autocompact=counters.get("serve.journal.autocompact", 0),
        verdicts=[(v["name"], v["ok"]) for v in doc["verdicts"]],
        problems=problems)
    if problems:
        fail(f"soak {label}: {problems}")
    return doc


def soak_archive_top(label, root, tmp):
    """``cli top --once --from-archive ROOT``: exit 0 where a sealed
    timeline document survived, else 2 saying none did."""
    from image_analogies_tpu_torch.obs import archive as obs_archive

    archive = obs_archive.TelemetryArchive(root)
    kept = archive.replay()["kinds"]
    torn = archive.stats()["quarantined"]
    rc, out, err, _ = soak_cli(["top", "--once", "--from-archive", root], tmp,
                               timeout=120)
    want = 0 if kept.get("timeline") else 2
    say("soak", check="top_from_archive", run=label, rc=rc, kinds=kept,
        quarantined=torn, frame_lines=len(out.splitlines()),
        err=err.strip()[-300:])
    # the plan tears one segment: none survives where it was the only one
    if rc != want or torn < 1 or (rc == 0 and "WORKER" not in out) or (
            rc == 2 and "no archived timeline documents" not in err):
        fail(f"soak top {label}: exit {rc} (want {want}): {out[-1000:]} "
             f"{err[-1000:]}")


def soak_blackbox(roots, tmp):
    """``cli blackbox DIR --all`` on each directory of ``roots`` that holds
    a flight-recorder dump."""
    dirs = sorted({d for root in roots for d, _, names in os.walk(root)
                   if any(n.startswith("blackbox-") and n.endswith(".json")
                          for n in names)})
    if not dirs:
        say("soak", check="blackbox", dumps=0,
            note="no flight-recorder dump in the soak workdirs")
    for d in dirs:
        rc, out, err, _ = soak_cli(["blackbox", d, "--all"], tmp,
                                   timeout=120)
        say("soak", check="blackbox", dir=os.path.relpath(d, tmp), rc=rc,
            dumps=out.count("blackbox: reason="))
        if rc != 0 or "blackbox: reason=" not in out:
            fail(f"soak blackbox {d}: exit {rc}: {err[-1000:]}")


def soak_reports(a, ap, b, tmp):
    """Check (d): one warm npr_1024 run at 1024^2 in a metrics run with a
    log (after a cold one), then ``cli report --json``, ``cli report`` and
    ``cli trace`` on the log."""
    import torch

    from image_analogies_tpu_torch import PRESETS, create_image_analogy
    from image_analogies_tpu_torch.ops import match

    params = PRESETS["npr_1024"]
    want = expected_launches(params, a.shape[0])
    create_image_analogy(a, ap, b, params)
    torch.cuda.synchronize()
    log = os.path.join(tmp, "npr_1024.jsonl")
    match.reset_launch_counts()
    t0 = time.perf_counter()
    create_image_analogy(a, ap, b, params.replace(metrics=True, log_path=log))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in match.LAUNCHES.items() if v}
    rc, out, err, _ = soak_cli(["report", log, "--json"], tmp, timeout=300)
    if rc != 0:
        fail(f"soak report --json: exit {rc}: {err[-2000:]}")
    (run,) = json.loads(out)["runs"]
    c = run["counters"]
    levels = {r["level"]: r["device_ms"] for r in run["levels"]}
    got = {k.split(".", 1)[1]: int(v) for k, v in c.items()
           if k.startswith("launch.")}
    rc_t, text, err_t, _ = soak_cli(["report", log], tmp, timeout=300)
    trace_path = os.path.join(tmp, "trace.json")
    rc_x, said, err_x, _ = soak_cli(["trace", log, "-o", trace_path], tmp,
                                    timeout=300)
    tracks = {}
    if rc_x == 0:
        with open(trace_path) as f:
            for e in json.load(f)["traceEvents"]:
                if e["ph"] != "M":
                    tracks[e["tid"]] = tracks.get(e["tid"], 0) + 1
    problems = []
    if launches != want or got != want:
        problems.append(f"launches {launches}, counters {got}, want {want}")
    if (len(levels) != SOAK_REPORT_LEVELS
            or not all(ms > 0 for ms in levels.values())):
        problems.append(f"levels {levels}")
    if not (run["compile"] and run["compile"]["flops"] > 0
            and run["compile"]["flops"] == c.get("kernel.flops")):
        problems.append(f"compile section {run['compile']}")
    if rc_t != 0 or "kernel cost" not in text or "xla cost" in text:
        problems.append(f"report text exit {rc_t}: {err_t[-500:]}")
    if rc_x != 0 or not tracks.get(1) or not tracks.get(2):
        problems.append(f"trace exit {rc_x}, events by track {tracks}: "
                        f"{err_x[-500:]}")
    say("soak", check="reports", wall_s=wall, launches=launches,
        level_device_ms=levels, kernel_flops=c.get("kernel.flops"),
        kernel_bytes=c.get("kernel.bytes"), trace_events_by_track=tracks,
        manifest={k: run["manifest"].get(k) for k in (
            "device_kind", "power_limit", "torch_version")},
        trace_said=said.strip(), problems=problems)
    if problems:
        fail(f"soak reports: {problems}")


def phase_soak(a, ap, b, card_after=None):
    """The soak on the card's host (it serves on the host oracle) and the
    run-log readers at full width: checks (a)-(d).  Its timed runs hold
    request latencies to deadlines on the host's cores, so the script
    starts this side before the side window (whose processes fill the
    host); where ``card_after`` is given, its card part (d) waits for
    that file, which the script creates when the window opens."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="ia_soak_")
    t0 = time.perf_counter()
    first = soak_run("smoke_1", ["--seed", "7"], tmp)
    work_a, work_b = os.path.join(tmp, "smoke"), os.path.join(tmp, "full")
    second = soak_run("smoke_2", ["--seed", "7", "--workdir", work_a], tmp)
    if [(v["name"], v["ok"]) for v in first["verdicts"]] != \
            [(v["name"], v["ok"]) for v in second["verdicts"]]:
        fail("soak: the two smoke runs' verdicts differ")
    t1 = time.perf_counter()
    full = soak_run("full", ["--full", "--workdir", work_b], tmp)
    if full["p999_ms"] is None or \
            full["p999_ms"] > full["facts"]["spec"]["p999_bound_ms"]:
        fail(f"soak full: p999_ms {full['p999_ms']}")
    t2 = time.perf_counter()
    while card_after and not os.path.exists(card_after):
        time.sleep(0.5)
    t3 = time.perf_counter()
    soak_reports(a, ap, b, tmp)
    t4 = time.perf_counter()
    soak_archive_top("smoke_2", os.path.join(work_a, "archive"), tmp)
    soak_archive_top("full", os.path.join(work_b, "archive"), tmp)
    soak_blackbox((work_a, work_b), tmp)
    say("soak", smoke_s=t1 - t0, full_s=t2 - t1, waited_s=t3 - t2,
        reports_s=t4 - t3, readers_s=time.perf_counter() - t4,
        card=nvidia_smi())


@contextlib.contextmanager
def recording_calls(calls, module=None):
    """Inside the block, ``module.create_image_analogy`` (``models.modes``'
    by default; ``models.video``'s for a clip) runs with
    ``keep_levels=True`` and appends each call's (a, ap, b, params,
    result, launches, wall seconds, temporal_prev, remap_anchor) to
    ``calls``: the launches counted while the call ran, the call's own
    (``tests/test_torch_modes.py``'s ``_recording``,
    ``tests/test_torch_video.py``'s ``_recorded``)."""
    from image_analogies_tpu_torch.models import modes
    from image_analogies_tpu_torch.ops import match

    module = module or modes
    create = module.create_image_analogy

    def call(a, ap, b, params, *args, temporal_prev=None, remap_anchor=None,
             **kwargs):
        before = dict(match.LAUNCHES)
        t0 = time.perf_counter()
        res = create(a, ap, b, params, *args, temporal_prev=temporal_prev,
                     remap_anchor=remap_anchor, keep_levels=True, **kwargs)
        wall = time.perf_counter() - t0
        launches = {k: n - before.get(k, 0)
                    for k, n in match.LAUNCHES.items() if n - before.get(k, 0)}
        calls.append((a, ap, b, params, res, launches, wall, temporal_prev,
                      remap_anchor))
        return res

    module.create_image_analogy = call
    try:
        yield
    finally:
        module.create_image_analogy = create


def parity_run(label, call, params):
    """``call(params)`` (one application call) through ``run_app``, its one
    ``create_image_analogy`` call recorded and its launches held to
    ``want_launches`` of the recorded inputs and params.  Returns (a, ap,
    b, params, result, launches, wall) of that call."""
    calls = []

    def want(result):
        a, ap, b, p = calls[-1][:4]
        return want_launches(p, b.shape[:2], result.stats,
                             source_channels(a, ap, b, p))

    with recording_calls(calls):
        run_app("parity", label, lambda: call(params), want)
    if len(calls) != 1:
        fail(f"parity {label}: {len(calls)} create_image_analogy calls")
    return calls[0][:7]


def planes_equal(x, y):
    """Every plane of x (a level's (bp, s)) the same shape and bits as
    y's."""
    import numpy as np

    return all(np.asarray(u).shape == np.asarray(v).shape
               and np.asarray(u).tobytes() == np.asarray(v).tobytes()
               for u, v in zip(x, y))


def parity_hold(label, preset, exact, temporal_prev=None, remap_anchor=None,
                **fields):
    """Hold a preset run (``parity_run``) to the ``exact_hi`` run of the
    same call: the same inputs and params but the match mode; every level
    that ran exact_hi in both (below ``PACKED_CROSSOVER_ROWS``) the same
    bits; the tie-audit of the preset run's levels against the exact_hi
    run's at the main path's limits (``UNEXPLAINED_MAX``, the first
    divergence a tie) and SSIM of their B' >= ``SSIM_MIN``, but the
    limits ``PARITY_REPORTED`` names for the pair: SSIM is then printed
    only, and the other two are held to the packed scan's own arithmetic
    instead (every unexplained mismatch, and a first divergence that is no
    tie, the pick the packed2k scores make: the audit's ``packed_pick``
    over the levels that scanned packed2k).  A video call's pair
    passes the call's ``temporal_prev`` and ``remap_anchor`` (both runs
    had the same) on to the audit.  Prints one line, ``fields`` in it, and
    returns it as a dict, what failed under ``failures``
    (``parity_verdict`` fails the phase on any)."""
    import numpy as np

    from image_analogies_tpu_torch.utils.parity import (
        audit_source_map_mismatches)
    from image_analogies_tpu_torch.utils.ssim import ssim

    a, ap, b, params, res, launches, wall = preset
    ea, eap, eb, eparams, eres, elaunches, ewall = exact
    if not (all(np.array_equal(x, y) for x, y in
                ((a, ea), (ap, eap), (b, eb)))
            and eparams == params.replace(match_mode="exact_hi")):
        fail(f"parity {label}: the two runs' inputs or params differ")
    modes = {st["level"]: st["match_mode"] for st in res.stats}
    if {st["match_mode"] for st in eres.stats} != {"exact_hi"}:
        fail(f"parity {label}: the exact_hi run ran "
             f"{[st['match_mode'] for st in eres.stats]}")
    both = sorted(lv for lv, mode in modes.items() if mode == "exact_hi")
    unequal = [lv for lv in both
               if not planes_equal(res.levels[lv], eres.levels[lv])]
    t0 = time.perf_counter()
    audit = audit_source_map_mismatches(
        a, ap, b, params, res.levels, eres.levels,
        temporal_prev=temporal_prev, remap_anchor=remap_anchor,
        packed_levels=[lv for lv, mode in modes.items()
                       if mode == "exact_hi2_2p"])
    audit_s = time.perf_counter() - t0
    frac = audit["unexplained"] / max(audit["mismatches"], 1)
    off_packed = audit["unexplained"] - audit["packed_pick"]
    s = ssim(res.bp_y, eres.bp_y)
    rec = dict(
        pair=label, **fields, size=list(b.shape[:2]),
        match_mode=params.match_mode, level_mode=modes, ssim=s,
        value_match=float((res.source_map == eres.source_map).mean()),
        level_mismatches={r["level"]: r["mismatches"]
                          for r in audit["per_level"]},
        mismatches=audit["mismatches"], ctx_diverged=audit["ctx_diverged"],
        tie_exact=audit["tie_exact"], tie_fp=audit["tie_fp"],
        kappa_boundary=audit["kappa_boundary"],
        unexplained=audit["unexplained"], unexplained_fraction=frac,
        packed_pick=audit["packed_pick"],
        packed_replay=audit["packed_replay"],
        first_divergence_is_tie=audit["first_divergence_is_tie"],
        first_divergence=audit["first_divergence"],
        max_fp_band=audit["max_fp_band"], audit_s=audit_s,
        bit_equal_levels=[lv for lv in both if lv not in unequal],
        wall_s=wall, exact_hi_wall_s=ewall, launches=launches,
        exact_hi_launches=elaunches)
    reported = PARITY_REPORTED.get(label, ())
    failures = []
    if unequal:
        failures.append(f"levels {unequal} ran exact_hi in both runs and "
                        "differ")
    if not s >= SSIM_MIN and "ssim" not in reported:
        failures.append(f"SSIM vs the exact_hi run {s:.4f} < {SSIM_MIN}")
    if "unexplained_fraction" not in reported:
        if not frac <= UNEXPLAINED_MAX:
            failures.append(f"tie-audit unexplained fraction {frac:.3g} > "
                            f"{UNEXPLAINED_MAX}")
    elif off_packed:
        failures.append(f"{off_packed} unexplained mismatches are not the "
                        "packed scan's own pick")
    first = audit["first_divergence"]
    if audit["first_divergence_is_tie"] is False:
        if "first_divergence_is_tie" not in reported:
            failures.append("the first divergence is not a tie")
        elif not first["packed_pick"]:
            failures.append("the first divergence is neither a tie nor the "
                            "packed scan's own pick")
    rec["reported"] = list(reported)
    rec["failures"] = failures
    say("parity", **rec)
    return rec


def parity_verdict(recs):
    """Fail unless every pair held (``parity_hold``'s ``failures``)."""
    bad = [f"{r['pair']}: {f}" for r in recs for f in r["failures"]]
    if bad:
        fail("parity: " + "; ".join(bad))


def parity_pair(label, call, params):
    """One application twice on the same inputs: at ``params``' own match
    mode (the path users run) and at ``match_mode="exact_hi"`` (the fp32
    argmin at every level), held by ``parity_hold``."""
    preset = parity_run(f"{label} {params.match_mode}", call, params)
    exact = parity_run(f"{label} exact_hi", call,
                       params.replace(match_mode="exact_hi"))
    return parity_hold(label, preset, exact)


def parity_cases(rgb_size=PARITY_RGB_SIZE,
                 exact_hi2_size=PARITY_EXACT_HI2_SIZE,
                 app_size=PARITY_APP_SIZE, seed=0, **overrides):
    """The parity phase's pairs in order, as (label, call taking the
    params, the params; ``overrides`` on every preset): super_resolution on
    RGB sources with ``color_mode="source_rgb"`` (``rgb_superres_inputs``:
    packed2kw at 832 lanes at level 0 and 688 at level 1), the same with
    ``match_mode="exact_hi2"`` (packed3w at every level), then on
    ``utils/assets.make_all(app_size, seed)`` as the modes phase runs them:
    texture_by_numbers, artistic_filter with ``oil_filter``,
    super_resolution, texture_synthesis (an exemplar of ``app_size``^2 to
    an output of the same size)."""
    from image_analogies_tpu_torch import PRESETS, modes
    from image_analogies_tpu_torch.utils.assets import make_all

    P = lambda name, **kw: PRESETS[name].replace(**kw, **overrides)
    rgb = rgb_superres_inputs(rgb_size)
    wide = rgb_superres_inputs(exact_hi2_size)
    x = make_all(app_size, seed)
    return [
        ("super_resolution_rgb",
         lambda p: modes.super_resolution(*rgb, p),
         P("super_resolution", color_mode="source_rgb")),
        ("super_resolution_rgb_exact_hi2",
         lambda p: modes.super_resolution(*wide, p),
         P("super_resolution", color_mode="source_rgb",
           match_mode="exact_hi2")),
        ("texture_by_numbers",
         lambda p: modes.texture_by_numbers(
             x["tbn_labels_a"], x["tbn_texture"], x["tbn_labels_b"], p),
         P("texture_by_numbers")),
        ("oil_filter",
         lambda p: modes.artistic_filter(x["filter_a"], x["filter_ap"],
                                         x["filter_b"], p),
         P("oil_filter")),
        ("super_resolution",
         lambda p: modes.super_resolution(x["sr_sharp"], x["sr_low"], p),
         P("super_resolution")),
        ("texture_synthesis",
         lambda p: modes.texture_synthesis(x["texture"],
                                           (app_size, app_size), p),
         P("texture_synthesis")),
    ]


def phase_parity():
    """Each application's preset run held to its exact_hi run on the card
    (``parity_cases``, ``parity_pair``): the packed scans at full width
    against the fp32 argmin, level by level; every pair runs, then the
    phase fails if any did not hold.  RGB super-resolution must
    launch packed2kw_best and its exact_hi2 run packed3w_best.  Returns
    those two kernels' launches for the kernel table."""
    t0 = time.perf_counter()
    recs = {label: parity_pair(label, call, params)
            for label, call, params in parity_cases()}
    parity_verdict(recs.values())
    launches = {
        "packed2kw_best": recs["super_resolution_rgb"]["launches"].get(
            "packed2kw_best", 0),
        "packed3w_best": recs["super_resolution_rgb_exact_hi2"][
            "launches"].get("packed3w_best", 0)}
    if not all(launches.values()):
        fail(f"parity: the RGB pairs launched {launches}")
    say("parity", pairs=len(recs), launches=launches,
        s=time.perf_counter() - t0, card=nvidia_smi())
    return launches


SIDE_PHASES = ("modes", "video", "ann", "mesh", "serve", "chaos", "soak",
               "parity")
SIDE_TIMEOUT_S = 1100
_SIDES = []  # the side processes started, for stop_sides


def side_start(phase, *extra):
    """Start ``phase`` in a child process (this script with ``--phases
    PHASE --inline``, then ``extra``), in a process group of its own so that
    :func:`stop_sides` can stop it with every process it starts (it dies
    with this process too: :func:`die_with_parent`); its output goes to
    files that :func:`side_wait` replays.  Returns the handle for
    side_wait."""
    import tempfile

    d = tempfile.mkdtemp(prefix=f"ia_side_{phase}_")
    out = open(os.path.join(d, "out.log"), "w+")
    err = open(os.path.join(d, "err.log"), "w+")
    result = os.path.join(d, "result.json")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phases", phase,
         "--inline", "--side-out", result, *extra], cwd=HERE, stdout=out,
        stderr=err, process_group=0)
    _SIDES.append(proc)
    return phase, proc, out, err, result


def side_wait(handle):
    """Wait for a side phase, print its output here, and fail unless it
    exited 0 (its standard error's tail in the message).  Returns what the
    phase returned (``--side-out``), or None."""
    phase, proc, out, err, result = handle
    try:
        proc.wait(timeout=SIDE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        stop_sides()
        fail(f"{phase}: its side process ran past {SIDE_TIMEOUT_S} s")
    out.seek(0)
    sys.stdout.write(out.read())
    sys.stdout.flush()
    if proc.returncode != 0:
        err.seek(0)
        fail(f"{phase}: its side process exit {proc.returncode}: "
             f"{err.read()[-3000:]}")
    if os.path.exists(result):
        with open(result) as f:
            return json.load(f)
    return None


def die_with_parent():
    """Have the kernel kill this process when its parent ends (a side
    phase's process, if the script is stopped at its time limit)."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # DEATHSIG
    if os.getppid() == 1:  # the parent ended before the call
        sys.exit(1)


def stop_sides():
    """Stop every side process still running, with every process it
    started (the mesh phase's ranks, the ann phase's subprocesses)."""
    import signal

    for proc in _SIDES:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def laps(phases):
    """A clock for main(): ``lap(name)`` prints, for a phase that ran, the
    seconds since the last lap and since the script began."""
    start = last = time.perf_counter()

    def lap(name):
        nonlocal last
        now = time.perf_counter()
        if name in phases:
            say("time", of=name, s=now - last, total_s=now - start)
        last = now
    return lap


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
    ap.add_argument("--cpu-refs", metavar="OUT",
                    help=argparse.SUPPRESS)  # card_vs_cpu's side process
    ap.add_argument("--inline", action="store_true",
                    help=argparse.SUPPRESS)  # a side phase's own process
    ap.add_argument("--side-out", metavar="PATH",
                    help=argparse.SUPPRESS)  # where it writes its result
    ap.add_argument("--card-after", metavar="PATH",
                    help=argparse.SUPPRESS)  # the soak's side: the window
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

    if args.cpu_refs:
        cpu_refs(args.cpu_refs)
        return
    if args.inline:
        die_with_parent()
    lap = laps(phases)
    if "env" in phases:
        phase_env(args.ptxas)
    lap("env")
    # card_vs_cpu's CPU runs need no card: they run beside the card's work
    # (after the build, whose nvcc processes want every core)
    refs = cpu_refs_start() if "card_vs_cpu" in phases else None
    rows = phase_kernels(args.parent) if "kernels" in phases else None
    lap("kernels")
    path_launches = {}
    if {"main", "oracle", "profile", "exact_hi2", "rescue", "two_pass",
            "batched", "batched_profile", "driver", "lanes",
            "tune", "ann", "mesh", "chaos", "soak"} & set(phases):
        a, ap_, b = load_oracle_inputs()
    if {"main", "oracle", "profile"} & set(phases):
        params, result, path_launches["main"] = phase_main(a, ap_, b)
        lap("main")
        if "oracle" in phases:
            phase_oracle(a, ap_, b, params, result)
            del result
            phase_oracle13(params)
        lap("oracle")
        if "profile" in phases:
            phase_profile(a, ap_, b, params)
        lap("profile")
    if "exact_hi2" in phases:
        path_launches["exact_hi2"] = phase_exact_hi2(a, ap_, b)
    lap("exact_hi2")
    if "rescue" in phases:
        path_launches["rescue"] = phase_probe("rescue", "scan_rescue",
                                              a, ap_, b)
    lap("rescue")
    if "two_pass" in phases:
        path_launches["two_pass"] = phase_probe("two_pass", "two_pass",
                                                a, ap_, b)
    lap("two_pass")
    if "batched" in phases:
        path_launches["batched"] = phase_batched(a, ap_, b)
    lap("batched")
    if "batched_profile" in phases:
        from image_analogies_tpu_torch import PRESETS

        bparams = dataclasses.replace(PRESETS["npr_1024"], strategy="batched")
        run_path("batched_profile", bparams, a, ap_, b, runs=("cold",),
                 keep_levels=False)
        phase_profile(a, ap_, b, bparams, phase="batched_profile")
    lap("batched_profile")
    if "gate" in phases:
        phase_gate()
    lap("gate")
    if "card_vs_cpu" in phases:
        phase_card_vs_cpu(refs)
    lap("card_vs_cpu")
    sides = {}
    window = None  # a file created when the side window opens
    if not args.inline:
        import atexit
        import tempfile

        atexit.register(stop_sides)
        if "soak" in phases:
            # the soak's timed runs go first, on a host only the driver
            # phase shares; its card part waits for the window
            window = os.path.join(tempfile.mkdtemp(prefix="ia_window_"),
                                  "open")
            sides["soak"] = side_start("soak", "--card-after", window)
    if "modes_small" in phases:
        phase_modes_small()
    lap("modes_small")
    if "driver" in phases:
        phase_driver(a, ap_, b)
    lap("driver")
    if not args.inline:
        if window:
            open(window, "w").close()
        sides.update((p, side_start(p)) for p in SIDE_PHASES
                     if p in phases and p not in sides)
    if "lanes" in phases:
        lanes = phase_lanes(a, ap_)
        path_launches["lanes wavefront"] = lanes["wavefront"]
        path_launches["lanes batched"] = lanes["batched"]
    lap("lanes")
    if "tune" in phases:
        phase_tune(a, ap_, b)
    lap("tune")
    if "modes" in phases:
        if sides:
            side_wait(sides["modes"])
        else:
            phase_modes()
    lap("modes")
    if "video" in phases:
        if sides:
            side_wait(sides["video"])
        else:
            phase_video()
    lap("video")
    if "ann" in phases:
        if sides:
            side_wait(sides["ann"])
        else:
            phase_ann(a, ap_, b)
    lap("ann")
    if "mesh" in phases:
        if sides:
            side_wait(sides["mesh"])
        else:
            phase_mesh(a, ap_, b)
    lap("mesh")
    if "serve" in phases:
        if sides:
            side_wait(sides["serve"])
        else:
            phase_serve()
    lap("serve")
    if "chaos" in phases:
        if sides:
            side_wait(sides["chaos"])
        else:
            phase_chaos(a, ap_, b)
    lap("chaos")
    if "soak" in phases:
        if sides:
            side_wait(sides["soak"])
        else:
            phase_soak(a, ap_, b, args.card_after)
    lap("soak")
    if "parity" in phases:
        if sides:
            path_launches["parity"] = side_wait(sides["parity"])
        else:
            path_launches["parity"] = phase_parity()
            if args.side_out:
                with open(args.side_out, "w") as f:
                    json.dump(path_launches["parity"], f)
    lap("parity")
    if sides:
        # every side has exited: a worker_main left anywhere is a leak
        alive = worker_main_pids(own_group=False)
        if alive:
            fail(f"worker_main left after the side phases: {alive}")
    if not set(PHASES) <= set(phases):
        return
    # each kernel's launches from the run of its path (packed2kw_best and
    # packed3w_best: the parity phase's super_resolution on RGB sources at
    # 1024^2, the modes phase's RGB run at the same size, and with
    # exact_hi2 at 512^2); packed_champions (the witness of packed_best)
    # and the four superseded packed forms are on no path, so 0
    # (kernel_row's)
    for path, names in (("main", ("argmin_l2", "packed_best")),
                        ("parity", ("packed2kw_best", "packed3w_best")),
                        ("exact_hi2", ("packed3_best",)),
                        ("rescue", ("pertile_champions",)),
                        ("two_pass", ("argmin2_l2",)),
                        ("batched", ("argmin_l2_bf16",))):
        for name in names:
            rows[name]["launches"] = path_launches[path][name]
    # the lane-width rows: their launches from the lanes phase's k-lane
    # runs (one launch a step or row for all lanes)
    for path, names in (("lanes wavefront", ("packed_best", "argmin_l2")),
                        ("lanes batched", ("argmin_l2_bf16",))):
        for name in names:
            rows[f"{name} ({LANES} lanes)"]["launches"] = \
                path_launches[path][name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
