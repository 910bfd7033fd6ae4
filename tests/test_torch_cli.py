"""The port's command line (``python -m image_analogies_tpu_torch.cli``)
against the JAX package's, on the CPU.

Both CLIs run in this process on the same PNG inputs (the port's asset
generators at 24^2, written by the port's ``save_image``) with the same
flags, the port with ``--device cpu`` and the JAX package with ``--backend
tpu`` (its exact fp32 scan on the JAX CPU platform).  Each must write its
files and print the same lines to stdout (paths relative to its own output
directory); each level's stats go to stderr as JSON lines.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from image_analogies_tpu import cli as jcli
from image_analogies_tpu_torch import cli as tcli
from image_analogies_tpu_torch.utils import assets
from image_analogies_tpu_torch.utils.imageio import load_image, save_image
from image_analogies_tpu_torch.utils.ssim import ssim
from tests.test_torch_wavefront import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_inputs")
    arrs = assets.make_all(24, 1)
    for name, img in arrs.items():
        save_image(str(d / f"{name}.png"), img)
    return d


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _both(argv_of, tmp_path, capsys):
    """Run ``argv_of(out_dir)`` through the JAX CLI (``--backend tpu``) and
    the port's (``--device cpu``); returns {side: (out_dir, rc, stdout,
    stderr)} with stdout's output directory replaced by ``OUT``."""
    res = {}
    for side, main, extra in (("jax", jcli.main, ["--backend", "tpu"]),
                              ("port", tcli.main, ["--device", "cpu"])):
        out_dir = tmp_path / side
        out_dir.mkdir()
        rc, out, err = _run(main, argv_of(str(out_dir)) + extra, capsys)
        res[side] = (out_dir, rc, out.replace(str(out_dir), "OUT"), err)
    return res


def _stats(err):
    return [json.loads(line) for line in err.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("mode,files,extra", [
    ("filter", dict(a="filter_a", ap="filter_ap", b="filter_b"),
     ["--levels", "2", "--kappa", "3"]),
    ("texture_by_numbers", dict(a="tbn_labels_a", ap="tbn_texture",
                                b="tbn_labels_b"), []),
    ("super_resolution", dict(ap="sr_sharp", b="sr_low"),
     ["--blur-passes", "1", "--patch-size", "5"]),
    ("texture_synthesis", dict(ap="texture"),
     ["--out-shape", "20x18", "--levels", "2"]),
    ("texture_synthesis", dict(ap="texture"),
     ["--out-shape", "16x16", "--levels", "1", "--seed", "4"]),
])
def test_cli_run_matches_jax(mode, files, extra, inputs, tmp_path, capsys):
    argv_of = lambda out_dir: (
        ["run", "--mode", mode, "--out", os.path.join(out_dir, "bp.png")]
        + [x for k, v in files.items() for x in (f"--{k}",
                                                 str(inputs / f"{v}.png"))]
        + extra)
    res = _both(argv_of, tmp_path, capsys)
    (jd, jrc, jout, jerr), (td, trc, tout, terr) = res["jax"], res["port"]
    assert jrc == trc == 0
    assert tout == jout == "OUT/bp.png\n"
    j_img, t_img = load_image(str(jd / "bp.png")), load_image(
        str(td / "bp.png"))
    assert t_img.shape == j_img.shape
    assert ssim(t_img if t_img.ndim == 2 else t_img.mean(-1),
                j_img if j_img.ndim == 2 else j_img.mean(-1)) >= 0.99
    jst, tst = _stats(jerr), _stats(terr)
    assert [s["level"] for s in tst] == [s["level"] for s in jst]
    assert all(s["backend"] == "cpu" and "coherence_ratio" in s for s in tst)


@pytest.mark.parametrize("scheme", ["two_phase", "sequential"])
def test_cli_video_matches_jax(scheme, inputs, tmp_path, capsys):
    frames = [str(inputs / f"video_f{t}.png") for t in range(3)]
    argv_of = lambda out_dir: [
        "video", "--a", str(inputs / "filter_a.png"),
        "--ap", str(inputs / "filter_ap.png"), "--frames", *frames,
        "--out-dir", out_dir, "--scheme", scheme, "--levels", "2",
        "--temporal-weight", "2"]
    res = _both(argv_of, tmp_path, capsys)
    (jd, jrc, jout, jerr), (td, trc, tout, terr) = res["jax"], res["port"]
    assert jrc == trc == 0 and tout == jout
    assert tout.split() == [f"OUT/frame_{t:04d}.png" for t in range(3)]
    for t in range(3):
        name = f"frame_{t:04d}.png"
        assert np.array_equal(load_image(str(td / name)),
                              load_image(str(jd / name))), name
    tst = _stats(terr)
    assert len(tst) == len(_stats(jerr))
    assert {s["frame"] for s in tst} == {0, 1, 2}


def test_cli_sweep_and_eval_match_jax(inputs, tmp_path, capsys):
    argv_of = lambda out_dir: [
        "sweep", "--ap", str(inputs / "sr_sharp.png"),
        "--b", str(inputs / "sr_low.png"), "--kappas", "0,0.5,2",
        "--out-dir", out_dir, "--ref", str(inputs / "sr_sharp.png"),
        "--levels", "1"]
    res = _both(argv_of, tmp_path, capsys)
    (jd, jrc, jout, _), (td, trc, tout, _) = res["jax"], res["port"]
    assert jrc == trc == 0
    recs = [json.loads(line) for line in tout.splitlines()]
    assert [r["kappa"] for r in recs] == [0.0, 0.5, 2.0]
    assert recs == [json.loads(line) for line in jout.splitlines()]
    for r in recs:
        assert os.path.exists(r["out"].replace("OUT", str(td)))
    a, b = str(td / "kappa_0.png"), str(jd / "kappa_2.png")
    ev = {}
    for side, main in (("jax", jcli.main), ("port", tcli.main)):
        rc, out, _ = _run(main, ["eval", "--a", a, "--b", b], capsys)
        assert rc == 0
        ev[side] = out
    assert ev["port"] == ev["jax"]
    assert 0.0 < json.loads(ev["port"])["ssim"] <= 1.0


def test_cli_runs_on_the_card_by_default(inputs, tmp_path, monkeypatch,
                                         capsys):
    """Without ``--device cpu`` the CLI runs on the card, and where there is
    none it exits non-zero with the port's message, writing nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "bp.png"
    rc, stdout, err = _run(tcli.main, [
        "run", "--mode", "filter", "--a", str(inputs / "filter_a.png"),
        "--ap", str(inputs / "filter_ap.png"), "--b",
        str(inputs / "filter_b.png"), "--out", str(out)], capsys)
    assert rc != 0 and stdout == "" and not out.exists()
    assert "CUDA is not available" in err and "--device cpu" in err
    args = tcli.build_parser().parse_args(
        ["video", "--a", "a", "--ap", "b", "--frames", "f", "--out-dir", "o"])
    assert args.device == "cuda"


def test_cli_flags(monkeypatch, capsys):
    """The engine flags the port has; the experimental match modes only
    under IA_EXPERIMENTAL=1; a mode's missing inputs are refused."""
    monkeypatch.delenv("IA_EXPERIMENTAL", raising=False)
    base = ["run", "--ap", "x", "--a", "y", "--b", "z", "--out", "o"]
    args = tcli.build_parser().parse_args(base + [
        "--levels", "2", "--kappa", "1.5", "--patch-size", "7",
        "--coarse-patch-size", "5", "--strategy", "batched",
        "--refine-passes", "1", "--match-mode", "exact_hi2",
        "--no-remap", "--no-gaussian"])
    p = tcli._params_from_args(args, tcli.PRESETS["oil_filter"])
    assert (p.levels, p.kappa, p.patch_size, p.coarse_patch_size,
            p.strategy, p.refine_passes, p.match_mode, p.remap_luminance,
            p.gaussian_weights, p.device) == (
        2, 1.5, 7, 5, "batched", 1, "exact_hi2", False, False, "cuda")
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(base + ["--match-mode", "two_pass"])
    monkeypatch.setenv("IA_EXPERIMENTAL", "1")
    args = tcli.build_parser().parse_args(base + ["--match-mode",
                                                  "two_pass"])
    assert args.match_mode == "two_pass"
    with pytest.raises(SystemExit):
        tcli.main(["run", "--mode", "filter", "--ap", "x", "--out", "o",
                   "--device", "cpu"])
    assert "--a --b required" in capsys.readouterr().err


def test_cli_module_entry_point():
    """``python -m image_analogies_tpu_torch.cli`` parses and dispatches
    (``--help`` lists the four subcommands); importing the CLI imports no
    JAX."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['cli', '--help'];"
         "runpy.run_module('image_analogies_tpu_torch.cli', "
         "run_name='__main__')"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    for cmd in ("run", "video", "sweep", "eval"):
        assert cmd in out.stdout
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys, image_analogies_tpu_torch.cli;"
         "print(any(m == 'jax' or m.startswith('jax.') "
         "or m.startswith('image_analogies_tpu.') for m in sys.modules))"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert probe.returncode == 0 and probe.stdout.strip() == "False", probe
