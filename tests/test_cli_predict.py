"""CLI end-to-end: train via the command line, then --predict -> .mlma,
mirroring the reference's part1/part2 example workflow
(example/part1_gcc_mvapich2.sh, part2_gcc_mvapich2.sh)."""

import os

import numpy as np
import pytest

from gmrm_tpu.cli import main
from gmrm_tpu.io.writers import MLMA_LINE_LEN


def test_cli_train_then_predict(sim_small, tmp_path):
    out = str(tmp_path / "out")
    rc = main([
        "--bed-file", sim_small.bed,
        "--dim-file", sim_small.dim,
        "--phen-files", ",".join(sim_small.phens),
        "--group-index-file", sim_small.gri,
        "--group-mixture-file", sim_small.grm,
        "--iterations", "16",
        "--seed", "171014",
        "--out-dir", out,
        "--block-size", "16",
        "--output-thin-rate", "2",
        "--verbosity", "-1",
        "--devices", "1",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "test1.bet"))

    rc = main([
        "--predict",
        "--bed-file", sim_small.bed,
        "--dim-file", sim_small.dim,
        "--phen-files", ",".join(sim_small.phens),
        "--bim-file", sim_small.bim,
        "--ref-bim-file", sim_small.bim,
        "--out-dir", out,
    ])
    assert rc == 0

    mlma = os.path.join(out, "test1.mlma")
    lines = open(mlma).read().splitlines(keepends=True)
    assert len(lines) == sim_small.m
    assert all(len(ln) == MLMA_LINE_LEN for ln in lines)
    # Parse and sanity-check the association stats.
    recs = [ln.split() for ln in lines]
    beta = np.array([float(r[3]) for r in recs])
    tdist = np.array([float(r[4]) for r in recs])
    pval = np.array([float(r[6]) for r in recs])
    assert np.all(np.isfinite(beta))
    assert np.all((pval >= 0) & (pval <= 1))
    # Strong effects should be enriched among true causal markers.
    top = np.argsort(-np.abs(tdist))[:10]
    causal = np.abs(sim_small.beta_true[:, 0]) > 0
    assert causal[top].mean() > 0.5

    # Sharded predict (8-device mesh) must be byte-identical to the
    # single-device pass.
    mlma_8dev = open(mlma, "rb").read()
    rc = main([
        "--predict",
        "--bed-file", sim_small.bed,
        "--dim-file", sim_small.dim,
        "--phen-files", ",".join(sim_small.phens),
        "--bim-file", sim_small.bim,
        "--ref-bim-file", sim_small.bim,
        "--out-dir", out,
        "--devices", "1",
    ])
    assert rc == 0
    assert open(mlma, "rb").read() == mlma_8dev


def test_cli_missing_args():
    assert main(["--bed-file", "/nonexistent.bed"]) == 1
    assert main(["--predict", "--bed-file", "x", "--dim-file", "y",
                 "--phen-files", "z"]) == 1


def test_cli_partial_ref_bim(sim_small, tmp_path):
    """Markers absent from the reference bim are excluded from .mlma
    (reference bayes.cpp:228-241)."""
    out = str(tmp_path / "out2")
    rc = main([
        "--bed-file", sim_small.bed, "--dim-file", sim_small.dim,
        "--phen-files", sim_small.phens[0],
        "--group-index-file", sim_small.gri,
        "--group-mixture-file", sim_small.grm,
        "--iterations", "4", "--seed", "1", "--out-dir", out,
        "--block-size", "16", "--verbosity", "-1", "--devices", "1",
    ])
    assert rc == 0
    # Reference bim missing the last 10 markers.
    ref = tmp_path / "partial.bim"
    with open(sim_small.bim) as fh:
        keep_lines = fh.read().splitlines()[: sim_small.m - 10]
    ref.write_text("\n".join(keep_lines) + "\n")
    with pytest.raises(IOError):
        # Mtot in .bet (full M) vs ref bim size mismatch -> hard error,
        # like the reference's MPI_Abort (bayes.cpp:48-51).
        main_raise(sim_small, out, str(ref))


def main_raise(sim, out, ref_bim):
    from gmrm_tpu.cli import build_parser, options_from_args
    from gmrm_tpu.predict import run_predict
    args = build_parser().parse_args([
        "--predict", "--bed-file", sim.bed, "--dim-file", sim.dim,
        "--phen-files", sim.phens[0], "--bim-file", sim.bim,
        "--ref-bim-file", ref_bim, "--out-dir", out,
    ])
    run_predict(options_from_args(args), verbose=False)


def test_predict_parity_vs_compiled_reference():
    """Field-level .mlma parity against the compiled reference binary
    (src/bayes.cpp:16-284): the full harness at example scale — train
    once, run both --predicts on the same .bet, compare beta/t/se/p and
    framing, in both the all-kept and ids-renamed/excluded scenarios."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    binary = os.path.join(repo, "baseline", "build", "gmrm_ref")
    if not os.path.exists(binary):
        r = subprocess.run(["make", "-C", os.path.join(repo, "baseline")],
                           capture_output=True, timeout=300)
        if r.returncode != 0:
            pytest.skip("reference binary unavailable "
                        "(baseline build failed)")
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "benchmarking",
                                      "predict_parity.py"),
         "--quick", "--no-report", "--n", "500", "--m", "400"],
        capture_output=True, text=True, timeout=600, cwd=repo)
    assert proc.returncode == 0, \
        f"predict parity failed:\n{proc.stdout[-4000:]}\n" \
        f"{proc.stderr[-2000:]}"
    assert "Predict parity: PASS" in proc.stdout
