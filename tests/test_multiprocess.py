"""Multi-process (multi-host-simulation) execution tests.

The device-mesh analog of the reference's multi-rank MPI runs
(bayes.cpp:867-900 per-rank loads + Allgatherv protocol): two OS processes
x 4 virtual CPU devices each form one 8-device global mesh via
jax.distributed + gloo.  The sampler's randomness depends only on the
global mesh size and seed, never on the process layout, so the artifacts
must match a 1-process x 8-device run up to collective-implementation
float noise: the cross-process psum (gloo ring) and the in-process XLA
all-reduce accumulate in different orders, giving ~1e-7 relative
differences in the residual merges.  Over a short chain those stay tiny
(asserted at 1e-4); component flips are asserted rare (<1%).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def mp_dataset(tmp_path_factory):
    # Simulate in a subprocess so this test module never imports jax into
    # the pytest process with the wrong device count.
    d = str(tmp_path_factory.mktemp("mpdata"))
    code = (
        "import sys; sys.path.insert(0, %r); "
        "from gmrm_tpu.io.sim import simulate; "
        "simulate(%r, n=400, m=300, n_traits=2, n_causal=64, h2=0.5, "
        "n_groups=2, na_rate=0.02, seed=7)" % (REPO, d)
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
    return d


def _run_single(data_dir, out_dir, iterations=10, checkpoint_every=0,
                resume=False):
    code = f"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {REPO!r})
from gmrm_tpu import compile_cache
compile_cache.enable()
from gmrm_tpu.config import Options
from gmrm_tpu.parallel.runner import run_training_sharded
phens = sorted(os.path.join({data_dir!r}, f) for f in os.listdir({data_dir!r})
               if f.endswith(".phen"))
opt = Options(bed_file={data_dir!r} + "/test.bed",
              dim_file={data_dir!r} + "/test.dim", phen_files=phens,
              group_index_file={data_dir!r} + "/test.gri",
              group_mixture_file={data_dir!r} + "/test.grm",
              iterations={iterations}, seed=42, out_dir={out_dir!r},
              block_size=16, output_thin_rate=2,
              checkpoint_every={checkpoint_every}, resume={resume},
              wave_size=4)
run_training_sharded(opt, verbose=False)
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=900)


def _run_predict_single(data_dir, out_dir):
    code = f"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {REPO!r})
from gmrm_tpu import compile_cache
compile_cache.enable()
from gmrm_tpu.config import Options
from gmrm_tpu.predict import run_predict
phens = sorted(os.path.join({data_dir!r}, f) for f in os.listdir({data_dir!r})
               if f.endswith(".phen"))
opt = Options(bed_file={data_dir!r} + "/test.bed",
              dim_file={data_dir!r} + "/test.dim", phen_files=phens,
              bim_file={data_dir!r} + "/test.bim",
              ref_bim_file={data_dir!r} + "/test.bim",
              out_dir={out_dir!r}, predict=True)
run_predict(opt, verbose=False)
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=900)


def test_two_process_predict_matches_single_process(mp_dataset, tmp_path):
    """Multi-process predict: per-process .bed/.bet slice reads +
    positioned .mlma writes must produce BYTE-IDENTICAL output to the
    single-process run (the reference's per-rank MPI_File_write_at
    protocol, bayes.cpp:223-254; per-marker OLS never crosses ranks)."""
    out = str(tmp_path / "outp")
    # Train once (single process) to produce the .bet chains.
    _run_single(mp_dataset, out)
    _run_predict_single(mp_dataset, out)
    import glob
    singles = {os.path.basename(p): open(p, "rb").read()
               for p in glob.glob(f"{out}/*.mlma")}
    assert singles

    port = _free_port()
    worker = os.path.join(HERE, "multiprocess_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), mp_dataset,
             out, "predict"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    for p in procs:
        out_text, _ = p.communicate(timeout=900)
        assert p.returncode == 0, out_text[-3000:]

    for name, blob in singles.items():
        two = open(os.path.join(out, name), "rb").read()
        assert two == blob, f"{name}: 2-process .mlma differs"


def test_two_process_run_matches_single_process(mp_dataset, tmp_path):
    out_mp = str(tmp_path / "out_mp")
    out_sp = str(tmp_path / "out_sp")
    port = _free_port()

    worker = os.path.join(HERE, "multiprocess_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), mp_dataset,
             out_mp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    _run_single(mp_dataset, out_sp)

    from gmrm_tpu.io.writers import read_history
    for t in (1, 2):
        its_mp, bet_mp = read_history(f"{out_mp}/test{t}.bet", "f8")
        its_sp, bet_sp = read_history(f"{out_sp}/test{t}.bet", "f8")
        assert np.array_equal(its_mp, its_sp)
        assert bet_mp.shape == bet_sp.shape
        np.testing.assert_allclose(
            bet_mp, bet_sp, rtol=1e-3, atol=1e-5,
            err_msg=f"trait {t}: 2-process betas diverge beyond "
                    f"collective float noise")
        _, cpn_mp = read_history(f"{out_mp}/test{t}.cpn", "i4")
        _, cpn_sp = read_history(f"{out_sp}/test{t}.cpn", "i4")
        flip = (cpn_mp != cpn_sp).mean()
        assert flip < 0.01, f"trait {t}: {flip:.3%} component flips"
        # csv rows: same count/width, numerically close fields
        rows_mp = open(f"{out_mp}/test{t}.csv").read().splitlines()
        rows_sp = open(f"{out_sp}/test{t}.csv").read().splitlines()
        assert len(rows_mp) == len(rows_sp)
        for rm, rs in zip(rows_mp, rows_sp):
            vm = np.array([float(x) for x in rm.split(",")])
            vs = np.array([float(x) for x in rs.split(",")])
            np.testing.assert_allclose(vm, vs, rtol=1e-3, atol=1e-5)


def test_cross_topology_resume(mp_dataset, tmp_path):
    """Topology-portable sharded resume: checkpoint
    under 1 process x 8 devices, RESUME under 2 processes x 4 devices
    (same 8-device global mesh -> identical draws; only collective float
    noise differs), and the completed chain must match an uninterrupted
    single-process run within the same tolerances as the pure
    multi-process test above."""
    out_ct = str(tmp_path / "out_ct")
    out_ref = str(tmp_path / "out_ref")

    # 1x8: run to it=5, checkpoint.npz written at it=5 (v2 portable).
    _run_single(mp_dataset, out_ct, iterations=5, checkpoint_every=5)
    assert os.path.exists(os.path.join(out_ct, "checkpoint.npz"))

    # 2x4: resume 6..10 from the 1x8 checkpoint.
    port = _free_port()
    worker = os.path.join(HERE, "multiprocess_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), mp_dataset,
             out_ct, "resume:10:5"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    _run_single(mp_dataset, out_ref, iterations=10)

    from gmrm_tpu.io.writers import read_history
    for t in (1, 2):
        its_a, bet_a = read_history(f"{out_ct}/test{t}.bet", "f8")
        its_b, bet_b = read_history(f"{out_ref}/test{t}.bet", "f8")
        assert np.array_equal(its_a, its_b)
        np.testing.assert_allclose(
            bet_a, bet_b, rtol=1e-3, atol=1e-5,
            err_msg=f"trait {t}: cross-topology resume diverges beyond "
                    f"collective float noise")
        _, cpn_a = read_history(f"{out_ct}/test{t}.cpn", "i4")
        _, cpn_b = read_history(f"{out_ref}/test{t}.cpn", "i4")
        assert (cpn_a != cpn_b).mean() < 0.01


def test_two_process_startup_cache(mp_dataset, tmp_path):
    """Multi-process --cache-dir: a cold run saves one file per process;
    a warm run reuses them with byte-identical artifacts; a MIXED
    warm/cold state (one process's file deleted) must agree globally and
    rebuild everywhere — a process skipping the collective stats/Gram
    builds would deadlock the other (multi-controller SPMD)."""
    cache = str(tmp_path / "mpcache")
    worker = os.path.join(HERE, "multiprocess_worker.py")

    def run2(out):
        port = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(pid), "2", str(port),
                 mp_dataset, out, "train", cache],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(2)
        ]
        outs = [p.communicate(timeout=900)[0] for p in procs]
        for p, txt in zip(procs, outs):
            assert p.returncode == 0, txt[-3000:]

    out1 = str(tmp_path / "cc1")
    run2(out1)
    files = sorted(os.listdir(cache))
    assert len(files) == 2
    assert any(f.startswith("startup_shard_p0_") for f in files)
    assert any(f.startswith("startup_shard_p1_") for f in files)

    out2 = str(tmp_path / "cc2")
    run2(out2)
    assert sorted(os.listdir(cache)) == files      # reused, not rebuilt
    for t in (1, 2):
        for suf in (".bet", ".cpn", ".csv"):
            a = open(f"{out1}/test{t}{suf}", "rb").read()
            b = open(f"{out2}/test{t}{suf}", "rb").read()
            assert a == b, f"test{t}{suf}: warm 2-process run differs"

    # Mixed warm/cold: drop process 1's file; the next run must NOT
    # deadlock, and must rebuild (and re-save) everywhere.
    p1 = next(f for f in files if f.startswith("startup_shard_p1_"))
    os.remove(os.path.join(cache, p1))
    out3 = str(tmp_path / "cc3")
    run2(out3)
    assert len(os.listdir(cache)) == 2
    a = open(f"{out1}/test1.bet", "rb").read()
    b = open(f"{out3}/test1.bet", "rb").read()
    assert a == b, "mixed-state rebuild run differs"


@pytest.mark.skipif(not os.environ.get("GMRM_SLOW"),
                    reason="slow UKB-shaped rehearsal; set GMRM_SLOW=1")
def test_ukb_rehearsal_8proc():
    """tests/-runnable entry for the 8-process UKB-shaped rehearsal
: full pipeline (sharded load -> checkpoint ->
    crash -> resume -> sharded predict) at a reduced shape.  The full
    50k x 64k run is recorded in benchmarking/SCALE.md."""
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "benchmarking", "rehearsal_ukb.py"),
         "--n", "2000", "--m", "8192", "--iters", "8", "--no-report"],
        capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stdout[-4000:]
