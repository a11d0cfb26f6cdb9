"""Predict parity: gmrm_tpu --predict vs the COMPILED reference gmrm.

Predict is deterministic given a trained ``.bet`` chain, so unlike the
MCMC equivalence check this is a FIELD-LEVEL comparison: train once with
our sampler, hand the identical ``.bet`` to both implementations'
``--predict`` (reference ``src/bayes.cpp:16-284``), and compare the
``.mlma`` outputs marker by marker —

* framing: byte length, fixed-width layout (``bayes.cpp:223-254``,
  LLEN=124 lines), id/mglo/rmglo columns exactly;
* beta, tdist to <= 1e-12 hybrid rel/abs (|d| <= 1e-12 max(|ref|, rms):
  both sides sum N f64 terms in different orders, so near-zero xty keeps
  ~1e-13 absolute cancellation noise), se to <= 1e-12 pure relative
  (reference computes in double, ``bayes.cpp:191-205``; we run float64
  via JAX_ENABLE_X64 on CPU);
* p to <= 1e-10 absolute (boost ``gamma_p(.5, t^2/2)`` vs our exactly
  equal ``erfc(|t|/sqrt 2)`` evaluation, ``bayes.cpp:202-205``).

Two scenarios: (A) ref-bim == bim (all markers kept) and (B) a ref-bim
of the SAME size with a fraction of ids renamed — the only mismatch
shape the reference accepts (it aborts when Mtot != ref-bim size,
``bayes.cpp:47-50``) — exercising the exclusion/compaction path.

Appends a PASS table to benchmarking/EQUIVALENCE.md.  Exit 1 on failure.

Usage: python benchmarking/predict_parity.py [--quick] [--no-report]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
WORK = os.path.join(REPO, ".smoke")


def train_ours(sim, out_dir, iterations=40, thin=2):
    from gmrm_tpu.config import Options
    from gmrm_tpu.runner import run_training
    shutil.rmtree(out_dir, ignore_errors=True)
    opt = Options(
        bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
        group_index_file=sim.gri, group_mixture_file=sim.grm,
        iterations=iterations, seed=42, output_thin_rate=thin,
        block_size=64, out_dir=out_dir)
    run_training(opt, verbose=False)


def run_ref_predict(binary, sim, bim, ref_bim, out_dir):
    cmd = [
        binary, "--predict",
        "--bed-file", sim.bed, "--dim-file", sim.dim,
        "--phen-files", ",".join(sim.phens),
        "--bim-file", bim, "--ref-bim-file", ref_bim,
        "--out-dir", out_dir,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    if proc.returncode != 0:
        raise RuntimeError(
            f"reference predict failed:\n{proc.stdout[-3000:]}\n"
            f"{proc.stderr[-2000:]}")


def run_our_predict(sim, bim, ref_bim, out_dir):
    """Subprocess so JAX_ENABLE_X64 + CPU backend apply cleanly (the
    parent may hold an accelerator client); float64 end-to-end like the
    reference's doubles."""
    cmd = [
        sys.executable, "-m", "gmrm_tpu", "--predict",
        "--bed-file", sim.bed, "--dim-file", sim.dim,
        "--phen-files", ",".join(sim.phens),
        "--bim-file", bim, "--ref-bim-file", ref_bim,
        "--out-dir", out_dir, "--dtype", "float64", "--devices", "1",
    ]
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          env=env, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(
            f"our predict failed:\n{proc.stdout[-3000:]}\n"
            f"{proc.stderr[-3000:]}")


def parse_mlma(path):
    ids, mglo, rmglo = [], [], []
    vals = []
    raw_lens = []
    with open(path) as fh:
        for line in fh:
            raw_lens.append(len(line))
            p = line.split()
            ids.append(p[0])
            mglo.append(int(p[1]))
            rmglo.append(int(p[2]))
            vals.append([float(x) for x in p[3:7]])
    v = np.array(vals, np.float64)  # beta, tdist, se, pval
    return {"ids": ids, "mglo": np.array(mglo), "rmglo": np.array(rmglo),
            "beta": v[:, 0], "tdist": v[:, 1], "se": v[:, 2],
            "pval": v[:, 3], "raw_lens": raw_lens,
            "raw": open(path, "rb").read()}


def compare(ref_path, our_path, tag):
    """-> (rows, ok) field-level comparison of two .mlma files."""
    r = parse_mlma(ref_path)
    o = parse_mlma(our_path)
    rows, ok = [], True

    def check(name, cond, detail):
        nonlocal ok
        ok = ok and bool(cond)
        rows.append((tag, name, "PASS" if cond else "FAIL", detail))

    from gmrm_tpu.io.writers import MLMA_LINE_LEN  # = reference LLEN-1 = 123
    check("line count", len(r["ids"]) == len(o["ids"]),
          f"{len(r['ids'])} vs {len(o['ids'])}")
    check(f"framing ({MLMA_LINE_LEN}-byte lines)",
          set(r["raw_lens"]) == {MLMA_LINE_LEN}
          and set(o["raw_lens"]) == {MLMA_LINE_LEN},
          f"ref lens {sorted(set(r['raw_lens']))}, "
          f"ours {sorted(set(o['raw_lens']))}")
    if len(r["ids"]) != len(o["ids"]):
        return rows, False
    check("marker ids", r["ids"] == o["ids"], "exact")
    check("mglo column", np.array_equal(r["mglo"], o["mglo"]), "exact")
    check("rmglo column", np.array_equal(r["rmglo"], o["rmglo"]), "exact")
    # Hybrid rel/abs: |d| <= tol * max(|ref|, rms(ref)).  Pure relative
    # error is unattainable where xty ~ 0 — both sides sum ~N f64 terms
    # in different orders, leaving ~1e-13 ABSOLUTE cancellation noise on
    # values whose magnitude is itself ~1e-2 of typical; se = beta/tdist
    # cancels the noise and passes pure-relative below.
    for f, tol in [("beta", 1e-12), ("tdist", 1e-12)]:
        rms = float(np.sqrt(np.mean(r[f] ** 2)))
        denom = np.maximum(np.abs(r[f]), rms)
        rel = float(np.max(np.abs(r[f] - o[f]) / denom))
        check(f"{f} err / max(|ref|, rms)", rel <= tol,
              f"max {rel:.2e} <= {tol:g} (rms {rms:.3g})")
    denom = np.maximum(np.abs(r["se"]), 1e-300)
    rel = float(np.max(np.abs(r["se"] - o["se"]) / denom))
    check("se rel err", rel <= 1e-12, f"max {rel:.2e} <= 1e-12")
    pabs = float(np.max(np.abs(r["pval"] - o["pval"])))
    check("pval abs err", pabs <= 1e-10, f"max {pabs:.2e} <= 1e-10")
    ident = r["raw"] == o["raw"]
    rows.append((tag, "raw bytes", "identical" if ident else
                 f"differ (expected: last-digit fp formatting)", ""))
    return rows, ok


def make_mismatch_bim(src, dst, frac=0.05, seed=7):
    """Same marker COUNT (the reference aborts otherwise), a fraction of
    ids renamed so they miss the lookup (bayes.cpp:104-107)."""
    lines = open(src).read().splitlines()
    rng = np.random.default_rng(seed)
    drop = rng.choice(len(lines), max(1, int(len(lines) * frac)),
                      replace=False)
    out = []
    for i, ln in enumerate(lines):
        f = ln.split("\t")
        if i in np.asarray(drop):
            f[1] = f"absent_{i}"
        out.append("\t".join(f))
    with open(dst, "w") as fh:
        fh.write("\n".join(out) + "\n")
    return len(drop)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--m", type=int, default=0)
    ap.add_argument("--no-report", action="store_true",
                    help="don't touch EQUIVALENCE.md (test mode)")
    args = ap.parse_args()

    n = args.n or (1000 if args.quick else 2500)
    m = args.m or (1000 if args.quick else 3000)
    n_traits = 2

    from gmrm_tpu.io.sim import simulate
    data = f"{WORK}/predpar_data_{n}x{m}"
    sim = simulate(data, n=n, m=m, n_traits=n_traits, n_causal=m // 4,
                   h2=0.5, n_groups=2, na_rate=0.01, seed=20260821,
                   mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))

    binary = os.path.join(REPO, "baseline", "build", "gmrm_ref")
    if not os.path.exists(binary):
        subprocess.run(["make", "-C", os.path.join(REPO, "baseline")],
                       check=True, capture_output=True)

    train_dir = f"{WORK}/predpar_train_{n}x{m}"
    train_ours(sim, train_dir, iterations=24 if args.quick else 40)
    print("# training done", flush=True)

    ref_bim_mis = os.path.join(data, "test_mismatch.bim")
    n_renamed = make_mismatch_bim(sim.bim, ref_bim_mis)

    all_rows, all_ok = [], True
    for tag, ref_bim in [("A: full match", sim.bim),
                         ("B: %d ids renamed" % n_renamed, ref_bim_mis)]:
        dirs = {}
        for impl in ("ref", "ours"):
            d = f"{WORK}/predpar_{impl}_{n}x{m}_{tag[0]}"
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(train_dir, d)   # both read the SAME .bet
            dirs[impl] = d
        run_ref_predict(binary, sim, sim.bim, ref_bim, dirs["ref"])
        run_our_predict(sim, sim.bim, ref_bim, dirs["ours"])
        for t in range(n_traits):
            rows, ok = compare(
                os.path.join(dirs["ref"], f"test{t + 1}.mlma"),
                os.path.join(dirs["ours"], f"test{t + 1}.mlma"),
                f"{tag}, trait {t}")
            all_rows += rows
            all_ok = all_ok and ok
        print(f"# scenario {tag} compared", flush=True)

    lines = [
        "## Predict parity vs the compiled reference (field-level)",
        "",
        f"Dataset N={n} x M={m}, {n_traits} traits, 1% NAs; one shared "
        f".bet chain (ours, 40 recorded iterations) fed to BOTH "
        f"implementations' `--predict`.  Reference doubles vs our "
        f"float64 (JAX_ENABLE_X64, CPU).  Matching "
        f"`src/bayes.cpp:16-284`.",
        "",
        "| scenario | field | result | detail |",
        "|---|---|---|---|",
    ]
    for tag, name, res, detail in all_rows:
        lines.append(f"| {tag} | {name} | {res} | {detail} |")
    lines += ["", f"**Predict parity: {'PASS' if all_ok else 'FAIL'}**", ""]
    report = "\n".join(lines)
    print(report)
    if not args.no_report:
        with open(os.path.join(HERE, "EQUIVALENCE.md"), "a") as fh:
            fh.write("\n" + report)
    sys.exit(0 if all_ok else 1)


if __name__ == "__main__":
    main()
