"""Predict-mode benchmark.

The reference benches prediction separately (benchmarking/test_pred.sh;
its predict timer is src/bayes.cpp:282-283 "time to predict").  This
driver trains a short chain on the bench-anchor dataset (N=10k x
Mt=20k, 4 traits — the same workload bench.py uses) to produce a .bet
history, then times `run_predict` end-to-end (beta-mean streaming from
.bet, X_std @ beta_mean, OLS scan, .mlma writes) and prints one JSON
line:

  {"metric": "predict_markers_per_s", ...}

Timing is wall-clock over the whole predict pass (the reference's timer
brackets the same span) with a warm jit cache: one untimed pass first, so
compile time is excluded like the training bench's warmup.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
WORK = os.path.join(REPO, ".smoke")

import numpy as np

N, MT, TRAITS = 10_000, 20_000, 4
TRAIN_ITERS, THIN = 10, 2


def main():
    sys.path.insert(0, REPO)
    import bench as bench_mod
    data_dir = bench_mod.build_dataset()

    from gmrm_tpu.config import Options
    from gmrm_tpu.predict import run_predict
    from gmrm_tpu.runner import run_training

    out_dir = f"{WORK}/bench_predict_out"
    opt = Options(
        bed_file=f"{data_dir}/test.bed", dim_file=f"{data_dir}/test.dim",
        phen_files=[f"{data_dir}/test{i+1}.phen" for i in range(TRAITS)],
        group_index_file=f"{data_dir}/test.gri",
        group_mixture_file=f"{data_dir}/test.grm",
        iterations=TRAIN_ITERS, seed=42, out_dir=out_dir,
        output_thin_rate=THIN,
    )
    if not os.path.exists(os.path.join(out_dir, "test1.bet")):
        t0 = time.perf_counter()
        run_training(opt, verbose=False)
        print(f"# trained {TRAIN_ITERS} iters for the .bet history "
              f"({time.perf_counter()-t0:.1f}s)", file=sys.stderr,
              flush=True)

    popt = Options(
        bed_file=f"{data_dir}/test.bed", dim_file=f"{data_dir}/test.dim",
        phen_files=[f"{out_dir}/test{i+1}.phen" for i in range(TRAITS)],
        bim_file=f"{data_dir}/test.bim",
        ref_bim_file=f"{data_dir}/test.bim",
        out_dir=out_dir, predict=True,
    )
    # predict reads <out_dir>/<stem>.bet for each phen stem; phen files
    # live in data_dir, outputs in out_dir — the reference resolves both
    # through out_dir, so point the phen paths at data_dir but keep the
    # stems identical.
    popt.phen_files = [f"{data_dir}/test{i+1}.phen" for i in range(TRAITS)]

    run_predict(popt, verbose=False)           # warm the jit caches
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_predict(popt, verbose=False)
        best = min(best, time.perf_counter() - t0)

    mlma = os.path.join(out_dir, "test1.mlma")
    n_lines = sum(1 for _ in open(mlma))
    out = {
        "metric": "predict_markers_per_s",
        "value": round(MT * TRAITS / best, 1),
        "unit": "marker-traits/s (N=10k, Mt=20k, 4 traits)",
        "detail": {
            "predict_s": round(best, 3),
            "mlma_lines_per_trait": n_lines,
            "train_records": TRAIN_ITERS // THIN,
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
