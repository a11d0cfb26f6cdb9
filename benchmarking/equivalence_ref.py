"""MCMC-equivalence check: gmrm_tpu chains vs the COMPILED reference gmrm.

Runs the unmodified reference binary (built by baseline/Makefile) and our
sampler on the SAME simulated dataset, then compares the scientific
observables — posterior means/sds of sigmaG, sigmaE, h2 from the .csv
chains (reference src/xfiles.cpp:17-43) and posterior-mean betas from the
.bet history (src/xfiles.hpp:13-38).  Bitwise equality is impossible
across RNGs (SURVEY.md §7); the equivalence target is distributional:
both samplers draw from the same posterior, so long-chain summaries must
agree within Monte-Carlo error, and both beta means must correlate highly
with each other and with the simulated truth.

Writes benchmarking/EQUIVALENCE.md.  Exit code 1 on failure.

Usage: python benchmarking/equivalence_ref.py [--quick]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
WORK = os.path.join(REPO, ".smoke")

from gmrm_tpu.io.writers import read_history  # noqa: E402


def parse_csv_chain(path: str, n_groups: int):
    """-> dict of arrays: iter, sigmag (R, G), sigmae (R,), h2 (R,)."""
    rows = []
    with open(path) as fh:
        for line in fh:
            parts = [p.strip() for p in line.strip().split(",") if p.strip()]
            if not parts:
                continue
            it = int(parts[0])
            g = int(parts[1])
            assert g == n_groups, (g, n_groups)
            sg = [float(x) for x in parts[2:2 + g]]
            se = float(parts[2 + g])
            h2 = float(parts[3 + g])
            rows.append((it, sg, se, h2))
    its = np.array([r[0] for r in rows])
    sg = np.array([r[1] for r in rows])
    se = np.array([r[2] for r in rows])
    h2 = np.array([r[3] for r in rows])
    return {"iter": its, "sigmag": sg, "sigmae": se, "h2": h2}


def run_reference(binary, data, out_dir, iterations, thin, seed, n_traits):
    subprocess.run(["rm", "-rf", out_dir], check=True)
    phens = ",".join(f"{data}/test{i + 1}.phen" for i in range(n_traits))
    cmd = [
        binary,
        "--bed-file", f"{data}/test.bed", "--dim-file", f"{data}/test.dim",
        "--phen-files", phens,
        "--group-index-file", f"{data}/test.gri",
        "--group-mixture-file", f"{data}/test.grm",
        "--iterations", str(iterations), "--seed", str(seed),
        "--shuffle-markers", "1", "--out-dir", out_dir,
        "--output-thin-rate", str(thin),
    ]
    env = dict(os.environ, OMP_NUM_THREADS=str(os.cpu_count()))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=3600)
    if proc.returncode != 0:
        raise RuntimeError(f"reference failed:\n{proc.stdout[-3000:]}")
    return time.perf_counter() - t0


def run_ours(opt_kwargs, out_dir):
    from gmrm_tpu.config import Options
    from gmrm_tpu.runner import run_training
    subprocess.run(["rm", "-rf", out_dir], check=True)
    opt = Options(out_dir=out_dir, **opt_kwargs)
    t0 = time.perf_counter()
    res = run_training(opt, verbose=False)
    return res, time.perf_counter() - t0


def summarize(tag, chain, burn_frac=0.4):
    n = len(chain["iter"])
    b = int(n * burn_frac)
    return {
        "tag": tag,
        "h2_mean": float(chain["h2"][b:].mean()),
        "h2_sd": float(chain["h2"][b:].std()),
        "sigmae_mean": float(chain["sigmae"][b:].mean()),
        "sigmag_mean": chain["sigmag"][b:].mean(axis=0),
        "records": n,
    }


def run_seed_pair(sim, data, binary, iterations, thin, n_traits, n_groups,
                  burn, ref_seed, our_seed, wave, tag):
    """One (reference, ours) chain pair -> list of per-trait summaries."""
    ref_out = f"{WORK}/equiv_ref_{tag}"
    t_ref = run_reference(binary, data, ref_out, iterations, thin,
                          seed=ref_seed, n_traits=n_traits)
    ours_out = f"{WORK}/equiv_ours_{tag}"
    _, t_ours = run_ours(
        dict(
            bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
            group_index_file=sim.gri, group_mixture_file=sim.grm,
            iterations=iterations, seed=our_seed, output_thin_rate=thin,
            block_size=128, wave_size=wave,
        ),
        ours_out,
    )
    rows = []
    for t in range(n_traits):
        ref_chain = parse_csv_chain(f"{ref_out}/test{t + 1}.csv", n_groups)
        our_chain = parse_csv_chain(f"{ours_out}/test{t + 1}.csv", n_groups)
        rs = summarize("ref", ref_chain, burn)
        os_ = summarize("ours", our_chain, burn)
        _, ref_bet = read_history(f"{ref_out}/test{t + 1}.bet", "f8")
        _, our_bet = read_history(f"{ours_out}/test{t + 1}.bet", "f8")
        nb = ref_bet.shape[0]
        bref = ref_bet[int(nb * burn):].mean(axis=0)
        bours = our_bet[int(our_bet.shape[0] * burn):].mean(axis=0)
        rows.append({
            "trait": t, "ref": rs, "ours": os_,
            "corr_x": float(np.corrcoef(bref, bours)[0, 1]),
            "corr_ref_truth":
                float(np.corrcoef(bref, sim.beta_true[:, t])[0, 1]),
            "corr_ours_truth":
                float(np.corrcoef(bours, sim.beta_true[:, t])[0, 1]),
            "t_ref": t_ref, "t_ours": t_ours,
        })
    return rows


def multiseed(args):
    """>= 3 seeds at the production cadence (B=128, W=16) plus one W=1
    control; pooled-vs-pooled h2 with tolerances from the across-seed
    spread (per-seed MC error bars), not a fixed 0.03."""
    iterations = 400 if args.quick else (args.iters or 800)
    thin = 2
    n, m = args.n, args.m
    n_traits, n_groups, burn = args.traits, 2, 0.4

    from gmrm_tpu.io.sim import simulate
    data = f"{WORK}/equiv_data_{n}x{m}_{n_traits}" \
        if (n, m, n_traits) != (2000, 2000, 2) else f"{WORK}/equiv_data"
    sim = simulate(data, n=n, m=m, n_traits=n_traits, n_causal=m // 4,
                   h2=0.5, n_groups=n_groups, na_rate=0.01, seed=20260819,
                   mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))
    binary = os.path.join(REPO, "baseline", "build", "gmrm_ref")
    if not os.path.exists(binary):
        subprocess.run(["make", "-C", os.path.join(REPO, "baseline")],
                       check=True, capture_output=True)

    S = args.seeds
    prod_wave = args.wave if args.wave > 1 else 16
    per_seed = []        # [seed][trait] summaries, production wave
    for i in range(S):
        per_seed.append(run_seed_pair(
            sim, data, binary, iterations, thin, n_traits, n_groups, burn,
            ref_seed=171014 + 1000 * i, our_seed=42 + i, wave=prod_wave,
            tag=f"s{i}"))
        print(f"# seed pair {i} done", flush=True)
    control = run_seed_pair(
        sim, data, binary, iterations, thin, n_traits, n_groups, burn,
        ref_seed=999171014, our_seed=4242, wave=1, tag="w1")
    print("# W=1 control done", flush=True)

    lines = [
        ("## Anchor-scale (multi-seed)" if args.append else
         "# MCMC equivalence: gmrm_tpu vs compiled reference gmrm "
         "(multi-seed)"),
        "",
        f"Dataset: N={n} x M={m}, {n_traits} traits, {n_groups} groups, "
        f"1% phenotype NAs, h2=0.5 (realized "
        f"{np.round(sim.h2_realized, 3).tolist()}).",
        f"{S} independent seed pairs at the PRODUCTION cadence (block 128, "
        f"wave {prod_wave}, cached-Gram wave sweep) of {iterations} "
        f"iterations, thin {thin}, burn-in {int(burn*100)}%, plus one "
        f"exact-serial W=1 control pair.  Tolerance: |pooled h2 diff| <= "
        f"3 x hypot(SEM_ref, SEM_ours) over seeds (floor 0.015), the "
        f"per-seed Monte-Carlo-error criterion.",
        "",
        "| trait | seed | impl | h2 mean | h2 sd | sigmaE mean | beta corr"
        " (x-impl) |",
        "|---|---|---|---|---|---|---|",
    ]
    ok = True
    for t in range(n_traits):
        h2r = np.array([per_seed[i][t]["ref"]["h2_mean"] for i in range(S)])
        h2o = np.array([per_seed[i][t]["ours"]["h2_mean"] for i in range(S)])
        for i in range(S):
            r, o = per_seed[i][t]["ref"], per_seed[i][t]["ours"]
            lines.append(
                f"| {t} | {i} | reference | {r['h2_mean']:.4f} | "
                f"{r['h2_sd']:.4f} | {r['sigmae_mean']:.4f} | "
                f"{per_seed[i][t]['corr_x']:.4f} |")
            lines.append(
                f"| {t} | {i} | gmrm_tpu | {o['h2_mean']:.4f} | "
                f"{o['h2_sd']:.4f} | {o['sigmae_mean']:.4f} |  |")
        sem_r = h2r.std(ddof=1) / np.sqrt(S)
        sem_o = h2o.std(ddof=1) / np.sqrt(S)
        tol = max(3.0 * float(np.hypot(sem_r, sem_o)), 0.015)
        diff = abs(h2r.mean() - h2o.mean())
        corr_min = min(per_seed[i][t]["corr_x"] for i in range(S))
        pass_h2 = diff <= tol
        pass_corr = corr_min >= 0.9
        ok = ok and pass_h2 and pass_corr
        lines.append(
            f"| {t} | pooled | diff {diff:.4f} <= tol {tol:.4f}: "
            f"{'PASS' if pass_h2 else 'FAIL'} | ref "
            f"{h2r.mean():.4f}±{sem_r:.4f} | ours "
            f"{h2o.mean():.4f}±{sem_o:.4f} | min corr {corr_min:.4f} >= "
            f"0.9: {'PASS' if pass_corr else 'FAIL'} | |")
        c = control[t]
        cd = abs(c["ref"]["h2_mean"] - c["ours"]["h2_mean"])
        ctol = max(3.0 * np.hypot(c["ref"]["h2_sd"], c["ours"]["h2_sd"])
                   / np.sqrt(c["ref"]["records"] * (1 - burn)), 0.03)
        pass_c = cd <= ctol and c["corr_x"] >= 0.9
        ok = ok and pass_c
        lines.append(
            f"| {t} | W=1 ctl | diff {cd:.4f} <= {ctol:.4f} & corr "
            f"{c['corr_x']:.4f}: {'PASS' if pass_c else 'FAIL'} | "
            f"{c['ref']['h2_mean']:.4f} | {c['ours']['h2_mean']:.4f} | | |")

    lines += ["", f"**Overall: {'PASS' if ok else 'FAIL'}**", ""]
    report = "\n".join(lines)
    mode = "a" if args.append else "w"
    with open(os.path.join(HERE, "EQUIVALENCE.md"), mode) as fh:
        if args.append:
            fh.write("\n")
        fh.write(report)
    print(report)
    sys.exit(0 if ok else 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller chain (CI-scale)")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--m", type=int, default=2000)
    ap.add_argument("--wave", type=int, default=1,
                    help="wave_size for our sampler (validates the wave "
                         "relaxation against the reference chains)")
    ap.add_argument("--seeds", type=int, default=0,
                    help=">= 1: multi-seed production-cadence mode "
                         "(writes the multi-seed EQUIVALENCE.md)")
    ap.add_argument("--traits", type=int, default=2)
    ap.add_argument("--iters", type=int, default=0,
                    help="override chain length (multi-seed mode)")
    ap.add_argument("--append", action="store_true",
                    help="append a section to EQUIVALENCE.md instead of "
                         "overwriting (anchor-scale runs)")
    args = ap.parse_args()
    if args.seeds:
        multiseed(args)
        return

    iterations = 400 if args.quick else 1200
    thin = 2 if args.quick else 4
    n, m = args.n, args.m
    n_traits = 2
    n_groups = 2
    burn = 0.4

    from gmrm_tpu.io.sim import simulate
    data = f"{WORK}/equiv_data"
    sim = simulate(data, n=n, m=m, n_traits=n_traits, n_causal=m // 4,
                   h2=0.5, n_groups=n_groups, na_rate=0.01, seed=20260819,
                   mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))

    binary = os.path.join(REPO, "baseline", "build", "gmrm_ref")
    if not os.path.exists(binary):
        subprocess.run(["make", "-C", os.path.join(REPO, "baseline")],
                       check=True, capture_output=True)

    ref_out = f"{WORK}/equiv_ref"
    t_ref = run_reference(binary, data, ref_out, iterations, thin,
                          seed=171014, n_traits=n_traits)

    ours_out = f"{WORK}/equiv_ours"
    _, t_ours = run_ours(
        dict(
            bed_file=sim.bed, dim_file=sim.dim, phen_files=sim.phens,
            group_index_file=sim.gri, group_mixture_file=sim.grm,
            iterations=iterations, seed=42, output_thin_rate=thin,
            block_size=128, wave_size=args.wave,
        ),
        ours_out,
    )

    lines = [
        "# MCMC equivalence: gmrm_tpu vs compiled reference gmrm",
        "",
        f"Dataset: N={n} x M={m}, {n_traits} traits, {n_groups} groups, "
        f"1% phenotype NAs, h2=0.5 (realized "
        f"{np.round(sim.h2_realized, 3).tolist()}).",
        f"Chains: {iterations} iterations, thin {thin}, burn-in "
        f"{int(burn * 100)}%.  Reference seed 171014 (boost mt19937), ours "
        f"seed 42 (threefry) — bitwise RNG equality impossible, the target "
        f"is distributional agreement (SURVEY.md §7).  wave_size="
        f"{args.wave}.",
        "",
        f"Wall-clock: reference {t_ref:.1f}s "
        f"({os.cpu_count()} OMP threads), ours {t_ours:.1f}s "
        f"(single device).",
        "",
        "| trait | impl | h2 mean | h2 sd | sigmaE mean | beta corr "
        "(x-impl) | beta corr (truth) |",
        "|---|---|---|---|---|---|---|",
    ]
    ok = True
    for t in range(n_traits):
        ref_chain = parse_csv_chain(f"{ref_out}/test{t + 1}.csv", n_groups)
        our_chain = parse_csv_chain(f"{ours_out}/test{t + 1}.csv", n_groups)
        rs = summarize("ref", ref_chain, burn)
        os_ = summarize("ours", our_chain, burn)

        _, ref_bet = read_history(f"{ref_out}/test{t + 1}.bet", "f8")
        _, our_bet = read_history(f"{ours_out}/test{t + 1}.bet", "f8")
        nb = ref_bet.shape[0]
        bref = ref_bet[int(nb * burn):].mean(axis=0)
        bours = our_bet[int(our_bet.shape[0] * burn):].mean(axis=0)
        corr_x = float(np.corrcoef(bref, bours)[0, 1])
        corr_ref_truth = float(np.corrcoef(bref, sim.beta_true[:, t])[0, 1])
        corr_ours_truth = float(np.corrcoef(bours, sim.beta_true[:, t])[0, 1])

        # Tolerances: h2 posterior mean within max(3 x combined MC sd, 0.03);
        # cross-implementation posterior-beta correlation >= 0.9.
        tol = max(3.0 * np.hypot(rs["h2_sd"], os_["h2_sd"])
                  / np.sqrt(rs["records"] * (1 - burn)), 0.03)
        pass_h2 = abs(rs["h2_mean"] - os_["h2_mean"]) <= tol
        pass_corr = corr_x >= 0.9
        ok = ok and pass_h2 and pass_corr

        lines.append(
            f"| {t} | reference | {rs['h2_mean']:.4f} | {rs['h2_sd']:.4f} | "
            f"{rs['sigmae_mean']:.4f} | {corr_x:.4f} | {corr_ref_truth:.4f} |")
        lines.append(
            f"| {t} | gmrm_tpu | {os_['h2_mean']:.4f} | {os_['h2_sd']:.4f} | "
            f"{os_['sigmae_mean']:.4f} |  | {corr_ours_truth:.4f} |")
        lines.append(
            f"| {t} | delta/tol |  h2 diff "
            f"{abs(rs['h2_mean'] - os_['h2_mean']):.4f} <= {tol:.4f}: "
            f"{'PASS' if pass_h2 else 'FAIL'} | | | corr >= 0.9: "
            f"{'PASS' if pass_corr else 'FAIL'} | |")

    lines += ["", f"**Overall: {'PASS' if ok else 'FAIL'}**", ""]
    report = "\n".join(lines)
    out_path = os.path.join(HERE, "EQUIVALENCE.md")
    # Never clobber previously recorded sections: append when the file
    # already exists (it accumulates multi-seed / anchor / predict-parity
    # results); a fresh file gets the full header.
    mode = "a" if os.path.exists(out_path) else "w"
    with open(out_path, mode) as fh:
        if mode == "a":
            fh.write("\n## Single-pair run\n\n")
        fh.write(report)
    print(report)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
