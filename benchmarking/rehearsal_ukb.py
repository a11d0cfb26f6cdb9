"""UKB-shaped multi-process rehearsal on the CPU mesh.

Full production pipeline at N gloo processes x 1 virtual device each —
the process topology of a real pod slice (reference per-rank slices,
``bayes.cpp:867-925``) — against a 1-process x N-device control:

1. sharded load (each process reads only its .bed row slice);
2. training with a mid-chain checkpoint, run PAST the checkpoint (the
   "crash" leaves stale thinned rows on disk);
3. resume: stale rows truncated, chain continued to the end;
4. sharded predict (per-process .bet/.bed slice reads, positioned
   .mlma writes).

Both topologies span the same 8-device global mesh, so draws are
identical; the only difference is collective summation order (gloo ring
vs in-process XLA).  Gates:

A. crash+resume artifacts BYTE-identical to an uninterrupted run of the
   SAME topology (deterministic collectives -> exact; proves resume +
   stale-row truncation at scale);
B. FIRST thinned record within collective float noise across
   topologies (later records diverge chaotically once a single
   component decision flips — a property of MCMC trajectories, not a
   bug; reported informationally, gated distributionally by
   equivalence_ref.py instead);
C. .mlma byte-identical across topologies (per-marker stats, no
   cross-marker collectives in the 1-rank semantics).

Appends a row to benchmarking/SCALE.md.  Exit 1 on failure.

Usage:
  python benchmarking/rehearsal_ukb.py [--n 20000 --m 32768 --traits 2]
      [--procs 8] [--iters 10] [--no-report]
  (also invoked with --worker ... by its own subprocesses)
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
WORK = os.path.join(REPO, ".smoke")


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_main(args):
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={args.local_devices}"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    from gmrm_tpu import compile_cache
    compile_cache.enable()
    jax.config.update("jax_platforms", "cpu")
    if args.nprocs > 1:
        from gmrm_tpu.parallel.distributed import init_distributed
        init_distributed(coordinator_address=f"localhost:{args.port}",
                         num_processes=args.nprocs, process_id=args.pid)
    from gmrm_tpu.config import Options

    d = args.data
    phens = [f"{d}/test{i + 1}.phen" for i in range(args.traits)]
    if args.mode == "predict":
        from gmrm_tpu.predict import run_predict
        opt = Options(bed_file=f"{d}/test.bed", dim_file=f"{d}/test.dim",
                      phen_files=phens, bim_file=f"{d}/test.bim",
                      ref_bim_file=f"{d}/test.bim", out_dir=args.out,
                      predict=True)
        run_predict(opt, verbose=False)
    else:
        from gmrm_tpu.parallel.runner import run_training_sharded
        opt = Options(
            bed_file=f"{d}/test.bed", dim_file=f"{d}/test.dim",
            phen_files=phens, group_index_file=f"{d}/test.gri",
            group_mixture_file=f"{d}/test.grm",
            iterations=args.iters, seed=42, out_dir=args.out,
            block_size=128, output_thin_rate=2,
            checkpoint_every=args.ckpt_every, resume=args.mode == "resume",
        )
        res = run_training_sharded(opt, verbose=False)
        if args.pid == 0:
            print(f"# worker chain {res.chain_seconds:.1f}s for "
                  f"{res.iters_run} iters", flush=True)


def spawn(nprocs, local_devices, mode, data, out, traits, iters,
          ckpt_every, timeout_s):
    port = free_port()
    procs = []
    for pid in range(nprocs):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--pid", str(pid), "--nprocs", str(nprocs),
               "--local-devices", str(local_devices), "--port", str(port),
               "--mode", mode, "--data", data, "--out", out,
               "--traits", str(traits), "--iters", str(iters),
               "--ckpt-every", str(ckpt_every)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{o[-4000:]}")
    return outs[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--nprocs", type=int, default=1)
    ap.add_argument("--local-devices", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--mode", default="train")
    ap.add_argument("--data", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=0)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--m", type=int, default=32768)
    ap.add_argument("--traits", type=int, default=2)
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--timeout", type=int, default=14400)
    ap.add_argument("--no-report", action="store_true")
    args = ap.parse_args()
    if args.worker:
        worker_main(args)
        return

    import numpy as np
    n, m, traits, procs = args.n, args.m, args.traits, args.procs
    data = f"{WORK}/rehearse_{n}x{m}_{traits}"
    if not os.path.exists(os.path.join(data, "test.bed")):
        from gmrm_tpu.io.sim import simulate
        t0 = time.time()
        simulate(data, n=n, m=m, n_traits=traits, n_causal=m // 8, h2=0.5,
                 n_groups=2, na_rate=0.01, seed=20260821,
                 mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))
        print(f"# simulated in {time.time()-t0:.0f}s", flush=True)

    out_sp = f"{WORK}/rehearse_sp_{n}x{m}"
    out_mp = f"{WORK}/rehearse_mp_{n}x{m}"
    out_mf = f"{WORK}/rehearse_mf_{n}x{m}"
    for o in (out_sp, out_mp, out_mf):
        subprocess.run(["rm", "-rf", o], check=True)

    half = (args.iters // 2) // 2 * 2 or 2       # even: a thin boundary

    # Control 1: 1 process x `procs` devices, uninterrupted + predict.
    t0 = time.time()
    spawn(1, procs, "train", data, out_sp, traits, args.iters, 0,
          args.timeout)
    t_sp = time.time() - t0
    spawn(1, procs, "predict", data, out_sp, traits, 0, 0, args.timeout)
    print(f"# 1x{procs} control done {t_sp:.0f}s", flush=True)

    # Control 2: procs x 1 device, UNINTERRUPTED (gate A oracle).
    t0 = time.time()
    spawn(procs, 1, "train", data, out_mf, traits, args.iters, 0,
          args.timeout)
    t_mf = time.time() - t0
    print(f"# {procs}x1 uninterrupted done {t_mf:.0f}s", flush=True)

    # Rehearsal: procs x 1 device.  Phase A runs PAST the mid-chain
    # checkpoint ("crash" with stale rows), phase B resumes, then
    # sharded predict.
    t0 = time.time()
    spawn(procs, 1, "train", data, out_mp, traits, half + 2, half,
          args.timeout)
    t_a = time.time() - t0
    t0 = time.time()
    spawn(procs, 1, "resume", data, out_mp, traits, args.iters, half,
          args.timeout)
    t_b = time.time() - t0
    t0 = time.time()
    spawn(procs, 1, "predict", data, out_mp, traits, 0, 0, args.timeout)
    t_p = time.time() - t0
    print(f"# {procs}x1 rehearsal done: phaseA {t_a:.0f}s resume "
          f"{t_b:.0f}s predict {t_p:.0f}s", flush=True)

    # ---- compare ----
    from gmrm_tpu.io.writers import read_history
    ok = True
    rows = []
    for t in range(1, traits + 1):
        # Gate A: resume == uninterrupted, same topology, exact bytes.
        resume_ident = all(
            open(f"{out_mf}/test{t}{suf}", "rb").read()
            == open(f"{out_mp}/test{t}{suf}", "rb").read()
            for suf in (".bet", ".cpn", ".csv"))
        # Gate B: first thinned record across topologies.
        _, bet_sp = read_history(f"{out_sp}/test{t}.bet", "f8")
        _, bet_mp = read_history(f"{out_mp}/test{t}.bet", "f8")
        d0 = float(np.max(np.abs(bet_sp[0] - bet_mp[0])))
        dall = float(np.max(np.abs(bet_sp - bet_mp)))
        _, cpn_sp = read_history(f"{out_sp}/test{t}.cpn", "i4")
        _, cpn_mp = read_history(f"{out_mp}/test{t}.cpn", "i4")
        flip0 = float((cpn_sp[0] != cpn_mp[0]).mean())
        # Gate C: predict bytes across topologies.
        mlma_eq = (open(f"{out_sp}/test{t}.mlma", "rb").read()
                   == open(f"{out_mp}/test{t}.mlma", "rb").read())
        pass_t = resume_ident and d0 < 1e-4 and flip0 < 0.005 and mlma_eq
        ok = ok and pass_t
        rows.append((t, bet_sp.shape[0], resume_ident, d0, flip0, dall,
                     mlma_eq, pass_t))
        print(f"# trait {t}: records={bet_sp.shape[0]} "
              f"resume_bytes={'identical' if resume_ident else 'DIFFER'} "
              f"rec0 max|dbeta|={d0:.2e} rec0 flips={flip0:.4%} "
              f"chain max|dbeta|={dall:.2e} (informational) "
              f"mlma_identical={mlma_eq} -> "
              f"{'PASS' if pass_t else 'FAIL'}", flush=True)

    summary = {
        "n": n, "m": m, "traits": traits, "procs": procs,
        "iters": args.iters, "t_control_s": round(t_sp, 1),
        "t_mp_full_s": round(t_mf, 1),
        "t_phaseA_s": round(t_a, 1), "t_resume_s": round(t_b, 1),
        "t_predict_s": round(t_p, 1), "pass": ok,
    }
    print(json.dumps(summary))
    if not args.no_report:
        with open(os.path.join(HERE, "SCALE.md"), "a") as fh:
            fh.write(
                f"\n## {procs}-process UKB-shaped rehearsal "
                f"(CPU mesh, round 5)\n\n"
                f"`rehearsal_ukb.py`: N={n:,} x Mt={m:,} x {traits} "
                f"traits, {procs} gloo processes x 1 device; full "
                f"pipeline = sharded load -> train with mid-chain "
                f"checkpoint -> crash past it (stale rows) -> resume -> "
                f"sharded predict.  Gate A: resume byte-identical to an "
                f"uninterrupted same-topology run; gate B: first record "
                f"vs 1x{procs} within collective noise (later records "
                f"diverge chaotically by design); gate C: .mlma bytes "
                f"across topologies.\n\n"
                f"| trait | records | resume bytes | rec0 beta diff | "
                f"rec0 flips | chain beta diff (info) | .mlma | result "
                f"|\n|---|---|---|---|---|---|---|---|\n" +
                "".join(
                    f"| {t} | {r} | "
                    f"{'identical' if ri else 'DIFFER'} | {d0:.2e} | "
                    f"{fl:.4%} | {da:.2e} | "
                    f"{'identical' if mq else 'DIFFER'} | "
                    f"{'PASS' if p else 'FAIL'} |\n"
                    for t, r, ri, d0, fl, da, mq, p in rows) +
                f"\nWall: 1x{procs} control {t_sp:.0f}s; {procs}x1 "
                f"uninterrupted {t_mf:.0f}s; rehearsal phases "
                f"{t_a:.0f}+{t_b:.0f}+{t_p:.0f}s on 2 host cores "
                f"({procs}x oversubscribed — protocol evidence, not "
                f"throughput).  **{'PASS' if ok else 'FAIL'}**\n")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
