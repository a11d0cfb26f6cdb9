"""Multi-process scaling measurement on the virtual CPU mesh.

Fixed global problem, two process layouts of the SAME 8-device mesh:

  1 process x 8 devices   (in-process XLA collectives)
  2 processes x 4 devices (cross-process gloo ring — the DCN stand-in)

Each layout runs the sharded trainer twice (first run pays jit compile,
second is timed) and reports steady-state seconds/iteration plus TWO
sync measurements: the collective-chain estimate (parallel/runner.py
estimate_sync_seconds; upper bound, zero compute overlap) and the
in-step differential (measure_sync_seconds via a verbosity-2 run: real
step vs a no-collectives compile — the true in-loop split), against
the psum volume model from SCALE.md: per iteration
`nblocks_shard x T x 4 x mb_pad x 4` bytes through the allreduce.

These numbers are CPU-RELATIVE (virtual devices share 2 cores; gloo runs
over loopback): they evidence the protocol's scaling shape — sync share
and the cross-process overhead — not device throughput.  Recorded
in SCALE.md.

Usage: python benchmarking/bench_multiprocess.py [--iters 12]
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
WORK = os.path.join(REPO, ".smoke")

N, M, TRAITS = 2000, 4096, 2
BLOCK = 64


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


WORKER = r"""
import json, os, sys, time
pid, nprocs, port, data_dir, iters = (int(sys.argv[1]), int(sys.argv[2]),
                                      int(sys.argv[3]), sys.argv[4],
                                      int(sys.argv[5]))
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=%%d"
                           %% (8 // nprocs))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, %(repo)r)
from gmrm_tpu import compile_cache
compile_cache.enable()
if nprocs > 1:
    from gmrm_tpu.parallel.distributed import init_distributed
    init_distributed(coordinator_address="localhost:%%d" %% port,
                     num_processes=nprocs, process_id=pid)
from gmrm_tpu.config import Options
from gmrm_tpu.parallel.runner import (
    run_training_sharded, estimate_sync_seconds,
)
from gmrm_tpu.parallel.mesh import make_marker_mesh
phens = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
               if f.endswith(".phen"))

def opts(iters, verbosity=0):
    return Options(
        bed_file=data_dir + "/test.bed", dim_file=data_dir + "/test.dim",
        phen_files=phens, group_index_file=data_dir + "/test.gri",
        group_mixture_file=data_dir + "/test.grm",
        iterations=iters, seed=42, block_size=%(block)d,
        output_thin_rate=10 ** 9, verbosity=verbosity)

run_training_sharded(opts(2), verbose=False)       # compile
res = run_training_sharded(opts(iters), verbose=False)
# In-step differential sync split: a verbosity-2 run compiles the
# no-collectives twin and prints the with/elided times; parse them.
import contextlib, io, re
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    run_training_sharded(opts(3, verbosity=2), verbose=True)
mt = re.search(r"in-step sync cost = ([0-9.]+) ms/iteration "
               r"\(([0-9.]+) with collectives, ([0-9.]+) elided",
               buf.getvalue())
instep = {k: float(mt.group(i)) / 1000 for i, k in
          ((1, "sync_instep_s"), (2, "instep_with_s"),
           (3, "instep_without_s"))} if mt else {}
import jax.numpy as jnp
mesh = make_marker_mesh(0)
mm = -(-%(m)d // 8)                       # max markers per shard
mps = -(-mm // %(block)d) * %(block)d     # padded shard length
mb_pad = -(-((%(n)d + 3) // 4) // 512) * 512
sync_s = estimate_sync_seconds(mesh, mps // %(block)d, %(traits)d, mb_pad,
                               1, 4, jnp.float32, timing_iters=5)
if pid == 0:
    print("RESULT " + json.dumps({
        "nprocs": nprocs, "iter_s": res.chain_seconds / res.iters_run,
        "sync_s": sync_s, **instep,
        "psum_bytes_per_iter": (mps // %(block)d) * %(traits)d * 4
                                * mb_pad * 4,
    }), flush=True)
""" % {"repo": REPO, "block": BLOCK, "m": M, "n": N, "traits": TRAITS}


def run_layout(nprocs, data_dir, iters):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), str(nprocs),
             str(port), data_dir, str(iters)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nprocs)
    ]
    result = None
    for p in procs:
        out, _ = p.communicate(timeout=3600)
        if p.returncode != 0:
            raise RuntimeError(out[-3000:])
        for line in out.splitlines():
            if line.startswith("RESULT "):
                result = json.loads(line[len("RESULT "):])
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=12)
    args = ap.parse_args()

    tmp = f"{WORK}/mp_{N}x{M}_{TRAITS}"
    if not os.path.exists(os.path.join(tmp, "test.bed")):
        code = (
            "import sys; sys.path.insert(0, %r); "
            "from gmrm_tpu.io.sim import simulate; import numpy as np; "
            "simulate(%r, n=%d, m=%d, n_traits=%d, n_causal=%d, h2=0.5, "
            "n_groups=1, na_rate=0.0, seed=7, "
            "mixtures=np.array([0.0, 0.001, 0.01, 0.1]))"
            % (REPO, tmp, N, M, TRAITS, M // 8)
        )
        subprocess.run([sys.executable, "-c", code], check=True,
                       timeout=600)

    t0 = time.perf_counter()
    r1 = run_layout(1, tmp, args.iters)
    print(f"# 1x8 done ({time.perf_counter()-t0:.0f}s)", file=sys.stderr,
          flush=True)
    r2 = run_layout(2, tmp, args.iters)
    print(f"# 2x4 done ({time.perf_counter()-t0:.0f}s)", file=sys.stderr,
          flush=True)
    out = {
        "metric": "sharded_iter_s_cpu_mesh",
        "problem": {"n": N, "m": M, "traits": TRAITS, "block": BLOCK},
        "layouts": {"1x8": r1, "2x4": r2},
        "cross_process_overhead":
            round(r2["iter_s"] / r1["iter_s"], 2) if r1 and r2 else None,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
