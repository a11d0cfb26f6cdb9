"""Large-configuration benchmark driver (BASELINE.json configs 4-5).

Simulates (and caches under .smoke/) an N x M dataset, runs the production Gibbs
step on the default device, and prints one JSON line:

  {"n": ..., "m": ..., "traits": ..., "iter_ms": ..., "markers_per_s": ...,
   "hbm_bytes": ...}

Usage:
  python benchmarking/bench_scale.py --n 10000 --m 100000 [--traits 4]
      [--block 128] [--wave 16] [--burn 30] [--meas 10]

Results are recorded in benchmarking/SCALE.md together with the UKB-scale
(400k x 1M) memory plan.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

import numpy as np


def dataset(n, m, traits):
    from gmrm_tpu.io.sim import simulate
    tmp = os.path.join(REPO, ".smoke", f"scale_{n}x{m}_{traits}")
    if not os.path.exists(os.path.join(tmp, "test.bed")):
        t0 = time.perf_counter()
        simulate(tmp, n=n, m=m, n_traits=traits, n_causal=max(1, m // 4),
                 h2=0.5, n_groups=1, na_rate=0.0, seed=171014,
                 mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))
        print(f"# simulated {n}x{m} in {time.perf_counter()-t0:.0f}s",
              file=sys.stderr, flush=True)
    return tmp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--m", type=int, required=True)
    ap.add_argument("--traits", type=int, default=4)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--wave", type=int, default=32)
    ap.add_argument("--burn", type=int, default=30)
    ap.add_argument("--meas", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cache-dir", default="",
                    help="persist/warm-load stats + Gram (startup "
                         "column measurements)")
    args = ap.parse_args()

    from gmrm_tpu import compile_cache
    compile_cache.enable()
    import jax
    import jax.numpy as jnp
    from gmrm_tpu.config import Options
    from gmrm_tpu.runner import load_data, build_static, init_sampler_state
    from gmrm_tpu.sampler.gibbs import make_gibbs_step

    data_dir = dataset(args.n, args.m, args.traits)
    opt = Options(
        bed_file=f"{data_dir}/test.bed", dim_file=f"{data_dir}/test.dim",
        phen_files=[f"{data_dir}/test{i+1}.phen"
                    for i in range(args.traits)],
        group_index_file=f"{data_dir}/test.gri",
        group_mixture_file=f"{data_dir}/test.grm",
        iterations=1, seed=42, block_size=args.block, wave_size=args.wave,
        output_thin_rate=10 ** 9, cache_dir=args.cache_dir,
    )
    opt.validate()
    opt.load_group_mixtures()

    warm_cache = bool(args.cache_dir and os.path.isdir(args.cache_dir)
                      and any(f.startswith("startup_")
                              for f in os.listdir(args.cache_dir)))
    t0 = time.perf_counter()
    data = load_data(opt, interleave=args.wave > 1)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    static = build_static(data, opt, jnp.float32, verbose=True)
    jax.block_until_ready(static.msig)
    t_static = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = init_sampler_state(data, opt, jnp.float32)
    load_s = t_load + t_static + (time.perf_counter() - t0)
    shared_na = all(ph.nas == 0 for ph in data.phens)
    step = make_gibbs_step(block_size=args.block, donate=True,
                           shared_na=shared_na, wave_size=args.wave)

    it = 1
    t0 = time.perf_counter()
    state, _ = step(state, static, jnp.asarray(it, jnp.int32))
    jax.block_until_ready(state.sigmae)
    t_compile = time.perf_counter() - t0       # first step incl. compile
    it += 1
    t0 = time.perf_counter()
    for _ in range(args.burn - 1):
        state, _ = step(state, static, jnp.asarray(it, jnp.int32))
        it += 1
    jax.block_until_ready(state.sigmae)
    burn_s = time.perf_counter() - t0 + t_compile

    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        for _ in range(args.meas):
            state, _ = step(state, static, jnp.asarray(it, jnp.int32))
            it += 1
        jax.block_until_ready(state.sigmae)
        best = min(best, (time.perf_counter() - t0) / args.meas)

    try:
        ms = jax.local_devices()[0].memory_stats()
        hbm = ms.get("bytes_in_use", None)
    except Exception:
        hbm = None
    out = {
        "n": args.n, "m": args.m, "traits": args.traits,
        "block": args.block, "wave": args.wave,
        "iter_ms": round(best * 1000, 2),
        "markers_per_s": round(args.m / best, 1),
        "load_s": round(load_s, 1),
        "load_data_s": round(t_load, 1),
        "build_static_s": round(t_static, 1),
        "first_step_s": round(t_compile, 1),
        "warm_cache": warm_cache,
        "burn_s_per_iter": round(burn_s / max(args.burn, 1), 3),
        "hbm_bytes_in_use": hbm,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
