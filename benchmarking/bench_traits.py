#!/usr/bin/env python
"""Trait-count scaling sweep (the reference's benchmarking/bench_ardyh.sh
varied 1-5 phenotypes on 2 ranks x 18 threads; here the trait axis is a
batch dimension of every block operation).

Timing protocol: batches of back-to-back iterations bracketed by
block_until_ready (run_training's per-iteration wall times are dispatch
times, not compute).

Usage: python benchmarking/bench_traits.py [N] [M]
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def main(n=10_000, m=20_000, burn=40, meas=10, repeats=3):
    from gmrm_tpu import compile_cache
    compile_cache.enable()
    import jax
    import jax.numpy as jnp
    from gmrm_tpu.io.sim import simulate
    from gmrm_tpu.config import Options
    from gmrm_tpu.runner import load_data, build_static, init_sampler_state
    from gmrm_tpu.sampler.gibbs import make_gibbs_step

    tmax = 32
    out = os.path.join(REPO, ".smoke", f"bench_traits{tmax}")
    if not os.path.exists(os.path.join(out, "test.bed")):
        simulate(out, n=n, m=m, n_traits=tmax, n_causal=m // 4, h2=0.5,
                 n_groups=1, na_rate=0.0, seed=171014,
                 mixtures=np.array([0.0, 0.0001, 0.001, 0.01]))
    # 1-5 mirror the reference sweep (bench_ardyh.sh); 8/16/32 probe
    # where the per-trait Gram and the trait batch stop being free.
    for t in (1, 2, 3, 4, 5, 8, 16, 32):
        opt = Options(
            bed_file=f"{out}/test.bed", dim_file=f"{out}/test.dim",
            phen_files=[f"{out}/test{i+1}.phen" for i in range(t)],
            group_index_file=f"{out}/test.gri",
            group_mixture_file=f"{out}/test.grm",
            iterations=1, seed=42, block_size=128, wave_size=32,
            output_thin_rate=10 ** 9,
        )
        opt.validate()
        opt.load_group_mixtures()
        data = load_data(opt, interleave=True)
        static = build_static(data, opt, jnp.float32)
        state = init_sampler_state(data, opt, jnp.float32)
        shared_na = all(ph.nas == 0 for ph in data.phens)
        step = make_gibbs_step(block_size=128, donate=True,
                               shared_na=shared_na, wave_size=32)
        it = 1
        for _ in range(burn):
            state, _ = step(state, static, jnp.asarray(it, jnp.int32))
            it += 1
        jax.block_until_ready(state.sigmae)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(meas):
                state, _ = step(state, static, jnp.asarray(it, jnp.int32))
                it += 1
            jax.block_until_ready(state.sigmae)
            best = min(best, (time.perf_counter() - t0) / meas)
        print(json.dumps({
            "traits": t, "iter_ms": round(best * 1000, 2),
            "markers_per_s": round(m / best, 1),
            "marker_traits_per_s": round(t * m / best, 1),
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
        }), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
