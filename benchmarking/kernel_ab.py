"""A/B of the fused decode kernels (gmrm_tpu/ops/triton_kernels.py)
against the plain XLA version they replace, on the card.

For each panel — the 10k x 20k x 4 anchor (bed 51 MB, about the H100's L2)
and 100k x 8,192 x 4 (bed 205 MB, four times L2) — it compiles the
production step twice, once with the fused kernels and once with the
plain ``blockops`` path (whatever the size rule in
``block_cdot_rows`` would pick), then times warm batches of BATCH
iterations in the order plain, fused, fused, plain, repeated ROUNDS
times, each batch closed by block_until_ready.  It also times each block
op alone on the device: every block of the panel in one ``lax.scan``
(no host dispatch per call), per block.

    python benchmarking/kernel_ab.py     # one GPU; prints one JSON line
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

PANELS = {
    "anchor_10k_x_20k": dict(n=10_000, m=20_000, n_traits=4, n_groups=2,
                             na_rate=0.01, seed=20260819),
    "n100k_x_8k": dict(n=100_000, m=8_192, n_traits=4, n_groups=2,
                       na_rate=0.01, seed=20261016),
}
BATCH, ROUNDS, REPS = 50, 3, 5


def block_ops():
    """{variant: (x^T eps op, update op)} with the sweep's signatures."""
    import jax.numpy as jnp
    from gmrm_tpu.ops import triton_kernels as tk
    from gmrm_tpu.ops.blockops import block_cdot, block_eps_update

    def cdot(bed, rows, eps, mave, axis_name=None):
        return block_cdot(jnp.take(bed, rows, axis=0), eps, mave)

    def update(bed, rows, d, na, mave, axis_name=None):
        return block_eps_update(jnp.take(bed, rows, axis=0), d, na, mave)
    return {"plain": (cdot, update),
            "fused": (tk.block_cdot_fused, tk.block_eps_update_fused)}


def us_per_block(op, kind, static, eps, blocks):
    """Device time of one block op, every block in one lax.scan."""
    import jax
    import jax.numpy as jnp
    T = eps.shape[0]
    B = blocks.shape[1]
    d = jnp.full((T, B), 1e-3, jnp.float32)

    def run(bed, na, mave, eps):
        def body(acc, rows):
            m = jnp.take(mave, rows, axis=1)
            if kind == "cdot":
                return acc + op(bed, rows, eps, m), None
            return acc + op(bed, rows, d, na, m), None
        acc0 = jnp.zeros((T, B) if kind == "cdot" else eps.shape)
        return jax.lax.scan(body, acc0, blocks)[0]

    f = jax.jit(run)
    args = (static.bed, static.na, static.mave, eps)
    jax.block_until_ready(f(*args))
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        best = min(best, time.perf_counter() - t0)
    return best / blocks.shape[0] * 1e6


def main():
    import chip_smoke as cs
    from gmrm_tpu import compile_cache
    compile_cache.enable()
    import jax
    import jax.numpy as jnp
    if jax.default_backend() != "gpu":
        print("FATAL  : no GPU", file=sys.stderr)
        return 2
    import gmrm_tpu.sampler.gibbs as gibbs
    from gmrm_tpu.runner import init_sampler_state
    from gmrm_tpu.sampler.gibbs import make_gibbs_step

    card = cs.card_line()
    print(f"# card: {card}", flush=True)
    os.makedirs(os.path.join(REPO, ".smoke"), exist_ok=True)
    root = tempfile.mkdtemp(dir=os.path.join(REPO, ".smoke"))
    variants = block_ops()
    result = {"card": card, "device_kind": jax.devices()[0].device_kind,
              "batch": BATCH, "rounds": ROUNDS}
    for name, spec in PANELS.items():
        sim = cs.simulate_dataset(root, name, spec)
        opt = cs.options(sim, block_size=128, wave_size=32)
        data, static = cs.load_static(opt)
        shared_na = all(ph.nas == 0 for ph in data.phens)
        it = jnp.asarray(1, jnp.int32)
        steps, states = {}, {}
        for how in ("fused", "plain"):
            chosen = (gibbs.block_cdot_rows, gibbs.block_eps_update_rows)
            gibbs.block_cdot_rows, gibbs.block_eps_update_rows = \
                variants[how]
            try:
                step = make_gibbs_step(block_size=128, donate=True,
                                       shared_na=shared_na, wave_size=32)
                state = init_sampler_state(data, opt, jnp.float32)
                t0 = time.perf_counter()
                steps[how] = step.lower(state, static, it).compile()
                print(f"#   {name} {how}: compile "
                      f"{time.perf_counter() - t0:.2f} s", flush=True)
            finally:
                gibbs.block_cdot_rows, gibbs.block_eps_update_rows = chosen
            for k in range(1, 4):
                state, _ = steps[how](state, static,
                                      jnp.asarray(k, jnp.int32))
            states[how] = jax.block_until_ready(state)
        times = {"fused": [], "plain": []}
        its = jnp.arange(4, 4 + BATCH, dtype=jnp.int32)
        for _ in range(ROUNDS):
            for how in ("plain", "fused", "fused", "plain"):
                state = states[how]
                t0 = time.perf_counter()
                for k in range(BATCH):
                    state, _ = steps[how](state, static, its[k])
                jax.block_until_ready(state)
                times[how].append((time.perf_counter() - t0) / BATCH * 1e3)
                states[how] = state
        B = 128
        nblocks = static.bed.shape[0] // B
        perm = np.random.default_rng(0)
        blocks = jnp.asarray(np.stack([
            b * B + perm.permutation(B) for b in perm.permutation(nblocks)
        ]).astype(np.int32))
        eps = jnp.asarray(data.eps0, jnp.float32)
        device_us = {
            f"{kind}_{how}": us_per_block(
                variants[how][kind == "update"], kind, static, eps, blocks)
            for kind in ("cdot", "update") for how in ("plain", "fused")}
        result[name] = {
            "ms_per_iter": {h: [round(x, 4) for x in v]
                            for h, v in times.items()},
            "median_ms": {h: round(statistics.median(v), 4)
                          for h, v in times.items()},
            "fused_wins": sum(f < p for f, p in zip(times["fused"],
                                                    times["plain"])),
            "pairs": len(times["fused"]),
            "device_us_per_block": {k: round(v, 2)
                                    for k, v in device_us.items()},
        }
        print(f"#   {name}: {json.dumps(result[name])}", flush=True)
        del data, static, states, steps
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
