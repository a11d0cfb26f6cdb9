"""Worker for the multi-process sharding test (run via subprocess).

Each process joins a 2-process gloo CPU cluster with 4 local virtual
devices (8 global — the same mesh as the single-process sharding tests),
runs the sharded trainer, and writes its own marker shards to the shared
out-dir.  tests/test_multiprocess.py compares the resulting artifacts
bit-for-bit with a single-process 8-device run: the sampler's draws depend
only on the global mesh size and seed, not on the process layout, so they
must be identical.

Usage: python multiprocess_worker.py <pid> <nprocs> <port> <data> <out> \
           [train|predict|resume:<iters>:<ckpt_every>] [cache_dir]
"""

import os
import sys


def main():
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    data_dir, out_dir = sys.argv[4], sys.argv[5]
    mode = sys.argv[6] if len(sys.argv) > 6 else "train"
    cache_dir = sys.argv[7] if len(sys.argv) > 7 else None

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from gmrm_tpu import compile_cache
    compile_cache.enable()
    from gmrm_tpu.parallel.distributed import init_distributed
    init_distributed(coordinator_address=f"localhost:{port}",
                     num_processes=nprocs, process_id=pid)
    assert jax.process_count() == nprocs
    assert len(jax.devices()) == 4 * nprocs

    from gmrm_tpu.config import Options
    from gmrm_tpu.parallel.runner import run_training_sharded

    phens = sorted(
        os.path.join(data_dir, f) for f in os.listdir(data_dir)
        if f.endswith(".phen")
    )
    if mode == "predict":
        # Multi-process predict: per-process .bed/.bet slice reads and
        # positioned .mlma writes (reference bayes.cpp:93-136, 223-254).
        from gmrm_tpu.predict import run_predict
        opt = Options(
            bed_file=f"{data_dir}/test.bed",
            dim_file=f"{data_dir}/test.dim", phen_files=phens,
            bim_file=f"{data_dir}/test.bim",
            ref_bim_file=f"{data_dir}/test.bim",
            out_dir=out_dir, predict=True,
        )
        run_predict(opt, verbose=False)
    else:
        # mode == "train" or "resume:<iters>:<ckpt_every>" (the latter
        # continues a checkpointed chain — exercising the
        # topology-portable v2 load when the checkpoint was written
        # under a different process layout).
        iters, ckpt_every, resume = 10, 0, False
        if mode.startswith("resume:"):
            _, it_s, ck_s = mode.split(":")
            iters, ckpt_every, resume = int(it_s), int(ck_s), True
        opt = Options(
            bed_file=f"{data_dir}/test.bed", dim_file=f"{data_dir}/test.dim",
            phen_files=phens,
            group_index_file=f"{data_dir}/test.gri",
            group_mixture_file=f"{data_dir}/test.grm",
            iterations=iters, seed=42, out_dir=out_dir, block_size=16,
            output_thin_rate=2, checkpoint_every=ckpt_every, resume=resume,
            cache_dir=cache_dir,
            # The production configuration: wave mode engages the
            # per-shard Gram cache across the REAL process boundary.
            wave_size=4,
        )
        run_training_sharded(opt, verbose=False)
    print(f"worker {pid}: done", flush=True)


if __name__ == "__main__":
    main()
