"""Command-line interface mirroring the reference's flag surface.

Flags (reference ``src/options.cpp:26-151``): --bed-file --dim-file
--phen-files --group-index-file --group-mixture-file --verbosity
--shuffle-markers --mimic-hydra --seed --iterations --trunc-markers --S
--out-dir --output-thin-rate --predict --bim-file --ref-bim-file, plus
accelerator knobs (--block-size --wave-size --dtype --devices).

``--S`` is accepted and ignored, like the reference (parsed but unused by
the sampler; options.cpp:105-118).  ``--mimic-hydra`` enforces the single-
phenotype restriction; bit-matching boost RNG streams is out of scope
(SURVEY §7), so it otherwise behaves as a determinism mode.
"""

from __future__ import annotations

import argparse
import sys

from gmrm_tpu.config import Options, OptionsError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gmrm-tpu",
        description="Accelerator-native Bayesian grouped "
                    "mixture-of-regressions (BayesR) Gibbs sampler for GWAS",
    )
    p.add_argument("--bed-file", default="")
    p.add_argument("--dim-file", default="")
    p.add_argument("--phen-files", default="",
                   help="comma-separated list of .phen files")
    p.add_argument("--group-index-file", default="")
    p.add_argument("--group-mixture-file", default="")
    p.add_argument("--verbosity", type=int, default=0)
    p.add_argument("--shuffle-markers", type=int, default=1)
    p.add_argument("--mimic-hydra", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--trunc-markers", type=int, default=0)
    p.add_argument("--S", default="", help="accepted for compatibility; unused")
    p.add_argument("--out-dir", default="")
    p.add_argument("--output-thin-rate", type=int, default=1)
    p.add_argument("--predict", action="store_true")
    p.add_argument("--bim-file", default="")
    p.add_argument("--ref-bim-file", default="")
    # Accelerator knobs (no reference analog)
    p.add_argument("--block-size", type=int, default=128,
                   help="markers per Gram block (residual sync cadence); "
                        "128 is the validated production configuration")
    p.add_argument("--wave-size", type=int, default=None,
                   help="markers per serial step within a block (1 = exact "
                        "serial recursion; W>1 relaxes like W co-scheduled "
                        "shards — the reference's own multi-rank semantics). "
                        "Default: auto — the validated production wave (32) "
                        "on an accelerator, 1 on CPU backends")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--devices", type=int, default=0,
                   help="number of devices for the marker mesh (0 = all)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a resumable chain checkpoint every N "
                        "iterations (0 = off; improvement over the "
                        "reference, which cannot resume)")
    p.add_argument("--resume", action="store_true",
                   help="resume from <out-dir>/checkpoint.npz if present")
    p.add_argument("--cache-dir", default="",
                   help="persist marker stats + Gram cache here, keyed "
                        "by dataset content + geometry (warm startup "
                        "across runs of the same dataset)")
    return p


def options_from_args(args) -> Options:
    return Options(
        bed_file=args.bed_file,
        dim_file=args.dim_file,
        phen_files=[f for f in args.phen_files.split(",") if f],
        group_index_file=args.group_index_file,
        group_mixture_file=args.group_mixture_file,
        bim_file=args.bim_file,
        ref_bim_file=args.ref_bim_file,
        verbosity=args.verbosity,
        shuffle_markers=bool(args.shuffle_markers),
        mimic_hydra=args.mimic_hydra,
        seed=args.seed,
        iterations=args.iterations,
        trunc_markers=args.trunc_markers,
        out_dir=args.out_dir,
        output_thin_rate=args.output_thin_rate,
        predict=args.predict,
        block_size=args.block_size,
        wave_size=args.wave_size,
        dtype=args.dtype,
        n_devices=args.devices,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        cache_dir=args.cache_dir,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.dtype == "float64":
        # Without this, JAX silently truncates f64 computations to f32
        # (x64 is opt-in); must be set before any array is created.
        import jax
        jax.config.update("jax_enable_x64", True)
    opt = options_from_args(args)
    try:
        opt.validate()
        if not opt.predict and opt.group_mixture_file:
            opt.load_group_mixtures()
    except OptionsError as e:
        print(f"FATAL  : {e}", file=sys.stderr)
        return 1

    import jax
    from gmrm_tpu import compile_cache
    compile_cache.enable()

    try:
        if opt.predict:
            from gmrm_tpu.predict import run_predict
            run_predict(opt)
            return 0

        n_dev = opt.n_devices or len(jax.devices())
        if n_dev > 1:
            from gmrm_tpu.parallel.runner import run_training_sharded
            run_training_sharded(opt, n_devices=opt.n_devices,
                                 verbose=opt.verbosity >= 0)
        else:
            from gmrm_tpu.runner import run_training
            run_training(opt, verbose=opt.verbosity >= 0)
    except OptionsError as e:
        print(f"FATAL  : {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
