"""End-to-end training runner: load inputs, run the Gibbs chain, write outputs.

The single-process equivalent of the reference's main()/process() driver
(``src/main.cpp:8-24``, ``src/bayes.cpp:318-677``): produces the same
``.csv`` / ``.bet`` / ``.cpn`` artifacts with identical layouts.  Multi-chip
execution lives in gmrm_tpu.parallel.runner and reuses everything here.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

from gmrm_tpu.config import Options
from gmrm_tpu.io.bed import read_bed, bed_bytes_per_marker
from gmrm_tpu.io.grouping import read_dim, read_group_index
from gmrm_tpu.io.phen import Phenotype, read_phen
from gmrm_tpu.io.writers import (
    HistoryWriter, format_csv_record, truncate_csv_to, write_csv_record,
)
from gmrm_tpu.ops.blockops import build_gram_cache, marker_stats_jax
from gmrm_tpu.ops.decode import to_phase_planes
from gmrm_tpu.sampler.dists import beta_11
from gmrm_tpu.sampler.gibbs import make_gibbs_step
from gmrm_tpu.sampler.state import (
    SamplerState, StaticInputs, init_state, pad_bed, pi_prior_from_cva,
)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class LoadedData:
    """Host-side preprocessed inputs for one marker shard."""
    n: int
    m_total: int
    m_local: int                 # markers in this shard (after truncation)
    s_local: int                 # global start of the shard
    mb: int                      # ceil(N/4)
    mb_pad: int
    m_pad: int
    bed: np.ndarray              # (m_pad, mb_pad) uint8
    phens: List[Phenotype]
    eps0: np.ndarray             # (T, 4, mb_pad)
    na: np.ndarray               # (T, 4, mb_pad)
    nonas: np.ndarray            # (T,)
    group_of: np.ndarray         # (m_pad,) int32
    mtotgrp: np.ndarray          # (G,) int32
    out_basenames: List[str]
    # Interleaved storage mapping (see interleave_order): original-order
    # values = stored[:, inv_order].  None when storage is in original
    # marker order.
    inv_order: Optional[np.ndarray] = None   # (m_local,) int64


def interleave_order(m_local: int, nblocks: int):
    """Stride interleave of the real markers across Gram blocks.

    Under the block-preserving shuffle, block membership is permanent, so
    genomically ADJACENT (high-LD) markers sharing a block would share a
    wave (blind to each other's moves) with probability W/B every
    iteration — measured to DIVERGE the W=32 sampler on LD-structured
    genotypes (benchmarking/validate_ld.py).  Storing marker j at the
    stable-sorted position of key (j mod nblocks) puts consecutive
    markers in consecutive BLOCKS: same-block neighbors are >= nblocks
    apart in the genome (>= 156 at the bench anchor), far beyond LD
    range.  The reference keeps contiguous per-rank blocks but pays no
    such price because its within-rank sweep is fully serial
    (phenotype.cpp:314-323).

    Returns (order, inv): storage row i holds original marker order[i];
    original-order values = stored[inv].
    """
    order = np.argsort(np.arange(m_local) % max(nblocks, 1),
                       kind="stable")
    inv = np.argsort(order, kind="stable")
    return order, inv


def stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def load_data(
    opt: Options,
    start_marker: int = 0,
    n_markers: Optional[int] = None,
    m_pad: Optional[int] = None,
    lane_pad: int = 512,
    interleave: bool = False,
) -> LoadedData:
    """Read and preprocess all inputs for one marker shard.

    ``start_marker``/``n_markers`` mirror the reference's per-rank block
    (bayes.cpp:903-925); the single-device runner uses the whole range.
    ``interleave`` stores markers block-interleaved (interleave_order) —
    required by the wave relaxation on LD-structured data; outputs are
    written back in original order via ``inv_order``.
    """
    n, m_total = read_dim(opt.dim_file)
    if opt.trunc_markers:
        m_total = min(m_total, opt.trunc_markers)
    if n_markers is None:
        n_markers = m_total - start_marker

    mb = bed_bytes_per_marker(n)
    mb_pad = round_up(mb, lane_pad)
    if m_pad is None:
        m_pad = round_up(max(n_markers, 1), opt.block_size)

    bed = read_bed(opt.bed_file, n, m_total, start_marker, n_markers)
    inv_order = None
    if interleave and n_markers > 1:
        order, inv_order = interleave_order(n_markers,
                                            m_pad // opt.block_size)
        bed = bed[order]
    bed = pad_bed(bed, m_pad, mb_pad)

    phens = [read_phen(fp, n) for fp in opt.phen_files]
    t = len(phens)
    eps0 = np.zeros((t, 4, mb_pad))
    na = np.zeros((t, 4, mb_pad))
    for i, ph in enumerate(phens):
        eps0[i, :, :mb] = to_phase_planes(ph.epsilon_padded())
        na[i, :, :mb] = to_phase_planes(ph.na_vector_padded())
    nonas = np.array([ph.nonas for ph in phens], dtype=np.float64)

    if opt.group_index_file:
        gidx_all = read_group_index(opt.group_index_file, opt.n_groups)
        if gidx_all.shape[0] < m_total:
            raise IOError(
                f"group index file has {gidx_all.shape[0]} entries "
                f"< Mt = {m_total}"
            )
        gidx_all = gidx_all[:m_total]
    else:
        gidx_all = np.zeros(m_total, dtype=np.int32)
    group_of = np.zeros(m_pad, dtype=np.int32)
    group_of[:n_markers] = gidx_all[start_marker:start_marker + n_markers]
    if inv_order is not None:
        group_of[:n_markers] = group_of[:n_markers][order]
    mtotgrp = np.bincount(gidx_all, minlength=opt.n_groups).astype(np.int32)

    return LoadedData(
        n=n, m_total=m_total, m_local=n_markers, s_local=start_marker,
        mb=mb, mb_pad=mb_pad, m_pad=m_pad, bed=bed, phens=phens,
        eps0=eps0, na=na, nonas=nonas, group_of=group_of, mtotgrp=mtotgrp,
        out_basenames=[stem(fp) for fp in opt.phen_files],
        inv_order=inv_order,
    )


@functools.lru_cache(maxsize=None)
def _stats_jit(dtype):
    # jit wrapper: marker_stats_jax's eager scan would close over the bed
    # array as a trace constant, recompiling per process and defeating
    # the persistent compilation cache (same bug class fixed in
    # predict.py round 4).
    return jax.jit(functools.partial(marker_stats_jax, dtype=dtype))


@functools.lru_cache(maxsize=None)
def _gram_cache_jit(block_size, shared_na):
    return jax.jit(functools.partial(build_gram_cache, block_size=block_size,
                                     shared_na=shared_na))


def hash_dataset_content(h, opt: Options) -> None:
    """Feed the dataset-content part of a startup-cache key into ``h``.

    Bed content is fingerprinted by (size, mtime, first+last MiB) — a
    full hash of a UKB-scale bed costs minutes, defeating the cache;
    phen files are small and hashed in full (they set the NA masks the
    stats/Gram depend on).  Shared by the single-device and sharded
    cache keys."""
    st = os.stat(opt.bed_file)
    h.update(f"bed:{st.st_size}:{st.st_mtime_ns};".encode())
    with open(opt.bed_file, "rb") as fh:
        h.update(fh.read(1 << 20))
        if st.st_size > (1 << 20):
            fh.seek(max(st.st_size - (1 << 20), 0))
            h.update(fh.read(1 << 20))
    for fp in opt.phen_files:
        with open(fp, "rb") as fh:
            h.update(fh.read())


def _startup_cache_key(data: LoadedData, opt: Options, dtype,
                       want_gram: bool) -> str:
    """Content+geometry fingerprint for the persisted startup artifacts.

    Bed content is fingerprinted by (size, mtime, first+last MiB) — a
    full hash of a UKB-scale bed costs minutes, defeating the cache;
    phen files are small and hashed in full (they set the NA masks the
    stats/Gram depend on).  Geometry covers everything that changes the
    stored marker ORDER or array shapes: shard range, padding, block
    size, interleave, dtype, NT axis."""
    import hashlib
    h = hashlib.sha256()
    hash_dataset_content(h, opt)
    shared_na = all(ph.nas == 0 for ph in data.phens)
    h.update(repr((data.n, data.m_local, data.s_local, data.m_pad,
                   data.mb_pad, opt.block_size,
                   data.inv_order is not None, str(jnp.dtype(dtype)),
                   shared_na, want_gram)).encode())
    return h.hexdigest()[:32]


def build_static(data: LoadedData, opt: Options, dtype,
                 verbose: bool = False) -> StaticInputs:
    opt.resolve_compute_plan()
    bed = jnp.asarray(data.bed)
    na = jnp.asarray(data.na, dtype)
    nonas = jnp.asarray(data.nonas, dtype)
    # The wave sweep consumes the per-block raw Gram (same criterion as
    # the runners' shared_na hint).
    shared_na = all(ph.nas == 0 for ph in data.phens)
    want_gram = opt.wave_size > 1

    # --- on-disk startup cache (--cache-dir): stats + Gram persist
    # across runs of the same dataset/geometry.  The builds are
    # O(Mt N B) — minutes at UKB scale (SCALE.md startup column) — while
    # a warm load is one npz read.  No reference analog (it recomputes
    # stats every run, phenotype.cpp:466-534).
    cache_path = mave = msig = None
    gram_cache = None
    if opt.cache_dir:
        os.makedirs(opt.cache_dir, exist_ok=True)
        key = _startup_cache_key(data, opt, dtype, want_gram)
        cache_path = os.path.join(opt.cache_dir, f"startup_{key}.npz")
        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                mave = jnp.asarray(z["mave"], dtype)
                msig = jnp.asarray(z["msig"], dtype)
                if "gram" in z.files:
                    gram_cache = jnp.asarray(z["gram"], jnp.float32)
            if verbose:
                print(f"INFO   : warm startup from {cache_path}")

    if mave is None:
        mave, msig = _stats_jit(dtype)(bed, na, nonas)
        # Zero stats on pad rows (all-missing decode gives sb=0 -> NaN).
        valid = (jnp.arange(data.m_pad) < data.m_local)[None, :]
        mave = jnp.where(valid, mave, 0.0)
        msig = jnp.where(valid, msig, 0.0)
        # Precompute the per-block raw Gram for the wave sweep (X and
        # block membership are iteration-invariant under the
        # block-preserving shuffle): one O(M N B) pass here turns the
        # per-iteration Gram into an O(M B^2) cache load.
        if want_gram:
            gram_cache = _gram_cache_jit(opt.block_size, shared_na)(bed, na)
        if cache_path is not None:
            arrays = {"mave": np.asarray(mave), "msig": np.asarray(msig)}
            if gram_cache is not None:
                arrays["gram"] = np.asarray(gram_cache)
            tmp = cache_path + ".tmp.npz"
            np.savez(tmp, **arrays)
            os.replace(tmp, cache_path)
    return StaticInputs(
        gram_cache=gram_cache,
        bed=bed, na=na, mave=mave, msig=msig,
        group_of=jnp.asarray(data.group_of),
        mtotgrp=jnp.asarray(data.mtotgrp),
        nonas=nonas,
        cva=jnp.asarray(opt.cva, dtype),
        cvai=jnp.asarray(opt.cvai, dtype),
        n_total=jnp.asarray(float(data.n), dtype),
        m_local=jnp.asarray(data.m_local, jnp.int32),
    )


def init_sampler_state(data: LoadedData, opt: Options, dtype) -> SamplerState:
    key = jr.PRNGKey(opt.seed)
    k_sg, _ = jr.split(key)
    t = len(data.phens)
    g, k = opt.cva.shape
    # sigmaG ~ Beta(1,1) per group, zeroed for empty groups, identical on
    # every device (the reference's rank-0 broadcast, bayes.cpp:327-332).
    sigmag0 = np.asarray(beta_11(k_sg, (t, g), dtype=dtype))
    sigmag0 = np.where(data.mtotgrp[None, :] == 0, 0.0, sigmag0)
    return init_state(
        key, t, data.m_pad, data.mb_pad, g, k,
        eps0=jnp.asarray(data.eps0, dtype),
        pi_prior=pi_prior_from_cva(np.asarray(opt.cva)),
        sigmag0=sigmag0,
        dtype=dtype,
    )


@dataclass
class RunResult:
    state: SamplerState
    iter_seconds: List[float] = field(default_factory=list)
    beta_mean: Optional[np.ndarray] = None   # (T, M) posterior mean over thin
    chain_seconds: float = 0.0               # wall-clock of the whole chain
    iters_run: int = 0


def _guard_resume_without_checkpoint(opt: Options, data) -> None:
    """--resume with no checkpoint file: starting fresh is fine in an
    empty out_dir, but if a previous chain's outputs exist they would
    be silently deleted and overwritten (code-review r5) — fail loudly
    instead and let the user decide."""
    existing = [b for b in data.out_basenames
                if os.path.exists(os.path.join(opt.out_dir, b + ".bet"))]
    if existing:
        raise ValueError(
            f"--resume requested but no checkpoint found in "
            f"{opt.out_dir}, which already holds chain outputs "
            f"({existing[0]}.bet ...).  A fresh run would destroy them: "
            f"drop --resume to restart deliberately, or restore the "
            f"checkpoint file.")


class OutputSet:
    """Per-trait .csv/.bet/.cpn writers (reference phenotype.cpp:129-203).

    ``resume=True`` keeps existing files and appends records instead of the
    reference's delete-then-create-EXCL behavior; ``n_rec`` (the
    checkpoint's record count) cuts files back so rows written AFTER the
    checkpoint was taken — stale relative to the resumed chain — do not
    survive past the resume point.
    """

    def __init__(self, opt: Options, data: LoadedData, resume: bool = False,
                 n_rec: Optional[int] = None):
        self.enabled = bool(opt.out_dir)
        self.csv_paths = []
        self.bet = []
        self.cpn = []
        if not self.enabled:
            return
        opt.ensure_out_dir()
        for base in data.out_basenames:
            b = os.path.join(opt.out_dir, base)
            csv_path = b + ".csv"
            if not resume and os.path.exists(csv_path):
                os.remove(csv_path)
            self.csv_paths.append(csv_path)
            if resume and os.path.exists(b + ".bet"):
                self.bet.append(HistoryWriter.open_existing(
                    b + ".bet", data.m_total, "f8"))
                self.cpn.append(HistoryWriter.open_existing(
                    b + ".cpn", data.m_total, "i4"))
                if n_rec is not None:
                    self.bet[-1].truncate_to(n_rec)
                    self.cpn[-1].truncate_to(n_rec)
                    truncate_csv_to(csv_path, n_rec)
            elif resume and n_rec:
                # The checkpoint says n_rec records were written, but
                # the history file is gone: silently creating a fresh
                # one would leave records 0..n_rec-1 as zero-filled
                # garbage that read_history returns as real data
                # (code-review r5).
                raise IOError(
                    f"resume: checkpoint records {n_rec} thinned rows "
                    f"but {b}.bet is missing — restore the output files "
                    f"or restart the chain.")
            else:
                self.bet.append(HistoryWriter(b + ".bet", data.m_total, "f8"))
                self.cpn.append(HistoryWriter(b + ".cpn", data.m_total, "i4"))

    def write_thinned(self, rec: int, it: int, state_host, aux_host,
                      data: LoadedData):
        if not self.enabled:
            return
        sigmag = np.asarray(state_host.sigmag, np.float64)
        sigmae = np.asarray(state_host.sigmae, np.float64)
        pi = np.asarray(state_host.pi_est, np.float64)
        m0 = np.asarray(aux_host.m0)
        betas = np.asarray(state_host.betas, np.float64)
        comp = np.asarray(state_host.comp, np.int32)
        ml, s = data.m_local, data.s_local
        iv = data.inv_order
        if iv is not None:
            # interleaved storage -> original marker order on disk
            betas = betas[:, :ml][:, iv]
            comp = comp[:, :ml][:, iv]
        for ti in range(len(self.bet)):
            row = format_csv_record(it, sigmag[ti], float(sigmae[ti]),
                                    int(m0[ti].sum()), pi[ti])
            write_csv_record(self.csv_paths[ti], rec, row)
            self.bet[ti].write_record(it, betas[ti, :ml], start=s, rec=rec)
            self.cpn[ti].write_record(it, comp[ti, :ml], start=s, rec=rec)


_SIGMA_DIVERGED = 1.0e6


def check_finite_chain(sigmag, sigmae, it: int) -> None:
    """In-chain divergence guard: a divergent chain
    writes garbage from then on — fail loudly with remediation advice
    instead.  Phenotypes are always centered AND scaled (io/phen.py, the
    reference does the same, phenotype.cpp:578-607), so valid chains
    have sigmaE + sum sigmaG ~ 1; a variance beyond 1e6 (or NaN/Inf) is
    unambiguous geometric blow-up, caught long before f32 overflow.
    Costs nothing extra: called only where the hypers are already
    host-fetched (thin boundaries + end of chain)."""
    sg = np.asarray(sigmag, np.float64)
    se = np.asarray(sigmae, np.float64)
    bad = (not (np.isfinite(sg).all() and np.isfinite(se).all())
           or se.max(initial=0.0) > _SIGMA_DIVERGED
           or sg.max(initial=0.0) > _SIGMA_DIVERGED)
    if bad:
        raise FloatingPointError(
            f"FATAL  : chain diverged by iteration {it} (non-finite or "
            f"exploding sigmaG/sigmaE).  On small panels with extreme "
            f"local LD the wave relaxation can be unstable — rerun with "
            f"--wave-size 1 (the exact-serial recursion) or a smaller "
            f"--block-size; see benchmarking/LD_VALIDATION.md."
        )


def run_training(opt: Options, verbose: bool = True) -> RunResult:
    """The full --process path on the current default device."""
    opt.validate()
    opt.resolve_compute_plan()
    if opt.cva is None:
        opt.load_group_mixtures()
    dtype = jnp.dtype(opt.dtype)

    # Phase timing mirrors the reference's self-instrumentation
    # (genotype load bayes.cpp:897, marker stats bayes.cpp:790-792).
    t0 = time.perf_counter()
    # Too few Gram blocks for the relaxation's safety margin?  The auto
    # plan downgrades to exact-serial W=1 BEFORE the interleave decision
    # (storage layout follows the resolved wave) — see
    # Options.guard_wave_blocks.
    n_pre, m_pre = read_dim(opt.dim_file)
    if opt.trunc_markers:
        m_pre = min(m_pre, opt.trunc_markers)
    opt.guard_wave_blocks(m_pre, verbose=verbose)
    # Block-interleaved marker storage whenever the wave relaxation is on
    # (W > 1): mandatory on LD-structured data — see interleave_order.
    data = load_data(opt, interleave=(opt.wave_size or 1) > 1)
    if verbose:
        print(f"INFO   : time to load genotype + phenotype data = "
              f"{time.perf_counter() - t0:.2f} seconds.")
        # Per-phenotype NA detail rides --verbosity like the reference
        # (phenotype.cpp:610-627 gates it at verbosity_level(2)).
        if opt.verbosity_level(2):
            for ph in data.phens:
                print(f"INFO   : {ph.filepath} has {ph.nas} NAs and "
                      f"{ph.nonas} non-NAs.")
    t0 = time.perf_counter()
    static = build_static(data, opt, dtype, verbose=verbose)
    jax.block_until_ready(static.msig)
    if verbose:
        print(f"INFO   : time to compute the markers' statistics: "
              f"{time.perf_counter() - t0:.2f} seconds.")
    state = init_sampler_state(data, opt, dtype)

    shared_na = all(ph.nas == 0 for ph in data.phens)
    step = make_gibbs_step(block_size=opt.block_size,
                           donate=True, shuffle=opt.shuffle_markers,
                           shared_na=shared_na, wave_size=opt.wave_size)

    beta_acc = np.zeros_like(np.asarray(state.betas, np.float64))
    n_rec = 0
    start_it = 1
    ckpt = None
    if opt.out_dir and (opt.checkpoint_every or opt.resume):
        from gmrm_tpu.checkpoint import (
            checkpoint_path, save_checkpoint, load_checkpoint, layout_of,
        )
        opt.ensure_out_dir()
        ckpt = checkpoint_path(opt.out_dir)
        ckpt_layout = layout_of(opt, m_total=data.m_total)
    if not opt.resume and opt.out_dir and os.path.isdir(opt.out_dir):
        # Fresh run: stale checkpoint files belong to a dead chain; a
        # later --resume must not resurrect them.
        from gmrm_tpu.checkpoint import _clear_ckpt_files
        _clear_ckpt_files(opt.out_dir)
    resuming = bool(opt.resume and ckpt and os.path.exists(ckpt))
    if opt.resume and ckpt and not resuming:
        from gmrm_tpu.checkpoint import _ckpt_files
        others = _ckpt_files(opt.out_dir)
        if others:
            raise ValueError(
                f"--resume: no {ckpt}, but per-process sharded "
                f"checkpoints exist ({[os.path.basename(f) for f in others]}) "
                f"— resume with the sharded runner (which accepts any "
                f"process layout) instead of the single-device runner; "
                f"a fresh run here would overwrite that chain's outputs.")
        _guard_resume_without_checkpoint(opt, data)
    if resuming:
        state, last_it, acc, n_rec = load_checkpoint(
            ckpt, dtype, expect_layout=ckpt_layout)
        if acc is not None:
            beta_acc = acc
        start_it = last_it + 1
        if verbose:
            print(f"INFO   : resuming from checkpoint at iteration {last_it}")

    outputs = OutputSet(opt, data, resume=resuming,
                        n_rec=n_rec if resuming else None)
    result = RunResult(state=state)

    # Iterations are dispatched back-to-back WITHOUT per-iteration host
    # syncs, so the host enqueues the next step while the device runs this
    # one; the host only syncs at thin/checkpoint boundaries and once at
    # the end.  ``verbose`` restores per-iteration timing prints (the
    # reference's bayes.cpp:653-655 behavior) at that sync cost.
    t_chain = time.perf_counter()
    for it in range(start_it, opt.iterations + 1):
        t0 = time.perf_counter()
        state, aux = step(state, static, jnp.asarray(it, jnp.int32))
        if it % opt.output_thin_rate == 0:
            rec = it // opt.output_thin_rate - 1
            state_host = jax.device_get(state)
            aux_host = jax.device_get(aux)
            check_finite_chain(state_host.sigmag, state_host.sigmae, it)
            outputs.write_thinned(rec, it, state_host, aux_host, data)
            bh = np.asarray(state_host.betas, np.float64)
            if data.inv_order is not None:
                bh = bh.copy()
                bh[:, :data.m_local] = \
                    bh[:, :data.m_local][:, data.inv_order]
            beta_acc += bh
            n_rec += 1
            if verbose:
                sg_sum = np.asarray(state_host.sigmag).sum(axis=1)
                se = np.asarray(state_host.sigmae)
                for ti in range(sg_sum.shape[0]):
                    print(
                        f"RESULT : i:{it} p:{ti}  sum sigmaG = "
                        f"{sg_sum[ti]:20.15f}  sigmaE = {se[ti]:20.15f}"
                    )
        # Per-iteration timing (the reference's bayes.cpp:653-655 print)
        # costs a device sync per iteration, so it rides --verbosity >= 1;
        # at verbosity 0 the chain stays dispatch-pipelined and iter times
        # are batch-level.
        if verbose and opt.verbosity_level(1):
            jax.block_until_ready(state.sigmae)
            dt = time.perf_counter() - t0
            print(f"RESULT : It {it}  total proc time = {dt:7.3f} sec")
        else:
            dt = time.perf_counter() - t0
        result.iter_seconds.append(dt)
        if ckpt and opt.checkpoint_every and it % opt.checkpoint_every == 0:
            save_checkpoint(ckpt, jax.device_get(state), it, beta_acc,
                            n_rec, layout=ckpt_layout)

    jax.block_until_ready(state.sigmae)
    check_finite_chain(jax.device_get(state.sigmag),
                       jax.device_get(state.sigmae), opt.iterations)
    result.chain_seconds = time.perf_counter() - t_chain
    result.iters_run = opt.iterations - start_it + 1
    result.state = state
    if n_rec:
        result.beta_mean = beta_acc / n_rec
    return result
