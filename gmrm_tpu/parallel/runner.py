"""Marker-sharded multi-device / multi-process training via shard_map.

The device-mesh replacement for the reference's MPI protocol (SURVEY §2
C10):

- marker block partition over devices  <- set_block_of_markers
  (bayes.cpp:903-925), remainder to low shards, common padded per-shard
  length (the Mm idle-step scheme, bayes.cpp:375-382);
- per-block psum of the residual delta  <- the per-marker-step
  MPI_Allgatherv of (dbeta, mave, msig) + raw bed column replay
  (bayes.cpp:500-553); block_size=1 reproduces the reference's per-marker
  cadence exactly, larger blocks are the throughput mode;
- psum of per-group beta^2 / cass  <- MPI_Allreduce (bayes.cpp:575-589);
- replicated-key hyperparameter draws  <- rank-0 MPI_Bcast
  (bayes.cpp:626-650): every device draws the same values.

Multi-process (multi-host) execution mirrors the reference's per-rank
genotype loading (bayes.cpp:867-900): after ``jax.distributed.initialize``
each process reads ONLY its own devices' .bed marker slices and the global
sharded arrays are assembled with ``jax.make_array_from_process_local_data``
— no host ever holds the full genotype matrix.  Thinned .bet/.cpn records
are written by each process for its own marker range (the reference's
MPI_File_write_at-with-offset scheme, xfiles.hpp:15-38); process 0 writes
the .csv rows.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from gmrm_tpu.config import Options
from gmrm_tpu.io.bed import read_bed, bed_bytes_per_marker
from gmrm_tpu.io.grouping import read_dim, read_group_index
from gmrm_tpu.io.phen import read_phen
from gmrm_tpu.io.writers import (
    HistoryWriter, format_csv_record, truncate_csv_to, write_csv_record,
)
from gmrm_tpu.ops.blockops import build_gram_cache, marker_stats_jax
from gmrm_tpu.ops.decode import to_phase_planes
from gmrm_tpu.parallel.mesh import MARKER_AXIS, make_marker_mesh, marker_blocks
from gmrm_tpu.runner import (
    RunResult, check_finite_chain, interleave_order, round_up, stem,
)
from gmrm_tpu.sampler.dists import beta_11
from gmrm_tpu.sampler.gibbs import gibbs_iteration
from gmrm_tpu.sampler.state import (
    SamplerState, StaticInputs, init_state, pad_bed, pi_prior_from_cva,
)


def _state_specs() -> SamplerState:
    rep = P()
    sh = P(None, MARKER_AXIS)
    return SamplerState(
        eps=rep, betas=sh, comp=sh, acum=sh, cass=rep, sigmag=rep,
        sigmae=rep, pi_est=rep, mu=rep, epssum=rep, key=rep,
    )


def _static_specs(with_cache: bool = False) -> StaticInputs:
    rep = P()
    return StaticInputs(
        bed=P(MARKER_AXIS), na=rep, mave=P(None, MARKER_AXIS),
        msig=P(None, MARKER_AXIS), group_of=P(MARKER_AXIS), mtotgrp=rep,
        nonas=rep, cva=rep, cvai=rep, n_total=rep, m_local=P(MARKER_AXIS),
        gram_cache=P(MARKER_AXIS) if with_cache else None,
    )


def make_sharded_step(mesh, *, block_size: int,
                      donate: bool = True, shuffle: bool = True,
                      shared_na: bool = False, wave_size: int = 1,
                      with_cache: bool = False, sync: bool = True):
    """Jitted sharded step (state, static, it) -> (state, aux).

    ``sync=False`` compiles a TIMING-ONLY variant with the collectives
    elided (identical path selection and per-shard compute; results are
    wrong across shards) — see ``measure_sync_seconds``.
    """
    fn = partial(gibbs_iteration, block_size=block_size,
                 axis_name=MARKER_AXIS, shuffle=shuffle, shared_na=shared_na,
                 wave_size=wave_size, elide_collectives=not sync)
    sspec, tspec = _state_specs(), _static_specs(with_cache)
    # The no-sync timing variant skips vma checking: without the psums its
    # outputs are genuinely unreplicated.
    sharded = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(sspec, tspec, P()),
        out_specs=(sspec, P()),
        check_vma=sync,
    )
    return jax.jit(sharded, donate_argnums=(0,) if donate else ())


def estimate_sync_seconds(mesh, nblocks: int, t_traits: int, mb_pad: int,
                          n_groups: int, n_mix: int, dtype,
                          timing_iters: int = 20) -> float:
    """Measure one iteration's collective (sync) cost on this mesh.

    The sharded sweep's per-iteration communication is ``nblocks``
    dependent psums of the (T, 4, mb_pad) residual delta plus the two
    tiny hyper-block psums (beta^2 per group, cass) — the device analog of
    the reference's per-marker Allgatherv + per-iteration Allreduce
    whose cost it prints as "sync time" (bayes.cpp:549-551,653-655).
    This runs the exact collective sequence standalone (same shapes,
    same serial dependence) and returns seconds per iteration — an
    UPPER BOUND: a bare psum chain has no compute to overlap, so it can
    overstate the in-loop cost substantially (SCALE.md measures 3.5x at
    1x8 in-process).  ``measure_sync_seconds`` gives the true in-step
    split at the price of compiling a second step; this estimate stays
    the verbosity-1 default because it needs no extra compile.
    """
    import jax.random as jr

    def chain(eps):
        def body(_, carry):
            eps, d = carry
            s = jax.lax.psum(d, MARKER_AXIS)
            eps = eps + s * 1e-9
            return eps, d + eps * 1e-12
        d0 = eps * (jax.lax.axis_index(MARKER_AXIS).astype(eps.dtype)
                    * 1e-9 + 1.0)
        eps, d = jax.lax.fori_loop(0, nblocks, body, (eps, d0))
        small = jnp.sum(eps) * jnp.ones((t_traits, n_groups, n_mix),
                                        eps.dtype)
        small = jax.lax.pcast(small, (MARKER_AXIS,), to='varying')
        return eps + jax.lax.psum(small, MARKER_AXIS)[0, 0, 0]

    fn = jax.jit(jax.shard_map(chain, mesh=mesh, in_specs=P(),
                               out_specs=P()))
    eps = jnp.asarray(
        np.asarray(jr.normal(jr.PRNGKey(0), (t_traits, 4, mb_pad))), dtype)
    out = fn(eps)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(timing_iters):
        out = fn(out * 0.5)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / timing_iters


def measure_sync_seconds(step_sync, step_nosync, state, static,
                         timing_iters: int = 10):
    """Differential IN-STEP sync measurement (the reference's in-loop
    "sync time", bayes.cpp:549-551,653-655, measured on the device mesh).

    Times the real jitted sharded step against an identically-gated
    variant compiled with the collectives elided
    (``make_sharded_step(..., sync=False)``: same kernels, same path
    selection, psums skipped) on device-cloned state, and attributes the
    difference to the in-step collective cost.  Unlike
    ``estimate_sync_seconds`` (a standalone collective chain with the
    same shapes/cadence), this includes whatever overlap XLA actually
    achieves between the psums and the surrounding compute — it is the
    number a user should compare against the reference's printed sync
    split.  Returns ``(sync_seconds, with_seconds, without_seconds)``.

    Both steps may donate their inputs: they are fed device-side clones
    and each chain evolves its own clone (state trajectories differ —
    timing-only).
    """
    def run(step):
        s = jax.tree.map(jnp.copy, state)
        it = jnp.asarray(1, jnp.int32)
        s, _ = step(s, static, it)          # compile + warm
        jax.block_until_ready(s.sigmae)
        t0 = time.perf_counter()
        for k in range(timing_iters):
            s, _ = step(s, static, jnp.asarray(2 + k, jnp.int32))
        jax.block_until_ready(s.sigmae)
        return (time.perf_counter() - t0) / timing_iters

    t_with = run(step_sync)
    t_without = run(step_nosync)
    return max(0.0, t_with - t_without), t_with, t_without


class ShardLayout:
    """Global marker layout: n_shards blocks, each padded to m_pad_shard."""

    def __init__(self, m_total: int, n_shards: int, m_pad_shard: int):
        self.m_total = m_total
        self.blocks = marker_blocks(m_total, n_shards)
        self.n_shards = n_shards
        self.m_pad_shard = m_pad_shard
        self.m_pad = n_shards * m_pad_shard

    def gather_global(self, arr: np.ndarray) -> np.ndarray:
        """(T, n_shards*m_pad_shard) padded-shard layout -> (T, M_total)."""
        parts = []
        for i, (s, ln) in enumerate(self.blocks):
            a = i * self.m_pad_shard
            parts.append(arr[:, a:a + ln])
        return np.concatenate(parts, axis=1)


@dataclass
class ProcessData:
    """Host-side inputs for THIS process's marker shards."""
    n: int
    m_total: int
    mb: int
    mb_pad: int
    layout: ShardLayout
    local_ids: List[int]          # global shard indices on this process
    bed_local: np.ndarray         # (len(local_ids)*m_pad_shard, mb_pad)
    group_local: np.ndarray       # (len(local_ids)*m_pad_shard,)
    m_local_arr: np.ndarray       # (len(local_ids),) real marker counts
    inv_orders: list              # per-local-shard inv map or None
    phens: list
    eps0: np.ndarray              # (T, 4, mb_pad) replicated
    na: np.ndarray                # (T, 4, mb_pad)
    nonas: np.ndarray             # (T,)
    mtotgrp: np.ndarray           # (G,)
    out_basenames: List[str]


def load_data_process(opt: Options, n_shards: int,
                      local_ids: Optional[Sequence[int]] = None,
                      lane_pad: int = 512,
                      interleave: bool = False) -> ProcessData:
    """Read this process's shards only (reference per-rank load,
    bayes.cpp:867-900: each rank reads offset 3 + S*mbytes).

    ``local_ids`` defaults to all shards (single-process mode).
    """
    n, m_total = read_dim(opt.dim_file)
    if opt.trunc_markers:
        m_total = min(m_total, opt.trunc_markers)
    blocks = marker_blocks(m_total, n_shards)
    mm = max(ln for _, ln in blocks)
    m_pad_shard = round_up(max(mm, 1), opt.block_size)
    layout = ShardLayout(m_total, n_shards, m_pad_shard)
    if local_ids is None:
        local_ids = list(range(n_shards))
    local_ids = list(local_ids)

    mb = bed_bytes_per_marker(n)
    mb_pad = round_up(mb, lane_pad)

    bed_parts, grp_parts, mloc = [], [], []
    if opt.group_index_file:
        gidx_all = read_group_index(opt.group_index_file, opt.n_groups)
        if gidx_all.shape[0] < m_total:
            raise IOError(
                f"group index file has {gidx_all.shape[0]} entries "
                f"< Mt = {m_total}")
        gidx_all = gidx_all[:m_total]
    else:
        gidx_all = np.zeros(m_total, dtype=np.int32)
    mtotgrp = np.bincount(gidx_all, minlength=opt.n_groups).astype(np.int32)

    inv_orders = []
    for i in local_ids:
        s, ln = blocks[i]
        bed_i = read_bed(opt.bed_file, n, m_total, s, ln)
        g = np.zeros(m_pad_shard, np.int32)
        g[:ln] = gidx_all[s:s + ln]
        if interleave and ln > 1:
            # per-shard block interleave (see runner.interleave_order):
            # same-block markers end up >= nblocks apart in the genome.
            order, inv = interleave_order(ln, m_pad_shard // opt.block_size)
            bed_i = bed_i[order]
            g[:ln] = g[:ln][order]
            inv_orders.append(inv)
        else:
            inv_orders.append(None)
        bed_parts.append(pad_bed(bed_i, m_pad_shard, mb_pad))
        grp_parts.append(g)
        mloc.append(ln)

    phens = [read_phen(fp, n) for fp in opt.phen_files]
    t = len(phens)
    eps0 = np.zeros((t, 4, mb_pad))
    na = np.zeros((t, 4, mb_pad))
    for i, ph in enumerate(phens):
        eps0[i, :, :mb] = to_phase_planes(ph.epsilon_padded())
        na[i, :, :mb] = to_phase_planes(ph.na_vector_padded())

    return ProcessData(
        n=n, m_total=m_total, mb=mb, mb_pad=mb_pad, layout=layout,
        local_ids=local_ids,
        bed_local=np.concatenate(bed_parts, axis=0),
        group_local=np.concatenate(grp_parts),
        m_local_arr=np.asarray(mloc, np.int32),
        inv_orders=inv_orders,
        phens=phens, eps0=eps0, na=na,
        nonas=np.array([ph.nonas for ph in phens], np.float64),
        mtotgrp=mtotgrp,
        out_basenames=[stem(fp) for fp in opt.phen_files],
    )


def local_shard_ids(mesh) -> List[int]:
    """Global shard indices whose device lives on this process."""
    pid = jax.process_index()
    return [i for i, d in enumerate(mesh.devices.flat)
            if d.process_index == pid]


def make_global(mesh, spec: P, local_np: np.ndarray, dtype=None):
    """Assemble a global array from this process's local shard data."""
    if dtype is not None:
        local_np = np.asarray(local_np, dtype)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sh, local_np)


def local_marker_slices(arr, layout: ShardLayout, local_ids: Sequence[int]):
    """Per-local-shard host copies of a (T, m_pad) marker-sharded global
    array: [(global_start, real_len, (T, real_len) np.ndarray), ...]."""
    mps = layout.m_pad_shard
    shards = {sh.index[1].start or 0: np.asarray(sh.data)
              for sh in arr.addressable_shards}
    out = []
    for i in local_ids:
        s, ln = layout.blocks[i]
        data = shards[i * mps]
        out.append((s, ln, data[:, :ln]))
    return out


class ShardedOutputSet:
    """Per-trait .csv/.bet/.cpn writers for sharded runs: process 0 creates
    the files, every process writes its own marker ranges (the reference's
    per-rank positioned writes, xfiles.hpp:15-38)."""

    def __init__(self, opt: Options, data: ProcessData, resume: bool = False,
                 n_rec: Optional[int] = None):
        self.enabled = bool(opt.out_dir)
        self.csv_paths, self.bet, self.cpn = [], [], []
        if not self.enabled:
            return
        pid = jax.process_index()
        # A checkpoint claiming n_rec rows whose .bet is gone must fail
        # on EVERY process (shared fs -> consistent verdict) BEFORE the
        # barrier below — raising on process 0 alone would leave the
        # others deadlocked in sync_global_devices (code-review r5).
        if resume and n_rec:
            for base in data.out_basenames:
                b = os.path.join(opt.out_dir, base)
                if not os.path.exists(b + ".bet"):
                    raise IOError(
                        f"resume: checkpoint records {n_rec} thinned "
                        f"rows but {b}.bet is missing — restore the "
                        f"output files or restart the chain.")
        # Process 0 creates (or, on resume, keeps) every file, THEN one
        # barrier, then the other processes attach without truncating.
        # On resume the files are cut back to the checkpoint's n_rec:
        # rows written after the checkpoint was taken are stale and must
        # not survive past the resume point.
        if pid == 0:
            opt.ensure_out_dir()
            for base in data.out_basenames:
                b = os.path.join(opt.out_dir, base)
                if not resume and os.path.exists(b + ".csv"):
                    os.remove(b + ".csv")
                if resume and os.path.exists(b + ".bet"):
                    for suf, kind in ((".bet", "f8"), (".cpn", "i4")):
                        w = HistoryWriter.open_existing(b + suf,
                                                        data.m_total, kind)
                        if n_rec is not None:
                            w.truncate_to(n_rec)
                    if n_rec is not None:
                        truncate_csv_to(b + ".csv", n_rec)
                else:
                    # resume + missing .bet already raised above, on
                    # every process, before the barrier.
                    HistoryWriter(b + ".bet", data.m_total, "f8")
                    HistoryWriter(b + ".cpn", data.m_total, "i4")
        _sync_processes("outputs-create")
        for base in data.out_basenames:
            b = os.path.join(opt.out_dir, base)
            self.csv_paths.append(b + ".csv")
            self.bet.append(HistoryWriter.open_existing(
                b + ".bet", data.m_total, "f8"))
            self.cpn.append(HistoryWriter.open_existing(
                b + ".cpn", data.m_total, "i4"))

    def write_thinned(self, rec, it, state_host_small, m0_sum, beta_slices,
                      comp_slices):
        if not self.enabled:
            return
        pid = jax.process_index()
        sigmag, sigmae, pi = state_host_small
        for ti in range(len(self.bet)):
            if pid == 0:
                row = format_csv_record(it, sigmag[ti], float(sigmae[ti]),
                                        int(m0_sum[ti]), pi[ti])
                write_csv_record(self.csv_paths[ti], rec, row)
            for (s, ln, bdata), (_, _, cdata) in zip(beta_slices[ti],
                                                     comp_slices[ti]):
                self.bet[ti].write_record(it, bdata, start=s, rec=rec)
                self.cpn[ti].write_record(it, cdata.astype(np.int32),
                                          start=s, rec=rec)


def _sync_processes(tag: str):
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(tag)


def _ckpt_path(out_dir: str) -> str:
    pid = jax.process_index()
    suffix = f".p{pid}" if jax.process_count() > 1 else ""
    return os.path.join(out_dir, f"checkpoint{suffix}.npz")


_REPLICATED = ("eps", "cass", "sigmag", "sigmae", "pi_est", "mu", "epssum",
               "key")
_SHARDED = ("betas", "comp", "acum")


def _save_sharded_checkpoint(path, state, it, layout, local_ids, beta_acc,
                             n_rec, storage=None, inv_orders=None):
    """Format v2 (topology-portable): marker-state
    slices are saved in ORIGINAL marker order with their GLOBAL
    (start, len) ranges, so any later process/shard layout can
    reassemble and re-interleave them — a pod resize or 1x8 -> 2x4 move
    no longer kills resume."""
    arrays = {f: np.asarray(jax.device_get(getattr(state, f)))
              for f in _REPLICATED}
    starts = []
    for f in _SHARDED:
        slices = local_marker_slices(getattr(state, f), layout, local_ids)
        for k, (s, ln, d) in enumerate(slices):
            iv = None if inv_orders is None else inv_orders[k]
            arrays[f"{f}_{k}"] = d if iv is None else d[:, iv]
            if f == _SHARDED[0]:
                starts.append((s, ln))
    arrays["starts"] = np.asarray(starts, np.int64)      # (n_local, 2)
    arrays["it"] = np.asarray(it)
    arrays["n_rec"] = np.asarray(n_rec)
    arrays["n_local"] = np.asarray(len(local_ids))
    if storage is not None:
        from gmrm_tpu.checkpoint import _LAYOUT_KEYS
        for k in _LAYOUT_KEYS:
            arrays[f"layout_{k}"] = np.asarray(storage[k])
    if beta_acc is not None:
        arrays["beta_acc"] = beta_acc
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    # Keep the previous save as a fallback era: a crash while OTHER
    # processes are still writing leaves the newest era incomplete, and
    # the loader then falls back to the last complete one.
    if os.path.exists(path):
        os.replace(path, path[:-len(".npz")] + ".prev.npz")
    os.replace(tmp, path)


from gmrm_tpu.checkpoint import _ckpt_files, _clear_ckpt_files  # noqa: E402


def _load_sharded_checkpoint(files, layout, local_ids, data, dtype,
                             expect_storage=None):
    """Assemble the global original-order marker state from the newest
    COMPLETE save era, then re-shard into the CURRENT layout
    (re-applying the current per-shard interleave orders).

    Eras are tried newest-first: a crash mid-checkpoint can leave some
    processes at a newer `it` than others — the stragglers' previous
    files (kept as *.prev.npz by _save_sharded_checkpoint) complete the
    older era, so the chain is always resumable from SOME checkpoint.

    v2 slices are stored in original marker order with global ranges,
    so NO storage-layout agreement is required between the writing and
    resuming runs — a pod resize, an auto wave downgrade, or a
    deliberate block/wave change all realign here (the layout stamp is
    saved for diagnostics only; ``expect_storage`` is unused for v2
    files and kept for signature stability)."""
    m_total = layout.m_total
    by_it = {}
    for fp in files:
        with np.load(fp) as z:
            if "starts" not in z.files:
                raise ValueError(
                    f"{fp}: not a topology-portable sharded checkpoint "
                    f"(pre-v2 sharded format, or written by the "
                    f"single-device runner) — resume with the runner/"
                    f"topology that wrote it, or restart the chain.")
            if ("layout_m_total" in z.files
                    and int(z["layout_m_total"]) != m_total):
                raise ValueError(
                    f"{fp}: checkpoint covers {int(z['layout_m_total'])} "
                    f"markers but this run analyzes {m_total} (changed "
                    f"--trunc-markers / dataset?) — marker state cannot "
                    f"be realigned.")
            by_it.setdefault(int(z["it"]), []).append(fp)

    chosen = None
    for it in sorted(by_it, reverse=True):
        covered = np.zeros(m_total, bool)
        for fp in by_it[it]:
            with np.load(fp) as z:
                for k in range(z["starts"].shape[0]):
                    s, ln = map(int, z["starts"][k])
                    covered[s:s + ln] = True
        if covered.all():
            chosen = it
            break
    if chosen is None:
        raise ValueError(
            f"no complete checkpoint era among {files} — every "
            f"iteration's save set leaves marker ranges uncovered")

    rep = n_rec = beta_acc = None
    it = chosen
    glob_arr = {}
    for fp in by_it[chosen]:
        with np.load(fp) as z:
            if rep is None:
                rep = {f: z[f] for f in _REPLICATED}
                n_rec = int(z["n_rec"])
            starts = z["starts"]
            for f in _SHARDED:
                for k in range(starts.shape[0]):
                    s, ln = map(int, starts[k])
                    d = z[f"{f}_{k}"]
                    if f not in glob_arr:
                        glob_arr[f] = np.zeros((d.shape[0], m_total),
                                               d.dtype)
                    glob_arr[f][:, s:s + ln] = d
            if "beta_acc" in z.files:
                if beta_acc is None:
                    beta_acc = np.zeros_like(z["beta_acc"])
                for k in range(starts.shape[0]):
                    s, ln = map(int, starts[k])
                    beta_acc[:, s:s + ln] = z["beta_acc"][:, s:s + ln]

    sharded_local = {}
    for f in _SHARDED:
        parts = []
        for k, i in enumerate(local_ids):
            s, ln = layout.blocks[i]
            d = glob_arr[f][:, s:s + ln]
            iv = data.inv_orders[k]
            if iv is not None:
                d = d[:, np.argsort(iv)]       # original -> stored order
            pad = np.zeros((d.shape[0], layout.m_pad_shard - ln), d.dtype)
            parts.append(np.concatenate([d, pad], axis=1))
        sharded_local[f] = np.concatenate(parts, axis=1)
    return rep, sharded_local, it, beta_acc, n_rec


def _local_concat(arr, local_ids, layout, axis, shards_per_id=None):
    """Concatenate this process's addressable shards of a marker-sharded
    global array back into the process-local layout that make_global
    expects (local_ids order, pad rows included)."""
    per = shards_per_id if shards_per_id is not None else layout.m_pad_shard
    shards = {sh.index[axis].start or 0: np.asarray(sh.data)
              for sh in arr.addressable_shards}
    return np.concatenate([shards[i * per] for i in local_ids], axis=axis)


def _sharded_cache_key(opt: Options, data, dtype, want_gram: bool,
                       n_shards: int, local_ids) -> str:
    """Content+geometry fingerprint for this PROCESS's startup artifacts
    (the sharded analog of runner._startup_cache_key): dataset content
    plus everything that changes the stored marker order, shard
    membership or array shapes.  A topology change (n_shards/local_ids)
    changes the key — stale caches can't be misread, they just miss."""
    import hashlib
    from gmrm_tpu.runner import hash_dataset_content
    h = hashlib.sha256()
    hash_dataset_content(h, opt)
    shared_na = all(ph.nas == 0 for ph in data.phens)
    h.update(repr((data.n, data.m_total, n_shards, tuple(local_ids),
                   data.layout.m_pad_shard, data.mb_pad, opt.block_size,
                   (opt.wave_size or 1) > 1, str(jnp.dtype(dtype)),
                   shared_na, want_gram)).encode())
    return h.hexdigest()[:32]


def run_training_sharded(opt: Options, n_devices: int = 0,
                         verbose: bool = True) -> RunResult:
    """The --process path over a marker-sharded device mesh.

    Works single-process (all shards local) and multi-process (call
    gmrm_tpu.parallel.distributed.init_distributed first; each process
    loads and writes only its own shards).
    """
    opt.validate()
    opt.resolve_compute_plan()
    if opt.cva is None:
        opt.load_group_mixtures()
    dtype = jnp.dtype(opt.dtype)

    mesh = make_marker_mesh(n_devices)
    d = mesh.devices.size
    local_ids = local_shard_ids(mesh)
    # Auto-downgrade wave when the SMALLEST shard has too few Gram
    # blocks for the relaxation's safety margin (before the interleave
    # decision — storage layout follows the resolved wave).
    n_pre, m_pre = read_dim(opt.dim_file)
    if opt.trunc_markers:
        m_pre = min(m_pre, opt.trunc_markers)
    opt.guard_wave_blocks(m_pre // d,
                          verbose=verbose and jax.process_index() == 0)
    data = load_data_process(opt, d, local_ids,
                             interleave=(opt.wave_size or 1) > 1)
    layout = data.layout

    shard1 = P(MARKER_AXIS)
    shard2 = P(None, MARKER_AXIS)
    rep = P()

    bed = make_global(mesh, shard1, data.bed_local)
    na = make_global(mesh, rep, np.asarray(data.na, dtype))
    nonas = make_global(mesh, rep, np.asarray(data.nonas, dtype))

    shared_na = all(ph.nas == 0 for ph in data.phens)
    want_gram = opt.wave_size > 1

    # --- per-process on-disk startup cache (--cache-dir).  Each process
    # persists ITS OWN shards' stats + Gram quadrants, keyed by dataset
    # content + sharded geometry (shard layout, local ids, interleave,
    # block size, dtype) — a topology change just misses the cache and
    # rebuilds.  Parity with runner.build_static's single-device cache.
    cache_path = None
    mave = msig = None
    gram_local_cached = None
    if opt.cache_dir:
        os.makedirs(opt.cache_dir, exist_ok=True)
        key = _sharded_cache_key(opt, data, dtype, want_gram, d, local_ids)
        cache_path = os.path.join(
            opt.cache_dir,
            f"startup_shard_p{jax.process_index()}_{key}.npz")
        # The warm/cold decision must be GLOBALLY AGREED: the cold path
        # runs collective shard_map builds that every process must enter
        # (multi-controller SPMD — a process skipping them deadlocks the
        # others), so all processes go warm only if ALL hold their file.
        local_warm = os.path.exists(cache_path)
        all_warm = local_warm
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            flags = multihost_utils.process_allgather(
                np.asarray([local_warm]))
            all_warm = bool(np.all(flags))
            if local_warm and not all_warm:
                print(f"INFO   : process {jax.process_index()} has a warm "
                      "startup cache but another process is cold — "
                      "rebuilding everywhere.")
        if all_warm:
            with np.load(cache_path) as z:
                mave = make_global(mesh, shard2, z["mave"], dtype)
                msig = make_global(mesh, shard2, z["msig"], dtype)
                if "gram" in z.files:
                    gram_local_cached = np.asarray(z["gram"])
            if verbose and jax.process_index() == 0:
                print(f"INFO   : warm sharded startup from {cache_path}")

    stats_cold = mave is None
    if stats_cold:
        stats_fn = jax.jit(
            jax.shard_map(
                lambda b, nn, no: marker_stats_jax(b, nn, no, dtype=dtype,
                                                   axis_name=MARKER_AXIS),
                mesh=mesh,
                in_specs=(shard1, rep, rep),
                out_specs=shard2,
            )
        )
        mave, msig = stats_fn(bed, na, nonas)
        # Zero the stats on pad rows (all-missing decode gives sb = 0 ->
        # NaN), using a sharded validity mask assembled process-locally.
        valid_local = np.zeros(len(local_ids) * layout.m_pad_shard, bool)
        for k, i in enumerate(local_ids):
            _, ln = layout.blocks[i]
            a = k * layout.m_pad_shard
            valid_local[a:a + ln] = True
        valid = make_global(mesh, shard1, valid_local)
        fix = jax.jit(
            jax.shard_map(
                lambda x, v: jnp.where(v[None, :], x, 0.0), mesh=mesh,
                in_specs=(shard2, shard1), out_specs=shard2,
            )
        )
        mave = fix(mave, valid)
        msig = fix(msig, valid)

    # Per-shard Gram cache: the sharded sweep's
    # per-block Gram is iteration-invariant under the block-preserving
    # shuffle exactly as on one device, so each shard precomputes its
    # natural blocks' raw quadrants once and the step's cached-Gram path
    # (gibbs.marker_sweep) consumes them — the per-block psum(delta eps)
    # cadence is unchanged.
    gram_cache = None
    if want_gram:
        if gram_local_cached is not None:
            gram_cache = make_global(mesh, P(MARKER_AXIS),
                                     gram_local_cached, np.float32)
        else:
            cache_fn = jax.jit(
                jax.shard_map(
                    partial(build_gram_cache, block_size=opt.block_size,
                            shared_na=shared_na),
                    mesh=mesh, in_specs=(shard1, rep),
                    out_specs=P(MARKER_AXIS),
                )
            )
            gram_cache = cache_fn(bed, na)

    if cache_path is not None and stats_cold:
        arrays = {
            "mave": _local_concat(mave, local_ids, layout, axis=1),
            "msig": _local_concat(msig, local_ids, layout, axis=1),
        }
        if gram_cache is not None and gram_local_cached is None:
            arrays["gram"] = _local_concat(
                gram_cache, local_ids, layout, axis=0,
                shards_per_id=layout.m_pad_shard // opt.block_size)
        tmp = f"{cache_path}.tmp.{os.getpid()}.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, cache_path)

    static = StaticInputs(
        gram_cache=gram_cache,
        bed=bed, na=na, mave=mave, msig=msig,
        group_of=make_global(mesh, shard1, data.group_local),
        mtotgrp=make_global(mesh, rep, data.mtotgrp),
        nonas=nonas,
        cva=make_global(mesh, rep, np.asarray(opt.cva, dtype)),
        cvai=make_global(mesh, rep, np.asarray(opt.cvai, dtype)),
        n_total=make_global(mesh, rep, np.asarray(float(data.n), dtype)),
        m_local=make_global(mesh, shard1, data.m_local_arr),
    )

    # --- initial sampler state (replicated leaves identical on every
    # process: same seed -> same draws, the reference's rank-0 Bcast).
    import jax.random as jr
    key = jr.PRNGKey(opt.seed)
    k_sg, _ = jr.split(key)
    t = len(data.phens)
    g, k = opt.cva.shape
    sigmag0 = np.asarray(beta_11(k_sg, (t, g), dtype=dtype))
    sigmag0 = np.where(data.mtotgrp[None, :] == 0, 0.0, sigmag0)

    n_local_pad = len(local_ids) * layout.m_pad_shard
    state = SamplerState(
        eps=make_global(mesh, rep, np.asarray(data.eps0, dtype)),
        betas=make_global(mesh, shard2, np.zeros((t, n_local_pad), dtype)),
        comp=make_global(mesh, shard2,
                         np.zeros((t, n_local_pad), np.int32)),
        acum=make_global(mesh, shard2, np.zeros((t, n_local_pad), dtype)),
        cass=make_global(mesh, rep, np.zeros((t, g, k), np.int32)),
        sigmag=make_global(mesh, rep, sigmag0.astype(dtype)),
        sigmae=make_global(mesh, rep, np.zeros((t,), dtype)),
        pi_est=make_global(
            mesh, rep,
            np.broadcast_to(pi_prior_from_cva(np.asarray(opt.cva)),
                            (t, g, k)).astype(dtype).copy()),
        mu=make_global(mesh, rep, np.zeros((t,), dtype)),
        epssum=make_global(mesh, rep, np.zeros((t,), dtype)),
        key=make_global(mesh, rep, np.asarray(key)),
    )

    step = make_sharded_step(mesh, block_size=opt.block_size,
                             shuffle=opt.shuffle_markers,
                             shared_na=shared_na,
                             wave_size=opt.wave_size,
                             with_cache=gram_cache is not None)

    # --- checkpoint/resume (parity with the single-device runner) --------
    beta_acc = np.zeros((t, data.m_total), np.float64)
    n_rec = 0
    start_it = 1
    ckpt = None
    if opt.out_dir and (opt.checkpoint_every or opt.resume):
        if jax.process_index() == 0:
            opt.ensure_out_dir()
        _sync_processes("ckpt-dir")
        ckpt = _ckpt_path(opt.out_dir)
    from gmrm_tpu.checkpoint import layout_of as _layout_of
    _storage = _layout_of(opt, m_total=data.m_total)
    # NOTE: the barrier condition must be identical on every process —
    # an os.path.isdir() in it would race against process 0 creating the
    # directory (measured: sync name mismatch), so only flags gate it.
    if not opt.resume and opt.out_dir:
        if jax.process_index() == 0 and os.path.isdir(opt.out_dir):
            _clear_ckpt_files(opt.out_dir)
        _sync_processes("ckpt-clear")
    ckpt_srcs = _ckpt_files(opt.out_dir) if (opt.resume and opt.out_dir) \
        else []
    resuming = bool(opt.resume and ckpt and ckpt_srcs)
    if opt.resume and not resuming and opt.out_dir:
        from gmrm_tpu.runner import _guard_resume_without_checkpoint
        _guard_resume_without_checkpoint(opt, data)
    if resuming:
        repv, shl, last_it, acc, n_rec = _load_sharded_checkpoint(
            ckpt_srcs, layout, local_ids, data, dtype,
            expect_storage=_storage)
        if acc is not None:
            beta_acc = acc
        start_it = last_it + 1
        state = SamplerState(
            eps=make_global(mesh, rep, repv["eps"], dtype),
            betas=make_global(mesh, shard2, shl["betas"], dtype),
            comp=make_global(mesh, shard2, shl["comp"], np.int32),
            acum=make_global(mesh, shard2, shl["acum"], dtype),
            cass=make_global(mesh, rep, repv["cass"], np.int32),
            sigmag=make_global(mesh, rep, repv["sigmag"], dtype),
            sigmae=make_global(mesh, rep, repv["sigmae"], dtype),
            pi_est=make_global(mesh, rep, repv["pi_est"], dtype),
            mu=make_global(mesh, rep, repv["mu"], dtype),
            epssum=make_global(mesh, rep, repv["epssum"], dtype),
            key=make_global(mesh, rep, repv["key"]),
        )
        if verbose and jax.process_index() == 0:
            print(f"INFO   : resuming sharded run from iteration {last_it}")

    outputs = ShardedOutputSet(opt, data, resume=resuming,
                               n_rec=n_rec if resuming else None)
    result = RunResult(state=state)

    # The reference's per-iteration "with sync time = ..." observable
    # (bayes.cpp:653-655).  Two measurement modes:
    #   verbosity 1 — standalone collective chain with the sweep's exact
    #     psum shapes/cadence (cheap; no extra step compile);
    #   verbosity >= 2 — differential IN-STEP measurement: the real step
    #     vs an identically-gated no-collectives compile on cloned state
    #     (measure_sync_seconds) — the true in-loop sync split, directly
    #     comparable to the reference's printed number.
    sync_est = None
    sync_how = ""
    if verbose and opt.verbosity_level(2):
        step_nosync = make_sharded_step(
            mesh, block_size=opt.block_size,
            shuffle=opt.shuffle_markers, shared_na=shared_na,
            wave_size=opt.wave_size, with_cache=gram_cache is not None,
            sync=False)
        sync_est, t_w, t_wo = measure_sync_seconds(
            step, step_nosync, state, static)
        sync_how = "in-step differential"
        if jax.process_index() == 0:
            print(f"INFO   : measured in-step sync cost = "
                  f"{sync_est * 1000:.3f} ms/iteration "
                  f"({t_w * 1000:.3f} with collectives, "
                  f"{t_wo * 1000:.3f} elided)")
    elif verbose and opt.verbosity_level(1):
        nblocks_sync = layout.m_pad_shard // opt.block_size
        g, k = opt.cva.shape
        sync_est = estimate_sync_seconds(
            mesh, nblocks_sync, len(data.phens), data.mb_pad, g, k, dtype)
        sync_how = "standalone collective chain"
        if jax.process_index() == 0:
            print(f"INFO   : measured collective sync cost = "
                  f"{sync_est * 1000:.3f} ms/iteration "
                  f"({nblocks_sync} psums of {len(data.phens)}x4x"
                  f"{data.mb_pad} f32)")

    # Iterations are dispatched back-to-back without per-iteration host
    # syncs (parity with the single-device runner).  Hosts sync at
    # thin/checkpoint boundaries.
    t_chain = time.perf_counter()
    for it in range(start_it, opt.iterations + 1):
        t0 = time.perf_counter()
        state, aux = step(state, static, jnp.asarray(it, jnp.int32))
        if it % opt.output_thin_rate == 0:
            rec = it // opt.output_thin_rate - 1
            sigmag = np.asarray(jax.device_get(state.sigmag), np.float64)
            sigmae = np.asarray(jax.device_get(state.sigmae), np.float64)
            check_finite_chain(sigmag, sigmae, it)
            pi = np.asarray(jax.device_get(state.pi_est), np.float64)
            m0_sum = np.asarray(jax.device_get(aux.m0)).sum(axis=1)
            bsl = local_marker_slices(state.betas, layout, local_ids)
            csl = local_marker_slices(state.comp, layout, local_ids)

            def orig(d, k):
                iv = data.inv_orders[k]
                return d if iv is None else d[:, iv]

            bsl = [(s, ln, orig(d, k)) for k, (s, ln, d) in enumerate(bsl)]
            csl = [(s, ln, orig(d, k)) for k, (s, ln, d) in enumerate(csl)]
            beta_slices = [[(s, ln, d[ti]) for (s, ln, d) in bsl]
                           for ti in range(t)]
            comp_slices = [[(s, ln, d[ti]) for (s, ln, d) in csl]
                           for ti in range(t)]
            outputs.write_thinned(rec, it, (sigmag, sigmae, pi), m0_sum,
                                  beta_slices, comp_slices)
            for ti in range(t):
                for s, ln, dslice in beta_slices[ti]:
                    beta_acc[ti, s:s + ln] += dslice
            n_rec += 1
            if verbose and jax.process_index() == 0:
                sg_sum = sigmag.sum(axis=1)
                for ti in range(t):
                    print(f"RESULT : i:{it} p:{ti}  sum sigmaG = "
                          f"{sg_sum[ti]:20.15f}  sigmaE = "
                          f"{sigmae[ti]:20.15f}")
        # Per-iteration sync+print costs a host round-trip; it rides
        # --verbosity >= 1 (see runner.run_training).
        if verbose and opt.verbosity_level(1):
            jax.block_until_ready(state.sigmae)
            dt = time.perf_counter() - t0
            if jax.process_index() == 0:
                print(f"RESULT : It {it}  total proc time = {dt:7.3f} sec, "
                      f"with sync time = {sync_est:7.3f} sec (measured "
                      f"{sync_how})")
        else:
            dt = time.perf_counter() - t0
        result.iter_seconds.append(dt)
        if ckpt and opt.checkpoint_every and it % opt.checkpoint_every == 0:
            _save_sharded_checkpoint(ckpt, state, it, layout, local_ids,
                                     beta_acc, n_rec, storage=_storage,
                                     inv_orders=data.inv_orders)

    jax.block_until_ready(state.sigmae)
    check_finite_chain(jax.device_get(state.sigmag),
                       jax.device_get(state.sigmae), opt.iterations)
    result.chain_seconds = time.perf_counter() - t_chain
    result.iters_run = opt.iterations - start_it + 1
    result.state = state
    if n_rec:
        # beta_acc holds only this process's marker ranges; complete for
        # single-process runs, per-process partial otherwise.
        result.beta_mean = beta_acc / n_rec
    return result
