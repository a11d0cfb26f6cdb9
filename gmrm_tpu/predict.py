"""Posterior prediction / association statistics (the reference's
``--predict`` mode, ``src/bayes.cpp:16-284``).

Per phenotype:

1. validate the ``.bet`` chain header against the reference-panel bim
   (the reference's own check, ``bayes.cpp:47-55``) and report niter;
2. residualize: y_k = y_centered_scaled - (g - g_k) — with the pinned
   1-rank semantics g_k == g so y_k == y, exactly the reference's
   1-rank behavior (``bayes.cpp:138-147``), which makes the genetic
   value g (= X_std @ posterior-mean beta, ``bayes.cpp:93-125``) cancel
   out of EVERY output field — so neither it, the chain average, nor
   the marker stats are computed at all (field-level parity vs the
   compiled reference verified, benchmarking/predict_parity.py);
   sigma = sum(y_k^2)/nonas;
3. per-marker OLS on *uncentered* dosages (a*b*na — a faithful reference
   quirk, ``bayes.cpp:191-205``): beta = xty/xtx, t = xty/sqrt(sigma*xtx),
   se = beta/t, p = 1 - P(1/2, t^2/2);
4. fixed-width ``.mlma`` lines, markers absent from the reference bim
   excluded (``bayes.cpp:223-254``).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from gmrm_tpu.config import Options
from gmrm_tpu.io.bed import read_bed
from gmrm_tpu.io.bim import read_bim_ids, bim_id_index
from gmrm_tpu.io.grouping import read_dim
from gmrm_tpu.io.phen import read_phen
from gmrm_tpu.io.writers import format_mlma_line
from gmrm_tpu.ops.decode import decode_planes_jax, to_phase_planes
from gmrm_tpu.ops.blockops import _PREC
from gmrm_tpu.runner import stem


def _predict_sums_scan(bed_p, na, y_planes, *, dtype):
    """The fused scan over marker chunks (pure; jitted via
    _predict_sums_jit for the single-device path so repeated calls —
    per trait, per run — hit the jit cache instead of recompiling:
    closing over na/y_planes as constants caused a ~3 s XLA recompile
    per trait).

    Only (xtx, xty) on uncentered dosages survive: under the pinned
    1-rank residualization (y_k == y, bayes.cpp:138-147) the genetic
    value g — and therefore the posterior-mean betas and marker stats
    feeding it — cancels out of every output field, so computing it was
    pure waste (code-review r5: ~1/3 of predict FLOPs plus a full .bet
    chain read per trait, for a value never consumed)."""
    def body(carry, bed_c):
        a, b = decode_planes_jax(bed_c, dtype=dtype)       # (chunk, 4, mb)
        val = a * b * na[None]                             # uncentered dosage
        xtx = jnp.einsum("ckm,ckm->c", val, val,
                         preferred_element_type=dtype, precision=_PREC)
        xty = jnp.einsum("ckm,km->c", val, y_planes,
                         preferred_element_type=dtype, precision=_PREC)
        return carry, (xtx, xty)

    _, (xtx, xty) = jax.lax.scan(body, 0, bed_p)
    return xtx, xty


@functools.partial(jax.jit, static_argnames=("dtype",))
def _predict_sums_jit(bed_p, na, y_planes, dtype):
    return _predict_sums_scan(bed_p, na, y_planes, dtype=dtype)


def _chunked_predict_sums(bed, na, y_planes, dtype=jnp.float32, chunk=512,
                          inside_jit=False):
    """Per-marker (xtx, xty) on uncentered dosages against y_k.

    ``inside_jit``: called under an enclosing jit/shard_map (skip the
    caching jit wrapper — tracing through it would be a no-op anyway,
    the flag just keeps the call structure explicit)."""
    m, mb = bed.shape
    n_chunks = -(-m // chunk)
    m_pad = n_chunks * chunk
    pad = m_pad - m

    bed_p = jnp.concatenate(
        [jnp.asarray(bed),
         jnp.full((pad, mb), 0x55, jnp.uint8)]).reshape(n_chunks, chunk, mb)
    if inside_jit:
        xtx, xty = _predict_sums_scan(bed_p, na, y_planes, dtype=dtype)
    else:
        xtx, xty = _predict_sums_jit(bed_p, na, y_planes, dtype=dtype)
    return xtx.reshape(-1)[:m], xty.reshape(-1)[:m]


def _check_bet_and_niter(bet_path: str, expect_mtot: int) -> int:
    """Validate the .bet header Mtot against the REFERENCE-panel bim
    size and return the recorded iteration count — the reference's own
    check and abort (``bayes.cpp:47-55``: ``Mtot_ != m_refrsid.size()``
    -> MPI_Abort), which is deliberately NOT the analysis panel's
    m_total: the reference's predict workflow requires the trained
    panel (= ref bim) to frame the .bet.  Header-only reads; the chain
    itself is never loaded (the posterior-mean betas cancel out of
    every output under the 1-rank residualization)."""
    from gmrm_tpu.io.writers import history_mtot
    mtot = history_mtot(bet_path)
    if mtot != expect_mtot:
        raise IOError(
            f"Mismatch between expected and Mtot read from .bet file: "
            f"{expect_mtot} vs {mtot}"
        )
    rec_bytes = 4 + mtot * 8
    size = os.path.getsize(bet_path)
    if (size - 4) % rec_bytes != 0:
        # Same consistency check the chain readers enforce (a crash
        # mid-record-write leaves a ragged tail); the reference asserts
        # this too (bayes.cpp:53).
        raise IOError(
            f"{bet_path}: size {size} not consistent with Mtot={mtot}")
    return (size - 4) // rec_bytes


def _sharded_predict_sums(bed, na, y_planes, n_devices, dtype=jnp.float32):
    """The OLS-sums pass over a marker-sharded device mesh.  Per-marker
    sums never cross shards, so the outputs are byte-identical to the
    single-device pass.  The bed transfers as per-shard pieces via an
    explicit NamedSharding device_put — staging the whole padded bed on
    one device first would defeat the sharded memory model at
    production scale (code-review r5)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gmrm_tpu.parallel.mesh import MARKER_AXIS, make_marker_mesh

    mesh = make_marker_mesh(n_devices)
    d = mesh.devices.size
    m, mb = bed.shape
    m_pad = -(-m // d) * d
    pad = m_pad - m

    bed_p = np.concatenate(
        [bed, np.full((pad, mb), 0x55, np.uint8)], axis=0)

    sh = P(MARKER_AXIS)
    rep = P()
    fn = jax.jit(jax.shard_map(
        lambda bed_s, na_r, y_r: _chunked_predict_sums(
            bed_s, na_r, y_r, dtype=dtype, inside_jit=True),
        mesh=mesh,
        in_specs=(sh, rep, rep),
        out_specs=(sh, sh),
    ))
    bed_d = jax.device_put(bed_p, NamedSharding(mesh, sh))
    xtx, xty = fn(bed_d, na, y_planes)
    return np.asarray(xtx)[:m], np.asarray(xty)[:m]


def run_predict(opt: Options, verbose: bool = True):
    """Produce <out_dir>/<phen-stem>.mlma for every phenotype.

    Runs marker-sharded over all visible devices (reference predict is
    MPI-parallel the same way, bayes.cpp:93-136); a single device gives
    the identical bytes.

    Multi-process: each process handles its contiguous marker block
    (reference per-rank partition, bayes.cpp:903-925) — it reads only its
    .bed and .bet slices and writes its own fixed-width .mlma line range
    at the exact byte offsets (the reference's per-rank
    MPI_File_write_at with Allgathered line counts, bayes.cpp:223-254).
    Per-marker statistics never cross markers and y_k == y in the 1-rank
    semantics (below), so the bytes are identical for any process count.
    """
    opt.validate()
    n, m_total = read_dim(opt.dim_file)
    if opt.trunc_markers:
        m_total = min(m_total, opt.trunc_markers)
    rsid = read_bim_ids(opt.bim_file)
    ref_idx = bim_id_index(opt.ref_bim_file)

    nproc = jax.process_count()
    pid = jax.process_index()
    if nproc > 1:
        from gmrm_tpu.parallel.mesh import marker_blocks
        s0, m_loc = marker_blocks(m_total, nproc)[pid]
    else:
        s0, m_loc = 0, m_total

    bed = read_bed(opt.bed_file, n, m_total, s0, m_loc)
    dtype = jnp.dtype(opt.dtype)
    n_dev = opt.n_devices or len(jax.local_devices())

    # Reference-panel membership over ALL markers (every process reads the
    # small .bim files): line numbers in the .mlma are global prefix
    # counts of kept markers, the Allgathered offsets of bayes.cpp:237-247.
    keep_all = np.array([rid in ref_idx for rid in rsid[:m_total]])
    rmglo_all = np.array([ref_idx.get(rid, -1) for rid in rsid[:m_total]])
    line_no = np.cumsum(keep_all) - 1                  # global line index
    n_keep = int(keep_all.sum())
    keep = keep_all[s0:s0 + m_loc]
    rmglo = rmglo_all[s0:s0 + m_loc]

    from gmrm_tpu.io.writers import MLMA_LINE_LEN
    from gmrm_tpu.parallel.runner import _sync_processes

    for phen_path in opt.phen_files:
        ph = read_phen(phen_path, n)
        base = os.path.join(opt.out_dir, stem(phen_path))
        bet_path = base + ".bet"
        niter = _check_bet_and_niter(bet_path, len(ref_idx))
        if verbose and pid == 0:
            print(f"INFO   : Number of recorded iterations in .bet file: "
                  f"{niter}")

        na = jnp.asarray(to_phase_planes(ph.na_vector_padded()), dtype)
        y = ph.epsilon_padded()                             # centered+scaled
        y_planes = jnp.asarray(to_phase_planes(y), dtype)

        if n_dev > 1 and nproc == 1:
            xtx, xty = _sharded_predict_sums(
                bed, na, y_planes, n_devices=opt.n_devices, dtype=dtype)
        else:
            # nproc > 1: each process handles its marker slice on its
            # default device; further sharding the slice over additional
            # local devices is possible but unimplemented.
            xtx, xty = _chunked_predict_sums(bed, na, y_planes,
                                             dtype=dtype)
        # Single shard: g_k == g, so y_k = y (reference 1-rank behavior;
        # the sharded/multi-process passes keep the same semantics so
        # outputs are byte-identical across layouts).
        sigma = float(np.asarray(y) @ np.asarray(y)) / ph.nonas

        # ONE stacked device fetch per trait (each fetched array costs a
        # device sync), then float64 OLS on the
        # host like the reference (bayes.cpp:191-205).
        xx = np.asarray(jnp.stack([xtx, xty]), np.float64)
        xtx, xty = xx[0], xx[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = xty / xtx
            tdist = xty / np.sqrt(sigma * xtx)
            se = beta / tdist
        # p = 1 - P(1/2, t^2/2) = erfc(|t|/sqrt(2)) exactly (the
        # reference evaluates the same regularized gamma via boost,
        # bayes.cpp:202-205); math.erfc gives it in float64 with no
        # device round-trip.
        import math
        erfc_v = np.frompyfunc(math.erfc, 1, 1)
        with np.errstate(invalid="ignore"):
            pval = erfc_v(np.abs(tdist) / np.sqrt(2.0)).astype(np.float64)
        pval = np.where(np.isfinite(tdist), pval, np.nan)

        mlma_path = base + ".mlma"
        if pid == 0:
            if os.path.exists(mlma_path):
                os.remove(mlma_path)
            with open(mlma_path, "wb") as fh:
                fh.truncate(n_keep * MLMA_LINE_LEN)
        _sync_processes("mlma-create")
        with open(mlma_path, "r+b") as fh:
            for jl in range(m_loc):
                j = s0 + jl
                if not keep[jl]:
                    print(f"WARNING: marker id {rsid[j]} excluded -- "
                          f"no match")
                    continue
                fh.seek(int(line_no[j]) * MLMA_LINE_LEN)
                fh.write(format_mlma_line(
                    rsid[j], j, int(rmglo[jl]), beta[jl], tdist[jl],
                    se[jl], pval[jl]).encode())
        _sync_processes("mlma-done")
        if verbose and pid == 0:
            print(f"INFO   : wrote {n_keep} markers to {mlma_path}")
