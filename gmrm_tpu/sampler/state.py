"""Functional sampler state pytrees.

The reference scatters this state across the mutable ``Phenotype`` /
``Bayes`` objects (``src/phenotype.hpp:12-262``, ``src/bayes.hpp:82-105``);
here it is one immutable pytree threaded through a jitted iteration, with a
leading trait axis T (the reference's serial phenotype loop is a batch
axis, SURVEY §2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from gmrm_tpu.io.bed import MISSING_BYTE


def _pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree (every field a data
    leaf), with ``replace`` returning a copy with some fields changed."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)


@_pytree_dataclass
class SamplerState:
    """Per-device sampler state.  Marker-axis leaves are local shards."""
    eps: jnp.ndarray        # (T, 4, mb) residual phase planes (replicated)
    betas: jnp.ndarray      # (T, M_pad) local marker effects
    comp: jnp.ndarray       # (T, M_pad) int32 component assignment
    acum: jnp.ndarray       # (T, M_pad) stored CDF value at selection
    cass: jnp.ndarray       # (T, G, K) int32 component counts (global after psum)
    sigmag: jnp.ndarray     # (T, G)
    sigmae: jnp.ndarray     # (T,)
    pi_est: jnp.ndarray     # (T, G, K)
    mu: jnp.ndarray         # (T,)
    epssum: jnp.ndarray     # (T,) reference quirk: stays 0 (phenotype.hpp:52)
    key: jnp.ndarray        # base PRNG key (replicated)


@_pytree_dataclass
class StaticInputs:
    """Per-device non-evolving inputs."""
    bed: jnp.ndarray        # (M_pad, mb) uint8, pad rows = 0x55 (all missing)
    na: jnp.ndarray         # (T, 4, mb) 0/1 observed masks
    mave: jnp.ndarray       # (T, M_pad)
    msig: jnp.ndarray       # (T, M_pad)  (0 on pad rows)
    group_of: jnp.ndarray   # (M_pad,) int32 group per local marker (0 on pads)
    mtotgrp: jnp.ndarray    # (G,) int32 global markers per group
    nonas: jnp.ndarray      # (T,) float
    cva: jnp.ndarray        # (G, K)
    cvai: jnp.ndarray       # (G, K)
    n_total: jnp.ndarray    # () float: the dims N
    m_local: jnp.ndarray    # () int32: real (unpadded) local marker count
    # Optional precomputed per-natural-block raw Gram quadrants
    # (nblocks, NT, 2B, 2B) f32 for the wave sweep: X does not change
    # across iterations and block membership is fixed under the
    # block-preserving shuffle, so the O(M N B) Gram recompute becomes an
    # O(M B) cache load + row/column permute (ops/blockops.py
    # build_gram_cache).
    gram_cache: Optional[jnp.ndarray] = None


def pad_markers(arr: np.ndarray, m_pad: int, fill) -> np.ndarray:
    m = arr.shape[0]
    if m == m_pad:
        return arr
    pad_shape = (m_pad - m,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)


def pad_bed(bed: np.ndarray, m_pad: int, mb_pad: Optional[int] = None) -> np.ndarray:
    """Pad a bed shard with all-missing bytes on both axes.

    0x55 decodes to a=b=0, so padded markers/columns contribute exactly 0 to
    every reduction without extra masking.
    """
    m, mb = bed.shape
    if mb_pad is None:
        mb_pad = mb
    out = np.full((m_pad, mb_pad), MISSING_BYTE, dtype=np.uint8)
    out[:m, :mb] = bed
    return out


def init_state(
    key,
    n_traits: int,
    m_pad: int,
    mb: int,
    n_groups: int,
    n_mixtures: int,
    eps0,                   # (T, 4, mb) initial residual (centered/scaled phen)
    pi_prior,               # (G, K)
    sigmag0,                # (T, G) initial draws (Beta(1,1), 0 for empty groups)
    dtype=jnp.float32,
) -> SamplerState:
    t = n_traits
    return SamplerState(
        eps=jnp.asarray(eps0, dtype),
        betas=jnp.zeros((t, m_pad), dtype),
        comp=jnp.zeros((t, m_pad), jnp.int32),
        acum=jnp.zeros((t, m_pad), dtype),
        cass=jnp.zeros((t, n_groups, n_mixtures), jnp.int32),
        sigmag=jnp.asarray(sigmag0, dtype),
        sigmae=jnp.zeros((t,), dtype),
        pi_est=jnp.broadcast_to(jnp.asarray(pi_prior, dtype),
                                (t, n_groups, n_mixtures)).copy(),
        mu=jnp.zeros((t,), dtype),
        epssum=jnp.zeros((t,), dtype),
        key=key,
    )


def pi_prior_from_cva(cva: np.ndarray) -> np.ndarray:
    """Mixture-probability prior from the variance grid.

    Reference bayes.hpp:34-47: pi0 = 0.5, pi_k = 0.5*cva_k/sum_{j>=1} cva_j.
    """
    g, k = cva.shape
    pi = np.full((g, k), 0.5)
    ssum = cva[:, 1:].sum(axis=1)
    pi[:, 1:] = 0.5 * cva[:, 1:] / ssum[:, None]
    return pi
