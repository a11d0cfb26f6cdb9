"""gmrm_tpu — accelerator-native Bayesian grouped mixture-of-regressions
(GWAS) framework.

A from-scratch JAX/XLA re-design of the capabilities of the
``medical-genomics-group/gmrm`` hybrid-parallel C++ program: a BayesR-family
Gibbs sampler over PLINK 2-bit ``.bed`` genotype matrices, with
multi-trait support, marker-sharded multi-device execution, and a
posterior-prediction (``--predict``) mode producing ``.mlma`` association
statistics.

Architecture:

- The reference's per-marker serial sweep (LUT dot product + rank-1 residual
  update, both O(N); ``src/bayes.cpp:709``, ``src/phenotype.cpp:326``) is
  restructured as an *exact* blocked Gram-matrix sweep: for a block of B
  markers, ``c = X_blk @ eps`` and ``G = X_blk @ X_blk.T`` are bf16 matrix
  products with the 2-bit decode fused in (the Gram built once and cached);
  the scan inside a block only needs
  ``num_j = c_j + sum_{i<j} G_ji * dbeta_i`` (tiny), and one matvec applies
  the accumulated residual update per block.
- Marker-axis distribution (the reference's MPI rank axis,
  ``src/bayes.cpp:903``) maps to a 1-D ``jax.sharding.Mesh`` with
  ``shard_map``; the per-step ``MPI_Allgatherv`` replay protocol
  (``src/bayes.cpp:500-545``) becomes a ``psum`` of the length-N residual
  delta at block cadence.
- RNG is counter-based ``jax.random`` keyed by (iteration, device), so one
  compilation serves the whole chain.
"""

__version__ = "0.1.0"

from gmrm_tpu.config import Options
