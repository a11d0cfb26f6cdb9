from gmrm_tpu.ops.decode import (
    decode_planes_jax,
    to_phase_planes,
    from_phase_planes,
    phase_pad_len,
)
from gmrm_tpu.ops.blockops import (
    block_cdot,
    block_eps_update,
    block_gram,
    build_gram_cache,
    marker_stats_jax,
)
