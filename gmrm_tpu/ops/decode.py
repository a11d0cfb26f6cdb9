"""2-bit PLINK genotype decode and the phase-plane device layout.

The reference decodes bed bytes through 256-entry lookup tables
(``src/dotp_lut.hpp``, generated by ``src/lut/mk_lut.cpp:25-65``).  Here
the decode is arithmetic, with shifts and masks that XLA can fuse into the
consuming matrix products instead of a gather per byte.

Phase-plane layout: a packed byte j holds individuals ``4j+k`` in bits
``2k..2k+1``.  Unpacking to standard individual order would interleave the
four codes of every byte (a relayout pass), so all device-side
individual-axis vectors (residuals, NA masks) are stored as
``(4, mbytes)`` *phase planes*: plane k holds
individuals ``k, 4+k, 8+k, ...``.  Every consumer reduces over individuals,
so the permutation is semantically invisible; host I/O converts at the
boundary with to/from_phase_planes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def phase_pad_len(n: int) -> int:
    """mbytes = ceil(N/4): individuals per phase plane."""
    return (n + 3) // 4


def to_phase_planes(v: np.ndarray, mbytes: int | None = None) -> np.ndarray:
    """(..., Np) standard order -> (..., 4, mbytes) phase planes (host side).

    Np must already be padded to a multiple of 4 (use Phenotype helpers).
    """
    npad = v.shape[-1]
    assert npad % 4 == 0, "pad individuals to a multiple of 4 first"
    mb = npad // 4
    if mbytes is not None:
        assert mb == mbytes
    out = v.reshape(*v.shape[:-1], mb, 4)
    return np.moveaxis(out, -1, -2)


def from_phase_planes(p: np.ndarray) -> np.ndarray:
    """(..., 4, mbytes) phase planes -> (..., 4*mbytes) standard order."""
    x = np.moveaxis(np.asarray(p), -2, -1)
    return x.reshape(*x.shape[:-2], -1)


def decode_planes_jax(bed: jnp.ndarray, dtype=jnp.float32):
    """Decode packed bytes (..., mbytes) uint8 -> (a, b) planes
    (..., 4, mbytes) in phase layout.

    Code semantics (mk_lut.cpp:25-36): 00 -> a=2,b=1; 01(missing) -> a=0,b=0;
    10 -> a=1,b=1; 11 -> a=0,b=1.  Arithmetic form: with c the 2-bit code,
    b = (c != 1), a = b * (2 - ((c + 1) >> 1))  [c=0 -> 2, c=2 -> 1, c=3 -> 0].
    """
    bed = bed.astype(jnp.uint8)
    codes = jnp.stack(
        [(bed >> (2 * k)) & 0x3 for k in range(4)], axis=-2
    )  # (..., 4, mbytes) uint8, plane k = individuals k, 4+k, ...
    c = codes.astype(jnp.int32)
    b = (c != 1)
    a = jnp.where(b, 2 - ((c + 1) >> 1), 0)
    return a.astype(dtype), b.astype(dtype)
