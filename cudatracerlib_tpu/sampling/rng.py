"""Counter-based stateless RNG for Monte-Carlo sampling.

Replacement for the reference's curand / sequence samplers
(Base/CudaRandom.h, Kernel/Sampler_device.h:120-169). Instead of mutable
per-pixel RNG state we derive every sample from a hash of
(seed, pixel_id, sample_index, dimension) — stateless, replay-stable across
recomputation (which `jax.checkpoint`/rematerialization requires) and trivially
shardable. Quality is PCG-RXS-M-XS-32 grade, the standard choice in production
GPU renderers.

The functional `Sampler` mirrors the reference's `Sampler` draw-sequence API:
each `next_1d/next_2d` advances a Weyl-sequence counter and hashes it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

_GOLDEN = jnp.uint32(0x9E3779B9)  # 2^32 / phi, Weyl increment


def _u(x):
    return jnp.asarray(x).astype(jnp.uint32)


def pcg_hash(x):
    """PCG-RXS-M-XS-32 output function over an LCG step; uint32 -> uint32."""
    x = _u(x)
    state = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((state >> ((state >> 28) + jnp.uint32(4))) ^ state) * jnp.uint32(277803737)
    return (word >> 22) ^ word


def hash_combine(a, b):
    """Boost-style hash combine on uint32."""
    a = _u(a)
    b = _u(b)
    return a ^ (pcg_hash(b) + _GOLDEN + (a << 6) + (a >> 2))


def uint_to_unit_float(x):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (_u(x) >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


class Sampler(NamedTuple):
    """Stateless sample stream: state is a uint32 array (one per lane)."""

    state: jnp.ndarray

    @staticmethod
    def create(seed, pixel_id, sample_index) -> "Sampler":
        s = hash_combine(hash_combine(_u(seed), _u(pixel_id)), _u(sample_index))
        return Sampler(state=s)

    def next_1d(self) -> Tuple["Sampler", jnp.ndarray]:
        state = self.state + _GOLDEN
        return Sampler(state=state), uint_to_unit_float(pcg_hash(state))

    def next_2d(self) -> Tuple["Sampler", jnp.ndarray]:
        s1 = self.state + _GOLDEN
        s2 = s1 + _GOLDEN
        u = jnp.stack(
            [uint_to_unit_float(pcg_hash(s1)), uint_to_unit_float(pcg_hash(s2))],
            axis=-1,
        )
        return Sampler(state=s2), u


def stratified_offsets(n_x: int, n_y: int, dtype=jnp.float32):
    """(n_x*n_y, 2) stratum origins for stratified pixel sampling
    (reference StratifiedSequenceGenerator, Kernel/Sampler.h:84-118)."""
    ix = jnp.arange(n_x, dtype=dtype)
    iy = jnp.arange(n_y, dtype=dtype)
    gx, gy = jnp.meshgrid(ix, iy, indexing="ij")
    return jnp.stack([gx.ravel() / n_x, gy.ravel() / n_y], axis=-1)
