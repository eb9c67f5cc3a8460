"""Per-pixel variance buffers and adaptive block sampling.

Counterpart of reference ``Kernel/PixelVarianceBuffer.{h,cu}`` (online E/Var of
luminance + half-buffer error metric, PixelVarianceBuffer.h:53-59) and the
block samplers (``Kernel/BlockSampler/``): image split into blocks, per-block
pass weights from λ·(avg estimator stddev) + (1-λ)·(block color variance)
(VarianceBlockSampler.h:44-56) or half-buffer differences
(DifferenceBlockSampler). Here the "blocks to render this pass" become a
per-pixel *sample-count array* consumed by the wavefront generate stage —
adaptive effort with static shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

BLOCK = 16  # block edge in pixels (reference uses 128-px blocks of 16x8 threads)

UNIFORM = 0
VARIANCE = 1
DIFFERENCE = 2
SELECT = 3


class VarianceBuffer(NamedTuple):
    """Online per-pixel moments of the luminance estimator + half buffers."""

    mean: jnp.ndarray      # (H, W) running mean of luminance
    m2: jnp.ndarray        # (H, W) running sum of squared deviations (Welford)
    n: jnp.ndarray         # (H, W) sample counts
    half_a: jnp.ndarray    # (H, W, 3) even-pass accumulator
    half_b: jnp.ndarray    # (H, W, 3) odd-pass accumulator
    n_a: jnp.ndarray       # ()
    n_b: jnp.ndarray       # ()

    @staticmethod
    def create(height: int, width: int) -> "VarianceBuffer":
        z = jnp.zeros((height, width), jnp.float32)
        z3 = jnp.zeros((height, width, 3), jnp.float32)
        return VarianceBuffer(z, z, z, z3, z3, jnp.zeros(()), jnp.zeros(()))


def add_pass(vb: VarianceBuffer, pass_image, pass_idx,
             mask=None) -> VarianceBuffer:
    """Accumulate one pass's per-pixel radiance image (Welford update).

    `mask` (H, W) bool: pixels that actually received samples this pass
    (adaptive sampling leaves low-variance pixels un-sampled some passes);
    un-sampled pixels hold their moments unchanged."""
    lum = (
        0.212671 * pass_image[..., 0]
        + 0.715160 * pass_image[..., 1]
        + 0.072169 * pass_image[..., 2]
    )
    if mask is None:
        mask = jnp.ones(lum.shape, bool)
    n = vb.n + jnp.where(mask, 1.0, 0.0)
    delta = jnp.where(mask, lum - vb.mean, 0.0)
    mean = vb.mean + delta / jnp.maximum(n, 1.0)
    m2 = vb.m2 + delta * jnp.where(mask, lum - mean, 0.0)
    even = (pass_idx % 2) == 0
    upd = jnp.where(mask[..., None], pass_image, 0.0)
    half_a = jnp.where(even, vb.half_a + upd, vb.half_a)
    half_b = jnp.where(even, vb.half_b, vb.half_b + upd)
    return VarianceBuffer(
        mean=mean, m2=m2, n=n,
        half_a=half_a, half_b=half_b,
        n_a=vb.n_a + jnp.where(even, 1.0, 0.0),
        n_b=vb.n_b + jnp.where(even, 0.0, 1.0),
    )


def pixel_variance(vb: VarianceBuffer):
    """Variance of the per-pass estimator (not of the mean)."""
    return vb.m2 / jnp.maximum(vb.n - 1.0, 1.0)


def half_buffer_error(vb: VarianceBuffer):
    """Relative half-buffer error metric ("Hierarchical Automatic Stopping",
    PixelVarianceBuffer.h:53-59)."""
    a = vb.half_a / jnp.maximum(vb.n_a, 1.0)
    b = vb.half_b / jnp.maximum(vb.n_b, 1.0)
    num = jnp.sum(jnp.abs(a - b), axis=-1)
    den = jnp.sqrt(jnp.maximum(jnp.sum(a + b, axis=-1), 1e-6))
    return num / den


def _block_reduce(x, block: int = BLOCK):
    H, W = x.shape
    hb, wb = H // block, W // block
    return x[: hb * block, : wb * block].reshape(hb, block, wb, block).mean((1, 3))


def block_weights(vb: VarianceBuffer, mode: int = VARIANCE, lam: float = 0.5,
                  block: int = BLOCK, rect=None):
    """Per-block sampling weights, normalized to mean 1 (the reference's
    per-block pass-count logic, IBlockSampler.h:18). `rect` = (x0, y0, x1, y1)
    pixel rect for SELECT mode (reference SelectBlockSampler)."""
    H, W = vb.mean.shape
    if mode == UNIFORM:
        return jnp.ones((H // block, W // block), jnp.float32)
    if mode == SELECT:
        x0, y0, x1, y1 = rect if rect is not None else (0, 0, W, H)
        bx = jnp.arange(W // block) * block
        by = jnp.arange(H // block) * block
        inx = (bx + block > x0) & (bx < x1)
        iny = (by + block > y0) & (by < y1)
        w = (iny[:, None] & inx[None, :]).astype(jnp.float32) + 1e-3
        return w / jnp.maximum(jnp.mean(w), 1e-9)
    if mode == VARIANCE:
        est_std = jnp.sqrt(pixel_variance(vb)) / jnp.maximum(vb.mean, 1e-3)
        color_var = pixel_variance(vb)
        w = lam * _block_reduce(est_std, block) + (1 - lam) * _block_reduce(color_var, block)
    else:  # DIFFERENCE
        w = _block_reduce(half_buffer_error(vb), block)
    w = jnp.maximum(w, 1e-6)
    return w / jnp.maximum(jnp.mean(w), 1e-9)


def per_pixel_spp(vb: VarianceBuffer, base_spp: int, mode: int = VARIANCE,
                  max_factor: float = 4.0, block: int = BLOCK):
    """Expand block weights to an integer per-pixel spp map for the next pass."""
    w = block_weights(vb, mode, block=block)
    w = jnp.clip(w, 1.0 / max_factor, max_factor)
    spp = jnp.round(w * base_spp).astype(jnp.int32)
    spp = jnp.maximum(spp, 1)
    return jnp.repeat(jnp.repeat(spp, block, axis=0), block, axis=1)
