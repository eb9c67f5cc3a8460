"""Film: sample accumulation and splatting.

Counterpart of reference ``Engine/Image.{h,cu}`` — the 3-stage film
(PixelData{rgb, rgbSplat, weightSum} accumulated with atomics,
Engine/Image.cu:22-66). Here the atomics become deterministic scatter-adds
(`.at[].add`), which XLA lowers to sorted segment sums — bitwise reproducible
across replays, which the gradient tests rely on.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Film(NamedTuple):
    rgb: jnp.ndarray         # (H, W, 3) weighted sample accumulator
    weight: jnp.ndarray      # (H, W) filter weight accumulator
    splat: jnp.ndarray       # (H, W, 3) light-tracing splat accumulator
    n_passes: jnp.ndarray    # () float — splat normalization

    @staticmethod
    def create(height: int, width: int) -> "Film":
        return Film(
            rgb=jnp.zeros((height, width, 3), jnp.float32),
            weight=jnp.zeros((height, width), jnp.float32),
            splat=jnp.zeros((height, width, 3), jnp.float32),
            n_passes=jnp.zeros((), jnp.float32),
        )


def add_samples(film: Film, pixel_id, value, weight=None) -> Film:
    """Accumulate eye-path samples: pixel_id (B,) flat indices, value (B, 3).

    Counterpart of Image::AddSample (Engine/Image.cu:22-44)."""
    H, W = film.weight.shape
    value = jnp.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0)
    if weight is None:
        weight = jnp.ones(value.shape[:-1], jnp.float32)
    rgb = film.rgb.reshape(-1, 3).at[pixel_id].add(value * weight[..., None])
    w = film.weight.reshape(-1).at[pixel_id].add(weight)
    return film._replace(rgb=rgb.reshape(H, W, 3), weight=w.reshape(H, W))


def add_samples_filtered(film: Film, sx, sy, value, ftype: int,
                         radius: float = 1.5, support: int = 1) -> Film:
    """Filter-importance splatting: weight each camera sample into its
    filter-support pixels at ACCUMULATION time — the reference's
    CanonicalFilter path (Engine/Image.cu:22-44 weightSum +
    Kernel/ImagePipeline/Filter/CanonicalFilter.cu), versus the post-process
    blur in pipeline.apply_filter which is a different (signal-blurring)
    estimator.

    sx, sy: (B,) continuous sample positions in pixel units (pixel centers
    at integer + 0.5). support: taps reach [-support, +support] around the
    containing pixel."""
    from .pipeline import filter_eval_1d

    H, W = film.weight.shape
    value = jnp.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0)
    ix = jnp.floor(sx).astype(jnp.int32)
    iy = jnp.floor(sy).astype(jnp.int32)
    rgb = film.rgb.reshape(-1, 3)
    w_acc = film.weight.reshape(-1)
    for dy in range(-support, support + 1):
        qy = iy + dy
        wy = filter_eval_1d(ftype, (qy.astype(jnp.float32) + 0.5) - sy, radius)
        for dx in range(-support, support + 1):
            qx = ix + dx
            wx = filter_eval_1d(ftype, (qx.astype(jnp.float32) + 0.5) - sx,
                                radius)
            w = wx * wy
            inside = (qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
            pid = jnp.where(inside, qy * W + qx, H * W)  # OOB -> dropped
            rgb = rgb.at[pid].add(value * w[:, None], mode="drop")
            w_acc = w_acc.at[pid].add(w, mode="drop")
    return film._replace(rgb=rgb.reshape(H, W, 3), weight=w_acc.reshape(H, W))


def add_splats(film: Film, pixel_id, value, mask=None) -> Film:
    """Accumulate light-tracing splats (Image::Splat, Engine/Image.cu:46-66)."""
    H, W = film.weight.shape
    value = jnp.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0)
    if mask is not None:
        value = jnp.where(mask[..., None], value, 0.0)
    splat = film.splat.reshape(-1, 3).at[pixel_id].add(value)
    return film._replace(splat=splat.reshape(H, W, 3))


def finish_pass(film: Film, n: float = 1.0) -> Film:
    return film._replace(n_passes=film.n_passes + n)


def develop(film: Film, splat_scale: float = 1.0) -> jnp.ndarray:
    """Resolve to a (H, W, 3) radiance image."""
    img = film.rgb / jnp.maximum(film.weight, 1e-8)[..., None]
    splat = film.splat * (
        splat_scale / jnp.maximum(film.n_passes, 1.0)
    )
    return img + splat


def luminance_stats(image) -> dict:
    """Image-wide luminance statistics (Engine/Image.cu:112-126)."""
    lum = (
        0.212671 * image[..., 0] + 0.715160 * image[..., 1] + 0.072169 * image[..., 2]
    )
    return {
        "mean": jnp.mean(lum),
        "max": jnp.max(lum),
        "min": jnp.min(lum),
        "var": jnp.var(lum),
    }
