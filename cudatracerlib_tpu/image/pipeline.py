"""Image pipeline: reconstruction filters, tone mapping, NLM denoising.

Counterpart of reference ``Kernel/ImagePipeline/``:
  * stage chain sample-buffer -> (filter) -> HDR -> (post-process | gamma) ->
    display (ImagePipeline.cu:14-52);
  * reconstruction filters Box/Gaussian/Mitchell/Lanczos/Triangle
    (SceneTypes/Filter.h:28-151) applied here as separable convolutions over
    the accumulated film (dense convs instead of scatter-splats);
  * Reinhard global tone-mapping operator (PostProcess/ToneMapPostProcess.h:8-31);
  * non-local-means filter driven by per-pixel variance
    (Filter/NonLocalMeansFilter.h:13-50).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..math.vecmath import PI

BOX = 0
GAUSSIAN = 1
MITCHELL = 2
LANCZOS = 3
TRIANGLE = 4


def filter_eval_1d(ftype: int, x, radius: float = 2.0):
    """Continuous 1-D filter evaluation at offsets x (pixel units) — the
    reference's Filter::Evaluate functions (SceneTypes/Filter.h:28-151),
    used for filter-importance splatting at accumulation time
    (Kernel/ImagePipeline/Filter/CanonicalFilter.cu)."""
    t = jnp.abs(x) / radius
    box = (jnp.abs(x) <= 0.5).astype(jnp.float32)
    gauss = jnp.maximum(
        jnp.exp(-2.0 * x * x) - jnp.exp(-2.0 * radius * radius), 0.0)

    def mitchell(t):
        B = C = 1.0 / 3.0
        t = t * 2.0
        t2 = t * t
        t3 = t2 * t
        inner = (
            (12 - 9 * B - 6 * C) * t3 + (-18 + 12 * B + 6 * C) * t2 + (6 - 2 * B)
        ) / 6.0
        outer = (
            (-B - 6 * C) * t3 + (6 * B + 30 * C) * t2 + (-12 * B - 48 * C) * t + (8 * B + 24 * C)
        ) / 6.0
        return jnp.where(t < 1.0, inner, jnp.where(t < 2.0, outer, 0.0))

    def sinc(y):
        y = jnp.where(jnp.abs(y) < 1e-6, 1e-6, y)
        return jnp.sin(PI * y) / (PI * y)

    lanczos = jnp.where(t < 1.0, sinc(t * 2.0) * sinc(t * 2.0 / 3.0), 0.0)
    tri = jnp.maximum(1.0 - t, 0.0)
    k = [box, gauss, mitchell(t), lanczos, tri][ftype]
    return jnp.where(t <= 1.0, k, 0.0) if ftype != BOX else k


def filter_kernel_1d(ftype: int, radius: float = 2.0, taps: int = 5):
    """Discrete 1-D filter taps (SceneTypes/Filter.h evaluate functions)."""
    x = jnp.arange(taps, dtype=jnp.float32) - (taps - 1) / 2
    t = jnp.abs(x) / radius

    box = (t <= (0.5 / radius)).astype(jnp.float32)
    gauss = jnp.exp(-2.0 * x * x) - jnp.exp(-2.0 * radius * radius)
    gauss = jnp.maximum(gauss, 0.0)

    def mitchell(t):
        B = C = 1.0 / 3.0
        t = t * 2.0
        t2 = t * t
        t3 = t2 * t
        inner = (
            (12 - 9 * B - 6 * C) * t3 + (-18 + 12 * B + 6 * C) * t2 + (6 - 2 * B)
        ) / 6.0
        outer = (
            (-B - 6 * C) * t3 + (6 * B + 30 * C) * t2 + (-12 * B - 48 * C) * t + (8 * B + 24 * C)
        ) / 6.0
        return jnp.where(t < 1.0, inner, jnp.where(t < 2.0, outer, 0.0))

    def sinc(y):
        y = jnp.where(jnp.abs(y) < 1e-6, 1e-6, y)
        return jnp.sin(PI * y) / (PI * y)

    lanczos = jnp.where(t < 1.0, sinc(t * 2.0) * sinc(t * 2.0 / 3.0), 0.0)
    tri = jnp.maximum(1.0 - t, 0.0)

    k = [box, gauss, mitchell(t), lanczos, tri][ftype]
    return k / jnp.maximum(jnp.sum(k), 1e-9)


def apply_filter(image, ftype: int = GAUSSIAN, radius: float = 2.0, taps: int = 5):
    """Separable filter over an (H, W, 3) image."""
    if ftype == BOX and taps <= 1:
        return image
    k = filter_kernel_1d(ftype, radius, taps)
    img = jnp.moveaxis(image, -1, 0)[:, None]  # (3, 1, H, W)
    kh = k.reshape(1, 1, taps, 1)
    kw = k.reshape(1, 1, 1, taps)
    out = jax.lax.conv_general_dilated(img, kh, (1, 1), "SAME")
    out = jax.lax.conv_general_dilated(out, kw, (1, 1), "SAME")
    return jnp.moveaxis(out[:, 0], 0, -1)


def reinhard_tonemap(image, key: float = 0.18, burn: float = 1.0):
    """Reinhard global operator (ToneMapPostProcess.h:8-31)."""
    lum = (
        0.212671 * image[..., 0] + 0.715160 * image[..., 1] + 0.072169 * image[..., 2]
    )
    log_avg = jnp.exp(jnp.mean(jnp.log(jnp.maximum(lum, 1e-6))))
    scaled = key / jnp.maximum(log_avg, 1e-9) * lum
    lwhite2 = jnp.maximum(burn * jnp.max(scaled), 1e-6) ** 2
    mapped = scaled * (1.0 + scaled / lwhite2) / (1.0 + scaled)
    ratio = mapped / jnp.maximum(lum, 1e-9)
    return image * ratio[..., None]


def gamma_correct(image, gamma: float = 2.2):
    return jnp.power(jnp.maximum(image, 0.0), 1.0 / gamma)


@partial(jax.jit, static_argnames=("patch", "window"))
def nlm_denoise(image, variance, strength: float = 0.5, patch: int = 3, window: int = 7):
    """Non-local-means weighted by per-pixel variance estimates
    (NonLocalMeansFilter.h:13-50). Dense window version — O(W^2) shifted adds,
    which XLA fuses into a handful of kernels (no gather)."""
    H, W, _ = image.shape
    pr = patch // 2
    wr = window // 2
    var = jnp.maximum(variance, 1e-8)[..., None]

    # patch distance via box-filtered squared differences of shifted images
    ones = jnp.ones((1, 1, patch, patch), jnp.float32) / (patch * patch)

    def boxf(x):
        y = jnp.moveaxis(x, -1, 0)[:, None]
        y = jax.lax.conv_general_dilated(y, ones, (1, 1), "SAME")
        return jnp.moveaxis(y[:, 0], 0, -1)

    acc = jnp.zeros_like(image)
    wacc = jnp.zeros(image.shape[:2] + (1,), jnp.float32)
    for dy in range(-wr, wr + 1):
        for dx in range(-wr, wr + 1):
            shifted = jnp.roll(image, (dy, dx), axis=(0, 1))
            d2 = boxf((image - shifted) ** 2 / var)
            w = jnp.exp(-jnp.mean(d2, axis=-1, keepdims=True) / jnp.maximum(2.0 * strength * strength, 1e-6))
            acc = acc + w * shifted
            wacc = wacc + w
    return acc / jnp.maximum(wacc, 1e-9)


def apply_pipeline(image, variance=None, filter_type: int = BOX,
                   tonemap: bool = False, denoise: bool = False,
                   gamma: float | None = None):
    """Full stage chain (ImagePipeline.cu:14-52 ordering)."""
    out = image
    if filter_type != BOX:
        out = apply_filter(out, filter_type)
    if denoise and variance is not None:
        out = nlm_denoise(out, variance)
    if tonemap:
        out = reinhard_tonemap(out)
    if gamma is not None:
        out = gamma_correct(out, gamma)
    return out
