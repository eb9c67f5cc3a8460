"""Adaptive progressive rendering: variance-driven sample allocation.

Counterpart of the reference block samplers actually *driving* the
render (Kernel/BlockSampler/VarianceBlockSampler.h:44-56 ranks 128-px blocks
and IBlockSampler_device.h:15-22 hands each CUDA block its pixel block).
Under XLA the per-pass ray budget must stay a static shape, so "more passes
for noisy blocks" becomes "more of this pass's fixed ray budget for noisy
blocks": per-block weights from the variance buffer are expanded to a pixel
pmf, and the pass's rays are assigned to pixels by deterministic systematic
sampling of that pmf's CDF. The film normalizes by the realized per-pixel
sample counts, so the estimator stays unbiased for any weight map.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..image import variance as var_mod
from ..sampling.rng import Sampler
from ..scene import sensors
from ..scene.scene import Scene
from .path_tracer import PTConfig, specialize_config, trace_radiance


def assign_rays_to_pixels(weights_px, n_rays: int):
    """Deterministic systematic assignment of `n_rays` ray slots to pixels
    proportional to `weights_px` (flat, (P,), any positive scale).

    Returns (pixel_id (n_rays,) int32, sample_idx (n_rays,) int32) where
    sample_idx enumerates a pixel's rays 0..k-1 within this pass."""
    w = jnp.maximum(weights_px, 0.0)
    cdf = jnp.cumsum(w)
    cdf = cdf / jnp.maximum(cdf[-1], 1e-12)
    r = (jnp.arange(n_rays, dtype=jnp.float32) + 0.5) / n_rays
    pix = jnp.searchsorted(cdf, r).astype(jnp.int32)
    pix = jnp.minimum(pix, weights_px.shape[0] - 1)
    # rays of one pixel are consecutive; the pixel's first ray slot is
    # ceil(cdf[pix-1] * n_rays - 0.5) -> recover the within-pixel index
    prev = jnp.where(pix > 0, cdf[jnp.maximum(pix - 1, 0)], 0.0)
    first = jnp.ceil(prev * n_rays - 0.5).astype(jnp.int32)
    sample_idx = jnp.arange(n_rays, dtype=jnp.int32) - first
    return pix, jnp.maximum(sample_idx, 0)


@partial(jax.jit, static_argnames=("width", "height", "spp", "n_passes",
                                   "config", "mode", "warmup"))
def render_adaptive(scene: Scene, width: int, height: int, spp: int,
                    n_passes: int, seed, config: PTConfig = PTConfig(),
                    mode: int = var_mod.VARIANCE, warmup: int = 1):
    """Progressive render with variance-adaptive per-pixel sample allocation.

    Same total ray budget as `render_progressive(spp, n_passes)`; the first
    `warmup` passes are uniform (they seed the variance buffer), after which
    each pass's rays follow the block-variance weights. Returns (H, W, 3).
    """
    # NOTE: caller should pass a specialized config (render_adaptive_host
    # below wraps this for convenience).
    n_px = width * height
    B = n_px * spp
    uniform_pix = jnp.tile(jnp.arange(n_px, dtype=jnp.int32), spp)
    uniform_sid = jnp.repeat(jnp.arange(spp, dtype=jnp.int32), n_px)

    def run_pass(film_rgb, film_w, vb, pix, sid, pass_seed, pass_idx):
        # pass_seed (seed + pass_idx) already decorrelates passes; folding
        # pass_idx into the sample index TOO puts the same small integer in
        # both hash positions and measurably correlates pass streams (r~0.4
        # pass-error correlation on Cornell), so keep the key (seed, px, sid)
        sampler = Sampler.create(pass_seed, pix.astype(jnp.uint32),
                                 sid.astype(jnp.uint32))
        px = (pix % width).astype(jnp.float32)
        py = (pix // width).astype(jnp.float32)
        sampler, jitter = sampler.next_2d()
        uv = jnp.stack([(px + jitter[:, 0]) / width,
                        (py + jitter[:, 1]) / height], -1)
        sampler, u_ap = sampler.next_2d()
        o, d, w_cam = sensors.sample_ray(scene.camera, uv, u_ap)
        cone = sensors.pixel_spread(scene.camera, width, height)
        L, _ = trace_radiance(scene, o, d, sampler, config, cone=cone)
        L = jnp.nan_to_num(L * w_cam, nan=0.0, posinf=0.0, neginf=0.0)

        pass_rgb = jnp.zeros((n_px, 3)).at[pix].add(L)
        pass_cnt = jnp.zeros((n_px,)).at[pix].add(1.0)
        film_rgb = film_rgb + pass_rgb
        film_w = film_w + pass_cnt
        got = pass_cnt > 0
        pass_img = (pass_rgb / jnp.maximum(pass_cnt, 1.0)[:, None]).reshape(
            height, width, 3)
        vb = var_mod.add_pass(vb, pass_img, pass_idx,
                              mask=got.reshape(height, width))
        return film_rgb, film_w, vb

    def body(carry, pass_idx):
        film_rgb, film_w, vb = carry
        w_blocks = var_mod.block_weights(vb, mode)
        w_px = jnp.repeat(jnp.repeat(w_blocks, var_mod.BLOCK, 0),
                          var_mod.BLOCK, 1).reshape(-1)
        # warmup passes sample uniformly while the buffer fills
        use_uniform = pass_idx < warmup
        a_pix, a_sid = assign_rays_to_pixels(w_px, B)
        pix = jnp.where(use_uniform, uniform_pix, a_pix)
        sid = jnp.where(use_uniform, uniform_sid, a_sid)
        film_rgb, film_w, vb = run_pass(
            film_rgb, film_w, vb, pix, sid, seed + pass_idx, pass_idx)
        return (film_rgb, film_w, vb), None

    init = (jnp.zeros((n_px, 3)), jnp.zeros((n_px,)),
            var_mod.VarianceBuffer.create(height, width))
    (film_rgb, film_w, _), _ = jax.lax.scan(
        body, init, jnp.arange(n_passes, dtype=jnp.uint32))
    img = film_rgb / jnp.maximum(film_w, 1e-8)[:, None]
    return img.reshape(height, width, 3)


def render_adaptive_host(scene: Scene, width: int, height: int, spp: int,
                         n_passes: int, seed,
                         config: PTConfig = PTConfig(),
                         mode: int = var_mod.VARIANCE, warmup: int = 1):
    """specialize_config + render_adaptive (the usual entry point)."""
    config = specialize_config(scene, config)
    return render_adaptive(scene, width, height, spp, n_passes,
                           jnp.uint32(seed), config, mode, warmup)


def render_wavefront_adaptive(scene: Scene, width: int, height: int,
                              spp: int, n_waves: int, seed,
                              config: PTConfig = PTConfig(),
                              mode: int = var_mod.VARIANCE,
                              capacity: int | None = None):
    """Adaptive wavefront render: wave 0 is uniform, later waves feed the
    variance block weights into the wavefront camera-ray generator via its
    `pixel_map` (the reference wiring: WavefrontPathTracer.cu:17-49 reads its
    spp from the block sampler). Each wave is one fused wavefront dispatch;
    the small variance/weight updates run jitted between waves."""
    from .wavefront import _wavefront_impl

    config = specialize_config(scene, config)
    n_px = width * height
    B = n_px * spp
    if capacity is None:
        capacity = min(B, 1 << 20)
    film_rgb = jnp.zeros((n_px, 3))
    film_w = jnp.zeros((n_px,))
    vb = var_mod.VarianceBuffer.create(height, width)

    @jax.jit
    def accumulate(film_rgb, film_w, vb, img, pix_w, pass_idx):
        # wavefront returns a per-pixel mean over its own samples; convert to
        # (sum, count) using the planned per-pixel ray counts
        cnt = jnp.zeros((n_px,)).at[pix_w].add(1.0)
        film_rgb = film_rgb + img.reshape(n_px, 3) * cnt[:, None]
        film_w = film_w + cnt
        vb = var_mod.add_pass(vb, img, pass_idx,
                              mask=(cnt > 0).reshape(height, width))
        return film_rgb, film_w, vb

    uniform_pix = jnp.tile(jnp.arange(n_px, dtype=jnp.int32), spp)
    for k in range(n_waves):
        if k == 0:
            pix_map = uniform_pix
        else:
            w_blocks = var_mod.block_weights(vb, mode)
            w_px = jnp.repeat(jnp.repeat(w_blocks, var_mod.BLOCK, 0),
                              var_mod.BLOCK, 1).reshape(-1)
            pix_map, _ = assign_rays_to_pixels(w_px, B)
        img = _wavefront_impl(scene, width, height, spp,
                              jnp.uint32(seed) + jnp.uint32(k * 7919), config,
                              capacity, pixel_map=pix_map)
        film_rgb, film_w, vb = accumulate(film_rgb, film_w, vb, img, pix_map,
                                          jnp.uint32(k))
    img = film_rgb / jnp.maximum(film_w, 1e-8)[:, None]
    return img.reshape(height, width, 3)
