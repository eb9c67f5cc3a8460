"""Light tracer: emitter paths connected to the camera every bounce.

Counterpart of reference ``Integrators/PhotonTracer.{h,cu}`` (light tracing
with lens connection + film splats). Uses the particle walk of ppm.py and the
camera's direct-sampling interface (scene/sensors.py sample_direct), with
splats accumulated through the Film splat buffer (Engine/Image.cu:46-66).

The t=1 BDPT strategy; also the validation oracle for camera importance.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel import traversal
from ..image import film as film_mod
from ..sampling.rng import Sampler
from ..scene import bsdf as bsdf_mod
from ..scene import lights as lights_mod
from ..scene import sensors
from ..scene import scene as scene_mod
from ..scene.scene import Scene, gather_mat_params, make_interaction
from .path_tracer import PTConfig, _offset_ray, _select_light, specialize_config


def render_light_trace(scene: Scene, width: int, height: int, n_paths: int,
                       seed, config: PTConfig = PTConfig()):
    """Render by pure light tracing; returns (H, W, 3). The image estimates
    the same radiance as the path tracer (direct + indirect), built from
    camera splats only."""
    config = specialize_config(scene, config)
    return _lt_impl(scene, width, height, n_paths, jnp.uint32(seed), config)


@partial(jax.jit, static_argnames=("width", "height", "n_paths", "config"))
def _lt_impl(scene: Scene, width: int, height: int, n_paths: int, seed,
             config: PTConfig):
    B = n_paths
    n_px = width * height
    smp = Sampler.create(seed, jnp.arange(B, dtype=jnp.uint32), jnp.uint32(0x117))
    smp, u_sel = smp.next_1d()
    lsel, lpmf, _ = _select_light(scene, u_sel)
    smp, u_pos = smp.next_2d()
    smp, u_dir = smp.next_2d()
    o, d, w = lights_mod.sample_emitter_ray(scene.lights, lsel, u_pos, u_dir)
    w = w / jnp.maximum(jax.lax.stop_gradient(lpmf), 1e-9)[..., None]

    class _C(NamedTuple):
        o: jnp.ndarray
        d: jnp.ndarray
        w: jnp.ndarray
        alive: jnp.ndarray
        smp: Sampler

    init = _C(o=o, d=d, w=w, alive=jnp.ones((B,), bool), smp=smp)

    def bounce(c: _C, depth):
        hit = scene_mod.scene_intersect(scene, c.o, c.d)
        it, mp = scene_mod.hit_shading(scene, c.o, c.d, hit,
                                       config.tex_types)
        found = hit.valid & c.alive

        # ---- connect to camera (splat) ----
        uv, d_cam, dist_cam, importance, in_frustum = sensors.sample_direct(
            scene.camera, it.p
        )
        wo_local = it.frame.to_local(-c.d)
        wi_local = it.frame.to_local(d_cam)
        # adjoint BSDF eval: f * |cos| toward the camera
        f_cam, _ = bsdf_mod.eval_bsdf(mp, wo_local, wi_local,
                                      active=config.bsdf_types)
        sh_o = _offset_ray(it.p, it.n_geo, d_cam, config.ray_eps)
        blocked = scene_mod.scene_occluded(scene, sh_o, d_cam, config.ray_eps,
                                     dist_cam - 2.0 * config.ray_eps)
        # importance is defined per unit film area; distance^2 converts the
        # surface measure (pinhole W_e, Sensor.h:527 interface)
        splat = (
            c.w * f_cam * (importance / jnp.maximum(dist_cam * dist_cam, 1e-9))[..., None]
        )
        ok = found & in_frustum & ~blocked
        px = jnp.clip((uv[..., 0] * width).astype(jnp.int32), 0, width - 1)
        py = jnp.clip((uv[..., 1] * height).astype(jnp.int32), 0, height - 1)
        pix = py * width + px

        # ---- continue the walk ----
        s = c.smp
        s, u2 = s.next_2d()
        s, u1 = s.next_1d()
        bs = bsdf_mod.sample_bsdf(mp, wo_local, u2, u1, active=config.bsdf_types)
        wi_world = it.frame.to_world(bs.wi)
        s, u_rr = s.next_1d()
        p_cont = jax.lax.stop_gradient(
            jnp.where(depth >= config.rr_start,
                      jnp.minimum(jnp.max(jnp.abs(bs.weight), -1), 0.95), 1.0)
        )
        cont = found & (bs.pdf > 0) & (u_rr < p_cont)
        w_new = c.w * bs.weight / jnp.maximum(p_cont, 1e-6)[..., None]
        new = _C(
            o=jnp.where(cont[..., None], _offset_ray(it.p, it.n_geo, wi_world, config.ray_eps), c.o),
            d=jnp.where(cont[..., None], wi_world, c.d),
            w=jnp.where(cont[..., None], w_new, c.w),
            alive=cont,
            smp=s,
        )
        return new, (pix, jnp.where(ok[..., None], splat, 0.0))

    _, (pix, splat) = jax.lax.scan(bounce, init, jnp.arange(config.max_depth))

    film = jnp.zeros((n_px, 3))
    film = film.at[pix.reshape(-1)].add(
        jnp.nan_to_num(splat.reshape(-1, 3), nan=0.0, posinf=0.0, neginf=0.0)
    )
    # normalization: each light path contributes splats over the whole film;
    # estimator divides by path count and multiplies by pixel count
    img = film * (n_px / n_paths)
    return img.reshape(height, width, 3)
