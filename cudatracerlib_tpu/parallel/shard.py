"""Multi-device / multi-host parallel rendering and differentiable training.

The reference is single-GPU (SURVEY.md §2.8: no distributed backend anywhere);
this module is the *new* capability BASELINE.json's north star requires:

  * rays/image-tiles sharded over a device mesh via `shard_map`
    (axes: `dp` = pixel blocks, `sp` = samples-per-pixel replicas);
  * scene + BVH replicated in device memory on every device;
  * per-pass film reduction with `psum` over the mesh (counterpart of the
    reference's single-GPU Image::AddSample atomics, Engine/Image.cu:22-66);
  * parameter gradients all-reduced by the same psum in the backward pass
    (jax.grad of a psum-ed loss inserts the all-reduce automatically).

The mesh follows the algorithm only: the GPUs of a host are joined all to
all, so any (dp, sp) factorization of the device count is equally close.
Everything works identically on GPUs and on the
`--xla_force_host_platform_device_count` CPU mesh used in tests.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..image import film as film_mod
from ..render.path_tracer import PTConfig, trace_radiance
from ..sampling.rng import Sampler
from ..scene import sensors
from ..scene.scene import Scene


def make_mesh(n_dp: int | None = None, n_sp: int = 1,
              devices: Sequence[jax.Device] | None = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n_dp is None:
        n_dp = len(devices) // n_sp
    assert n_dp * n_sp <= len(devices)
    devs = np.asarray(devices[: n_dp * n_sp]).reshape(n_dp, n_sp)
    return Mesh(devs, ("dp", "sp"))


def _local_ids(n_px: int, spp: int, n_dp: int, n_sp: int):
    """(pixel_id, sample_idx) of this device's rays, inside shard_map: pixels
    split over `dp`, samples over `sp`, sample-major within the device.
    Derived from the axis indices, so no index array is baked into the
    program as a constant (XLA would constant-fold the film scatter over it
    at every compile)."""
    n_loc_px = n_px // n_dp
    n_loc_s = spp // n_sp
    j = jnp.arange(n_loc_s * n_loc_px, dtype=jnp.uint32)
    dp = jax.lax.axis_index("dp").astype(jnp.uint32)
    sp = jax.lax.axis_index("sp").astype(jnp.uint32)
    return dp * n_loc_px + j % n_loc_px, sp * n_loc_s + j // n_loc_px


def _render_shard(scene: Scene, pixel_id, sample_idx, seed, width, height, config):
    """Per-device ray batch -> local film contribution (runs inside shard_map)."""
    sampler = Sampler.create(seed, pixel_id, sample_idx)
    px = (pixel_id % width).astype(jnp.float32)
    py = (pixel_id // width).astype(jnp.float32)
    sampler, jitter = sampler.next_2d()
    film_uv = jnp.stack(
        [(px + jitter[:, 0]) / width, (py + jitter[:, 1]) / height], axis=-1
    )
    sampler, u_ap = sampler.next_2d()
    o, d, w_cam = sensors.sample_ray(scene.camera, film_uv, u_ap)
    L, _, n_rays, _ = trace_radiance(scene, o, d, sampler, config,
                                     with_stats=True)
    L = L * w_cam

    film = film_mod.Film.create(height, width)
    film = film_mod.add_samples(film, pixel_id.astype(jnp.int32), L)
    # film psum over the mesh = the distributed Image reduction
    rgb = jax.lax.psum(jax.lax.psum(film.rgb, "dp"), "sp")
    weight = jax.lax.psum(jax.lax.psum(film.weight, "dp"), "sp")
    n_rays = jax.lax.psum(jax.lax.psum(n_rays, "dp"), "sp")
    return rgb, weight, n_rays


def make_sharded_render(mesh: Mesh, width: int, height: int, spp: int,
                        config: PTConfig = PTConfig(),
                        with_stats: bool = False):
    """Build a jitted multi-device render fn(scene, seed) -> (H, W, 3) image
    (with_stats=True: -> (image, rays actually traced, summed over devices)).

    Pixels shard over `dp`, spp replicas over `sp`; the scene pytree is
    replicated (in_specs P())."""
    n_px = width * height
    n_dp = mesh.shape["dp"]
    n_sp = mesh.shape["sp"]
    assert n_px % n_dp == 0, "pixel count must divide dp axis"
    assert spp % n_sp == 0, "spp must divide sp axis"

    shard_fn = jax.shard_map(
        lambda scene, seed: _render_shard(
            scene, *_local_ids(n_px, spp, n_dp, n_sp), seed, width, height,
            config),
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(), P(), P()),
        # traversal/scan carries mix replicated scene state with sharded rays;
        # skip the varying-manual-axes check rather than pcast every carry leaf
        check_vma=False,
    )

    @jax.jit
    def render_fn(scene: Scene, seed):
        rgb, weight, n_rays = shard_fn(scene, seed)
        img = rgb / jnp.maximum(weight, 1e-8)[..., None]
        if with_stats:
            return img, n_rays
        return img

    return render_fn


def make_train_step(mesh: Mesh, width: int, height: int, spp: int,
                    target_image, lr: float = 0.05,
                    config: PTConfig = PTConfig(max_depth=4, rr_start=99)):
    """Differentiable inverse-rendering step, fully sharded.

    Optimizes (texture colors, light radiance) to match `target_image` by L2
    loss; gradients flow through the sharded render and are all-reduced by the
    film psum. Returns jitted step(scene, seed) -> (scene, loss)."""
    render_fn_inner = make_sharded_render(mesh, width, height, spp, config)

    def loss_fn(params, scene, seed):
        color_a, radiance = params
        s = scene._replace(
            textures=scene.textures._replace(color_a=color_a),
            lights=scene.lights._replace(radiance=radiance),
        )
        img = render_fn_inner(s, seed)
        return jnp.mean((img - target_image) ** 2)

    @jax.jit
    def step(scene: Scene, seed):
        params = (scene.textures.color_a, scene.lights.radiance)
        loss, grads = jax.value_and_grad(loss_fn)(params, scene, seed)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        new_scene = scene._replace(
            textures=scene.textures._replace(color_a=new_params[0]),
            lights=scene.lights._replace(radiance=new_params[1]),
        )
        return new_scene, loss

    return step


def make_sharded_ppm(mesh: Mesh, width: int, height: int, spp: int,
                     config=None):
    """Multi-device progressive photon mapping pass (BASELINE config 5: the
    light-tracing pass sharded over the mesh).

    Each device traces n_photons / n_dev photons with a device-folded seed;
    the photon SoA is then `all_gather`ed so every device holds the union
    map (scene-sized, like the replicated BVH), the grid is built
    redundantly per device (cheap sort), and the eye pass shards over pixels
    with the usual film psum. Returns fn(scene, seed, pass_idx) -> image."""
    from ..accel import hashgrid
    from ..render import ppm as ppm_mod

    if config is None:
        config = ppm_mod.PPMConfig()
    n_dp = mesh.shape["dp"]
    n_sp = mesh.shape["sp"]
    n_dev = n_dp * n_sp
    assert config.n_photons % n_dev == 0, "n_photons must divide device count"
    n_px = width * height
    assert n_px % n_dp == 0 and spp % max(n_sp, 1) == 0

    def _build(cfg: "ppm_mod.PPMConfig"):
        def _shard(scene: Scene, seed, radius):
            cfg_local = cfg._replace(n_photons=cfg.n_photons // n_dev)
            dev = jax.lax.axis_index("dp") * n_sp + jax.lax.axis_index("sp")
            pm_local = ppm_mod.trace_photons(
                scene, cfg_local.n_photons,
                seed ^ (dev.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)),
                cfg_local.base,
            )
            # photon exchange: the union map is replicated on every device
            pm = jax.tree.map(
                lambda x: jax.lax.all_gather(
                    jax.lax.all_gather(x, "sp", axis=0, tiled=True),
                    "dp", axis=0, tiled=True),
                pm_local,
            )
            # per-pass power normalization already divided by the LOCAL
            # count; rescale to the global photon count
            pm = pm._replace(power=pm.power / n_dev)
            grids = ppm_mod.build_photon_grids(scene, pm, cfg)
            pid, sid = _local_ids(n_px, spp, n_dp, n_sp)
            film = ppm_mod.ppm_eye_pass(
                scene, pm, grids, pid, sid, seed, radius, width, height, cfg,
            )
            rgb = jax.lax.psum(jax.lax.psum(film.rgb, "dp"), "sp")
            weight = jax.lax.psum(jax.lax.psum(film.weight, "dp"), "sp")
            return rgb, weight

        shard_fn = jax.shard_map(
            _shard,
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )

        @jax.jit
        def run(scene: Scene, seed, radius):
            rgb, weight = shard_fn(scene, seed, radius)
            return rgb / jnp.maximum(weight, 1e-8)[..., None]

        return run

    # base-PTConfig specialization happens lazily per scene (with
    # bsdf_types=None every BSDF family would be evaluated on every lane)
    cache: dict = {}

    def _jitted(scene: Scene):
        from ..render.path_tracer import specialize_config

        base = specialize_config(scene, config.base)
        if base not in cache:
            cache[base] = _build(config._replace(base=base))
        return cache[base]

    def ppm_fn(scene: Scene, seed, radius):
        return _jitted(scene)(scene, seed, radius)

    # ahead-of-time lowering, as on a jitted function
    ppm_fn.lower = lambda scene, seed, radius: _jitted(scene).lower(
        scene, seed, radius)
    return ppm_fn


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Place every scene leaf replicated on the mesh.

    Uses make_array_from_callback rather than device_put: in multi-PROCESS
    meshes device_put value-checks the host value across processes, and that
    equality check trips on NaN padding lanes in the scene tables (NaN != NaN)
    even though every host built the identical scene."""
    sharding = NamedSharding(mesh, P())

    def put(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sharding,
                                            lambda idx: x[idx])

    return jax.tree.map(put, scene)
