#!/usr/bin/env python3
"""End-to-end check of the renderer on one CUDA GPU.

    python chip_smoke.py            # phases 0-4 on one GPU
    python chip_smoke.py --four     # phase 5 alone, on four GPUs

Phases (any failure raises, exits non-zero and prints no result line):
  0  device: a CUDA GPU or stop; card name and power limit, JAX version,
     XLA_FLAGS and the compile-cache directory;
  1  the CUDA BVH traversal kernel against the XLA oracle
     (accel/traversal.intersect) on 2^20 camera + bounce rays, for the big,
     glossy and Cornell scenes: closest hit, any hit and a finite t_max;
  2  every engine at the sizes bench.py uses, through its public entry point:
     mean, counted rays, seconds, and a finite non-zero image;
  3  each engine at 64^2 on the GPU and on the CPU devices of this process,
     same seed (backend.by_platform follows the lowering platform, so the
     CPU run takes the CPU path);
  4  jax.grad of an image loss w.r.t. light radiance and an albedo through
     `render` at 128^2 against a central finite difference on the GPU;
  5  (--four only) make_sharded_render, make_train_step and make_sharded_ppm
     on four GPUs, meshes (4, 1) and (2, 2), against the same calls on one.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_RAYS = 1 << 20

# Kernel vs oracle (phase 1). The two run the same arithmetic, but nvcc and
# XLA round multiply-adds differently (fused or not), so a ray that grazes an
# edge, or whose hit lies at t_min, can land on the other side in one of
# them. Where both agree on the triangle, t differs by rounding of the Woop
# plane distance, which scales with the scene's extent R. Bounds (an H100
# run measured a 1e-6 hit/miss share, |dt| <= 8e-6 R on the same triangle,
# and 3e-6 of hits beyond 1e-4 R, all at t = t_min):
VALID_MISMATCH_MAX = 1e-5   # share of rays whose hit/miss flag differs
T_ABS_REL_R = 1e-4          # |dt| bound as a fraction of R ...
T_FAR_SHARE_MAX = 2e-5      # ... that all but this share of both-hit rays meet

# GPU vs CPU renders (phase 3). Both paths draw the same random numbers, so
# images agree until a rounding difference flips a discrete choice (a hit at
# an edge, a lobe, Russian roulette) and that one path goes elsewhere. Every
# f32 contraction on the device path runs at HIGHEST precision, so the
# difference is rounding only (an H100 run measured means within 3.9e-6);
# a contraction in TF32 or a lost term moves the mean by far more. Bounds on
# the relative difference of means, and on the share of pixel values within
# rtol 1e-3 / atol 1e-4 (a flipped path moves a handful of pixels):
PARITY_MEAN_REL = 1e-4
PARITY_CLOSE_MIN = 0.999

# Phase 5 sizes: (render width, render spp, train-step and PPM width) and
# the PPM photon count (bench.py's caustic cell).
FOUR_SIZES = (256, 8, 128)
FOUR_PHOTONS = 1 << 17

# Gradient vs central difference (phase 4): the loss is a polynomial in both
# parameters (no Russian roulette), so the difference is f32 rounding and the
# difference quotient's O(eps^2) term (an H100 run measured 1.8e-6).
GRAD_REL = 1e-3
FD_EPS = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int = 1):
    """(result, best wall seconds over reps) of a warm fn()."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, best


# ----------------------------------------------------------------- phase 0
def phase_device():
    devs = jax.devices()
    if not devs or devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no CUDA GPU (JAX sees {devs}); "
                         "this check runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    import cudatracerlib_tpu as ct

    log(f"card: {card}")
    log(f"jax {jax.__version__}; devices: {len(devs)} x "
        f"{devs[0].device_kind}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir} "
        f"(package default {ct.compilation_cache_dir()})")
    return card, devs


# ----------------------------------------------------------------- phase 1
def _scenes():
    from cudatracerlib_tpu.scene.bigscene import build_big_scene
    from cudatracerlib_tpu.scene.shapes import cornell_box, glossy_scene

    t0 = time.perf_counter()
    big = build_big_scene()
    log(f"  big scene: {int(big.bvh.woop.shape[0])} padded tris, built in "
        f"{time.perf_counter() - t0:.1f}s")
    return {"big": big, "glossy": glossy_scene(), "cornell": cornell_box()}


def _test_rays(scene, seed: int):
    """2^19 camera rays + 2^19 bounce rays from their oracle hit points in
    uniformly random directions, and a per-ray finite t_max."""
    import jax.numpy as jnp

    from cudatracerlib_tpu.accel import traversal
    from cudatracerlib_tpu.scene import sensors

    half = N_RAYS // 2
    W = 1024
    H = half // W
    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    pid = jnp.arange(half)
    uv = jnp.stack([(pid % W + jax.random.uniform(k1, (half,))) / W,
                    (pid // W + jax.random.uniform(k2, (half,))) / H], -1)
    o_c, d_c, _ = sensors.sample_ray(scene.camera, uv,
                                     jnp.full((half, 2), 0.5))
    hit = jax.jit(traversal.intersect)(scene.bvh, o_c, d_c)
    lo = jnp.asarray(scene.bvh.world_min)
    hi = jnp.asarray(scene.bvh.world_max)
    p_rand = lo + (hi - lo) * jax.random.uniform(k3, (half, 3))
    t_back = jnp.where(hit.valid, hit.t * (1 - 1e-4), 0.0)
    o_b = jnp.where(hit.valid[:, None], o_c + d_c * t_back[:, None], p_rand)
    d_b = jax.random.normal(k4, (half, 3))
    d_b = d_b / jnp.linalg.norm(d_b, axis=-1, keepdims=True)
    o = jnp.concatenate([o_c, o_b])
    d = jnp.concatenate([d_c, d_b])
    radius = float(np.linalg.norm(np.asarray(scene.bvh.world_max)
                                  - np.asarray(scene.bvh.world_min)))
    t_max = radius * jax.random.uniform(jax.random.PRNGKey(seed + 1),
                                        (N_RAYS,), minval=0.05, maxval=0.5)
    return jax.block_until_ready((o, d, t_max))


def _compare(name, k, r, extent: float, closest: bool):
    """Assert kernel Hit `k` agrees with oracle Hit `r` (module bounds)."""
    kv, rv = np.asarray(k.valid), np.asarray(r.valid)
    mism = float(np.mean(kv != rv))
    msg = f"valid mismatch {mism:.2e}"
    assert mism <= VALID_MISMATCH_MAX, f"{name}: {msg}"
    if closest:
        both = kv & rv
        kt, rt = np.asarray(k.t)[both], np.asarray(r.t)[both]
        same = np.asarray(k.prim)[both] == np.asarray(r.prim)[both]
        dt = np.abs(kt - rt) / extent
        share = float(np.mean(dt > T_ABS_REL_R)) if both.any() else 0.0
        msg += (f", prim agree {float(np.mean(same)):.6f}, max |dt|/R "
                f"(same prim) {float(dt[same].max(initial=0.0)):.2e}, share "
                f"|dt| > {T_ABS_REL_R:g} R {share:.2e}")
        assert share <= T_FAR_SHARE_MAX, f"{name}: {msg}"
    log(f"  {name}: hits {int(rv.sum())}/{rv.size}, {msg}")


def phase_kernel(scenes):
    from cudatracerlib_tpu.accel import traversal
    from cudatracerlib_tpu.ops import bvh_trace

    t0 = time.perf_counter()
    bvh_trace.ensure_registered()
    log(f"  kernel library {os.path.relpath(bvh_trace.library_path(), ROOT)}"
        f" ready in {time.perf_counter() - t0:.1f}s")
    kern = jax.jit(bvh_trace.intersect_kernel, static_argnames=("any_hit",))
    orac = jax.jit(traversal.intersect, static_argnames=("any_hit",))
    first = True
    for i, (sname, scene) in enumerate(scenes.items()):
        o, d, t_max = _test_rays(scene, 100 + i)
        bvh = scene.bvh
        extent = float(np.linalg.norm(np.asarray(bvh.world_max)
                                      - np.asarray(bvh.world_min)))
        for mode, any_hit, tm in (("closest", False, np.inf),
                                  ("any", True, np.inf),
                                  ("closest t_max", False, t_max)):
            if first:
                comp = kern.lower(bvh, o, d, 1e-4, tm, any_hit=any_hit
                                  ).compile()
                log(f"  memory_analysis (kernel call, {N_RAYS} rays): "
                    f"{comp.memory_analysis()}")
                first = False
            k, tk = timed(lambda: kern(bvh, o, d, 1e-4, tm, any_hit=any_hit))
            k, tk = timed(lambda: kern(bvh, o, d, 1e-4, tm, any_hit=any_hit),
                          reps=3)
            r, _ = timed(lambda: orac(bvh, o, d, 1e-4, tm, any_hit=any_hit))
            r, tr = timed(lambda: orac(bvh, o, d, 1e-4, tm, any_hit=any_hit),
                          reps=3)
            log(f"  {sname}/{mode}: kernel {tk * 1e3:.3f} ms, oracle "
                f"{tr * 1e3:.3f} ms")
            _compare(f"{sname}/{mode}", k, r, extent, closest=not any_hit)


# ----------------------------------------------------------------- phase 2
def _volume_setup(scene, res: int = 32):
    from cudatracerlib_tpu.scene import media as M

    lo = np.asarray(scene.bvh.world_min)
    hi = np.asarray(scene.bvh.world_max)
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, res)] * 3, indexing="ij"), -1)
    rng = np.random.default_rng(0)
    dens = np.zeros((res,) * 3, np.float32)
    for _ in range(6):
        c = rng.uniform(0.2, 0.8, 3)
        s = rng.uniform(0.05, 0.2)
        dens += np.exp(-np.sum((g - c) ** 2, -1) / (2 * s * s)).astype(
            np.float32)
    return M.Media.build([
        dict(type=M.GRID, sigma_a=[0.05] * 3, sigma_s=[0.6, 0.7, 0.8],
             box_min=lo + 0.05, box_max=hi - 0.05, phase_g=0.3, density=dens)
    ])


def engines(scenes, size=None, ppm_devices=None):
    """name -> zero-arg fn returning (image, counted rays) at bench sizes, or
    at size x size with fewer samples for the parity phase."""
    import jax.numpy as jnp

    from cudatracerlib_tpu.parallel.shard import make_mesh, make_sharded_ppm
    from cudatracerlib_tpu.render.bdpt import BDPTConfig, render_bdpt_counted
    from cudatracerlib_tpu.render.path_tracer import (PTConfig,
                                                      render_counted,
                                                      specialize_config)
    from cudatracerlib_tpu.render.ppm import (PPMConfig, progressive_radius,
                                              trace_photons)
    from cudatracerlib_tpu.render.volpath import (render_vol_counted,
                                                  render_vol_stepwise)
    from cudatracerlib_tpu.render.wavefront import render_wavefront_counted
    from cudatracerlib_tpu.scene.shapes import caustic_scene

    small = size is not None
    s = size
    cfg5 = PTConfig(max_depth=5)
    cornell, glossy, big = scenes["cornell"], scenes["glossy"], scenes["big"]
    caustic = scenes.setdefault("caustic", caustic_scene())
    medium = scenes.setdefault("medium", _volume_setup(cornell))
    vcfg = specialize_config(cornell, PTConfig(max_depth=6))
    pcfg = PPMConfig(n_photons=1 << 14) if small else PPMConfig()
    mesh = make_mesh(devices=ppm_devices)
    ppm_w = s or 128
    ppm_spp = 2 if small else 4
    ppm_fn = make_sharded_ppm(mesh, ppm_w, ppm_w, ppm_spp, pcfg)
    radius = progressive_radius(pcfg.radius0, 1)

    pbase = specialize_config(caustic, pcfg.base)
    photon_rays = jax.jit(lambda scene: trace_photons(
        scene, pcfg.n_photons, jnp.uint32(7), pbase, with_stats=True)[1])

    def ppm():
        img = ppm_fn(caustic, jnp.uint32(7), radius)
        return img, photon_rays(caustic) + ppm_w * ppm_w * ppm_spp

    return {
        "cornell_pt": lambda: render_counted(
            cornell, s or 256, s or 256, 4 if small else 16, jnp.uint32(7),
            cfg5),
        "glossy_wavefront": lambda: render_wavefront_counted(
            glossy, s or 256, s or 256, 4 if small else 80, 7, cfg5),
        "big_wavefront": lambda: render_wavefront_counted(
            big, s or 512, s or 512, 2 if small else 16, 7, cfg5),
        "volume_fused": lambda: render_vol_counted(
            cornell, medium, s or 256, s or 256, 2 if small else 8,
            jnp.uint32(7), vcfg),
        "volume_stepwise": lambda: render_vol_stepwise(
            cornell, medium, s or 256, s or 256, 2 if small else 8, 1,
            jnp.uint32(7), vcfg, with_stats=True),
        "bdpt_caustic": lambda: render_bdpt_counted(
            caustic, s or 128, s or 128, 2 if small else 4, 7, BDPTConfig()),
        "sharded_ppm": ppm,
    }


def phase_engines(scenes):
    out = {}
    for name, fn in engines(scenes).items():
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        t_first = time.perf_counter() - t0
        (img, rays), dt = timed(fn)
        img = np.asarray(img)
        mean = float(img.mean())
        log(f"  {name}: mean {mean:.6f}, rays {float(rays):.0f}, "
            f"{dt:.4f} s warm ({t_first:.1f} s first call)")
        assert np.isfinite(img).all(), f"{name}: non-finite pixels"
        assert mean > 0.0, f"{name}: black image"
        out[name] = img
    a, b = out["volume_fused"], out["volume_stepwise"]
    diff = float(np.abs(a - b).max())
    rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    log(f"  render_vol vs render_vol_stepwise: max |diff| {diff:.3e}, "
        f"mean rel {rel:.3e}")
    assert rel <= PARITY_MEAN_REL, "fused and stepwise volume renders differ"


# ----------------------------------------------------------------- phase 3
def phase_parity(scenes):
    cpu = jax.devices("cpu")[0]
    gpu_runs = engines(scenes, size=64)
    gpu = {n: np.asarray(fn()[0]) for n, fn in gpu_runs.items()}
    with jax.default_device(cpu):
        cpu_runs = engines(scenes, size=64, ppm_devices=[cpu])
        for name, fn in cpu_runs.items():
            t0 = time.perf_counter()
            c = np.asarray(fn()[0])
            g = gpu[name]
            rel = abs(float(g.mean()) - float(c.mean())) / max(
                float(c.mean()), 1e-12)
            close = float(np.mean(np.isclose(g, c, rtol=1e-3, atol=1e-4)))
            log(f"  {name} 64^2: gpu mean {g.mean():.6f}, cpu mean "
                f"{c.mean():.6f}, rel {rel:.2e}, pixels within 1e-3 "
                f"{close:.6f} (cpu {time.perf_counter() - t0:.1f}s)")
            assert np.isfinite(g).all() and np.isfinite(c).all(), name
            assert rel <= PARITY_MEAN_REL, f"{name}: GPU and CPU means differ"
            assert close >= PARITY_CLOSE_MIN, f"{name}: GPU and CPU differ"


# ----------------------------------------------------------------- phase 4
def phase_gradient(scenes):
    import jax.numpy as jnp

    from cudatracerlib_tpu.render.path_tracer import PTConfig, render

    scene = scenes["cornell"]
    cfg = PTConfig(max_depth=3, rr_start=99)
    target = jax.block_until_ready(
        render(scene, 128, 128, 4, jnp.uint32(11), cfg)) * 0.8

    def loss(params):
        k, a = params
        s = scene._replace(
            lights=scene.lights._replace(radiance=scene.lights.radiance * k),
            textures=scene.textures._replace(
                color_a=scene.textures.color_a.at[1].multiply(a)))
        img = render(s, 128, 128, 4, jnp.uint32(5), cfg)
        return jnp.mean((img - target) ** 2)

    p0 = (jnp.float32(1.0), jnp.float32(1.0))
    g = jax.jit(jax.grad(loss))(p0)
    g = [float(x) for x in g]
    lf = jax.jit(loss)
    fd = []
    for i in range(2):
        hi = [1.0, 1.0]
        lo = [1.0, 1.0]
        hi[i] += FD_EPS
        lo[i] -= FD_EPS
        fd.append((float(lf(tuple(map(jnp.float32, hi))))
                   - float(lf(tuple(map(jnp.float32, lo))))) / (2 * FD_EPS))
    for name, a, b in (("radiance", g[0], fd[0]), ("albedo", g[1], fd[1])):
        rel = abs(a - b) / max(abs(b), 1e-12)
        log(f"  d loss / d {name}: grad {a:.6e}, central FD {b:.6e}, "
            f"rel {rel:.2e}")
        assert np.isfinite(a) and rel <= GRAD_REL, f"{name} gradient"


# ----------------------------------------------------------------- phase 5
def phase_four():
    """Nine programs (render, train step, PPM on three meshes), lowered in
    turn, compiled at once on a thread pool, then run one after another."""
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    from cudatracerlib_tpu.parallel.shard import (make_mesh,
                                                  make_sharded_ppm,
                                                  make_sharded_render,
                                                  make_train_step,
                                                  replicate_scene)
    from cudatracerlib_tpu.render.path_tracer import (PTConfig,
                                                      specialize_config)
    from cudatracerlib_tpu.render.ppm import PPMConfig, progressive_radius
    from cudatracerlib_tpu.scene.shapes import caustic_scene, cornell_box

    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs four devices, found {len(devs)}"
    cornell = cornell_box()
    caustic = caustic_scene()
    W, spp, T = FOUR_SIZES
    # the scene's own BSDF families, as the public render entry points do
    cfg = specialize_config(cornell, PTConfig(max_depth=5))
    tcfg = specialize_config(cornell, PTConfig(max_depth=3, rr_start=99))
    pcfg = PPMConfig(n_photons=FOUR_PHOTONS)
    radius = progressive_radius(pcfg.radius0, 1)
    target = jnp.zeros((T, T, 3), jnp.float32)

    jobs = []   # (mesh, program, lowered, args)
    t0 = time.perf_counter()
    for shape in ((1, 1), (4, 1), (2, 2)):
        mesh = make_mesh(*shape, devices=devs[:shape[0] * shape[1]])
        scene = replicate_scene(cornell, mesh)
        for prog, fn, args in (
                ("render", make_sharded_render(mesh, W, W, spp, cfg,
                                               with_stats=True),
                 (scene, jnp.uint32(3))),
                ("train step", make_train_step(mesh, T, T, 4, target,
                                               config=tcfg),
                 (scene, jnp.uint32(5))),
                ("ppm", make_sharded_ppm(mesh, T, T, 4, pcfg),
                 (replicate_scene(caustic, mesh), jnp.uint32(7), radius))):
            jobs.append((shape, prog, fn.lower(*args), args))
    log(f"  lowered {len(jobs)} programs in {time.perf_counter() - t0:.1f}s")

    def compile_one(job):
        t = time.perf_counter()
        return job[2].compile(), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        compiled = list(pool.map(compile_one, jobs))
    log(f"  compiled them at once in {time.perf_counter() - t0:.1f}s; each: "
        + ", ".join(f"{s} {p} {tc:.1f}s"
                    for (s, p, _, _), (_, tc) in zip(jobs, compiled)))

    out = {}
    for (shape, prog, _, args), (exe, _) in zip(jobs, compiled):
        log(f"  run {shape} {prog}")
        timed(lambda: exe(*args))
        out[shape, prog] = timed(lambda: exe(*args), reps=3)

    def results(shape):
        (img, rays), t_render = out[shape, "render"]
        (new_scene, loss), t_step = out[shape, "train step"]
        ppm_img, t_ppm = out[shape, "ppm"]
        log(f"  mesh {shape}: render {t_render:.4f} s ({float(rays):.0f} "
            f"rays), train step {t_step:.4f} s (loss {float(loss):.6e}), "
            f"ppm {t_ppm:.4f} s")
        return (np.asarray(img), float(loss),
                np.asarray(new_scene.textures.color_a), np.asarray(ppm_img))

    ref = results((1, 1))
    for shape in ((4, 1), (2, 2)):
        img, loss, color, ppm = results(shape)
        # render and train step trace the same samples on any mesh; only
        # the psum order differs
        d_img = float(np.abs(img - ref[0]).max() / max(ref[0].max(), 1e-12))
        d_loss = abs(loss - ref[1]) / max(abs(ref[1]), 1e-12)
        d_col = float(np.abs(color - ref[2]).max())
        # each device traces its own photons (device-folded seeds), so the
        # photon set differs with the device count: compare the estimate
        d_ppm = abs(float(ppm.mean()) - float(ref[3].mean())) / float(
            ref[3].mean())
        log(f"  {shape} vs 1 GPU: render max rel {d_img:.2e}, "
            f"loss rel {d_loss:.2e}, params max |d| {d_col:.2e}, ppm mean "
            f"rel {d_ppm:.2e}")
        assert np.isfinite(img).all() and np.isfinite(ppm).all()
        assert d_img <= 1e-4 and d_loss <= 1e-4 and d_col <= 1e-5
        assert d_ppm <= 5e-2


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharding phase")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    card, devs = phase_device()
    if args.four:
        log("phase 5: four-GPU sharding")
        phase_four()
        count = 4
    else:
        scenes = _scenes()
        for num, label, fn in ((1, "kernel vs oracle", phase_kernel),
                               (2, "engines at bench sizes", phase_engines),
                               (3, "GPU/CPU parity", phase_parity),
                               (4, "gradient", phase_gradient)):
            t0 = time.perf_counter()
            log(f"phase {num}: {label}")
            fn(scenes)
            log(f"phase {num}: ok ({time.perf_counter() - t0:.1f}s)")
        count = len(devs)
    log(f"all phases ok in {time.perf_counter() - t_start:.1f}s; card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
