"""Benchmark suite: the five BASELINE configs, honest ray counting, on a GPU.

Prints ONE JSON line per config, each naming the card and its power limit;
the LAST line is the headline metric (config 1, Cornell Mrays/s at path
depth 5).

Methodology
-----------
* Ray counts are MEASURED, not bounded: every engine exposes a *_counted
  variant whose scan sums the lanes actually alive per bounce plus every
  shadow ray cast (the reference's enqueued-ray counter semantics,
  Kernel/TraceHelper.h:52-53). No upper-bound `spp*depth*2` math anywhere.
* Timing is best-of-REPS over a warm program (compile + one execution
  first), each run ending in `jax.block_until_ready`. Per-rep wall times go
  to stderr.
* Each timed region runs the whole pass loop in as few dispatches as
  possible (fused lax.scan over passes where the engine supports it), the
  reference's main.cpp loop as one XLA program.
* One process per card: by default every config runs in its OWN subprocess
  with a timeout, one after another, so a failure in one config cannot
  poison the rest. Run a single config in-process with
  `python bench.py <name>`.
* A run that finds no CUDA GPU fails; it does not measure the CPU.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

import jax  # noqa: F401  (module-level so programmatic use of bench_* works)

REPS = 3
BASELINE_MRAYS = 100.0  # nominal CUDA 9-era single-GPU figure (the brief)
CONFIG_TIMEOUT_S = int(os.environ.get("BENCH_TIMEOUT_S", "1500"))
HEADLINE_RETRIES = 3
_CARD = []


def card() -> str:
    """'name, power limit' of the GPU as nvidia-smi reports it; fails when
    JAX has no CUDA GPU (a CPU number is never reported as a device one)."""
    if not _CARD:
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            raise SystemExit(f"bench.py measures a CUDA GPU; JAX sees {dev}")
        _CARD.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
    return _CARD[0]


def _timeit(fn, reps=REPS, label=""):
    """Best-of-reps wall time of fn() (fn must block until results are real)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    print(f"# {label}: reps={[round(t, 4) for t in times]}", file=sys.stderr)
    return min(times)


def _report(metric, mrays, extra=None):
    line = {
        "metric": metric,
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "card": card(),
        "device_kind": jax.devices()[0].device_kind,
    }
    if extra:
        line.update(extra)
    print(json.dumps(line), flush=True)
    return line


def bench_smoke():
    """Liveness check: tiny Cornell render, one JSON line."""
    from cudatracerlib_tpu.render.path_tracer import PTConfig, render
    from cudatracerlib_tpu.scene.shapes import cornell_box

    scene = cornell_box()
    img = render(scene, 64, 64, 2, 0, PTConfig(max_depth=3))
    jax.block_until_ready(img)
    lum = float(np.asarray(img).mean())
    print(f"# smoke ok: mean luminance {lum:.4f}", file=sys.stderr)
    return _report("smoke (Cornell 64^2@2spp ran)", 1.0, {"mean": round(lum, 4)})


def bench_cornell():
    """Config 1: Cornell box, megakernel PT 256x256 @ 16 spp, depth 5."""
    card()
    from cudatracerlib_tpu.render.path_tracer import (PTConfig, render_counted,
                                                      render_progressive)
    from cudatracerlib_tpu.scene.shapes import cornell_box

    W = H = 256
    spp, depth, n_pass = 16, 5, 5
    cfg = PTConfig(max_depth=depth)
    scene = cornell_box()

    # measured rays per pass (seed-dependent only at the ~0.1% level)
    _, rays1 = render_counted(scene, W, H, spp, 3, cfg)
    rays = float(rays1) * n_pass

    def run(seed=np.uint32(7)):
        jax.block_until_ready(render_progressive(scene, W, H, spp, n_pass, seed, cfg))

    run(np.uint32(0))  # warm
    dt = _timeit(run, label="cornell")
    return _report("Mrays/sec/chip (Cornell, path depth 5)", rays / dt / 1e6)


def bench_glossy():
    """Config 2: microfacet conductor/dielectric + HDR envmap, MIS PT 256^2.

    Engine: wavefront pool — same shared surface_bounce shading
    as the megakernel, but refill-on-death keeps every lane alive instead
    of paying full-width bounces on a dying population (the reference's
    WavefrontPathTracer architecture). The 5 progressive passes become one
    pool run with 5x the camera-ray supply."""
    from cudatracerlib_tpu.render.path_tracer import PTConfig
    from cudatracerlib_tpu.render.wavefront import render_wavefront_counted
    from cudatracerlib_tpu.scene.shapes import glossy_scene

    card()
    W = H = 256
    spp, depth, n_pass = 16, 5, 5
    cfg = PTConfig(max_depth=depth)
    scene = glossy_scene()

    def run(seed=7):
        img, rays = render_wavefront_counted(scene, W, H, spp * n_pass, seed,
                                             cfg)
        jax.block_until_ready(img)
        return float(rays)

    rays = run(0)  # warm + measured ray count
    dt = _timeit(lambda: run(7), label="glossy")
    return _report("Mrays/sec/chip (glossy+envmap MIS PT 256^2)", rays / dt / 1e6)


def bench_bigscene():
    """Config 3: ~1M-tri procedural San-Miguel-class scene, wavefront PT,
    512x512 @ 16 spp (BVH-bound)."""
    from cudatracerlib_tpu.render.path_tracer import PTConfig
    from cudatracerlib_tpu.render.wavefront import render_wavefront_counted
    from cudatracerlib_tpu.scene.bigscene import build_big_scene

    card()
    W = H = 512
    spp, depth = 16, 5
    cfg = PTConfig(max_depth=depth)
    t0 = time.perf_counter()
    scene = build_big_scene()
    print(f"# bigscene: {int(scene.shading.verts.shape[0])} tris, "
          f"build {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    def run(seed=7):
        img, rays = render_wavefront_counted(scene, W, H, spp, seed, cfg)
        jax.block_until_ready(img)
        return float(rays)

    rays = run(0)  # warm + measured ray count
    dt = _timeit(lambda: run(7), label="bigscene")
    return _report(
        "Mrays/sec/chip (1M-tri wavefront PT 512^2@16spp)", rays / dt / 1e6,
        {"n_tris": int(scene.shading.verts.shape[0])},
    )


def bench_volume():
    """Config 4: heterogeneous grid volume + HG phase, volumetric PT, with
    the host-stepped renderer (render_vol_stepwise, one program per
    bounce)."""
    from cudatracerlib_tpu.render.path_tracer import PTConfig, specialize_config
    from cudatracerlib_tpu.render.volpath import render_vol_stepwise
    from cudatracerlib_tpu.scene import media as M
    from cudatracerlib_tpu.scene.shapes import cornell_box

    card()
    W = H = 256
    spp, depth, n_pass = 8, 6, 3
    scene = cornell_box()
    cfg = specialize_config(scene, PTConfig(max_depth=depth))
    lo = np.asarray(scene.bvh.world_min)
    hi = np.asarray(scene.bvh.world_max)
    # smoke plume: sum-of-gaussians density grid
    res = 32
    g = np.stack(np.meshgrid(*[np.linspace(0, 1, res)] * 3, indexing="ij"), -1)
    rng = np.random.default_rng(0)
    dens = np.zeros((res,) * 3, np.float32)
    for _ in range(6):
        c = rng.uniform(0.2, 0.8, 3)
        s = rng.uniform(0.05, 0.2)
        dens += np.exp(-np.sum((g - c) ** 2, -1) / (2 * s * s)).astype(np.float32)
    medium = M.Media.build([
        dict(type=M.GRID, sigma_a=[0.05] * 3, sigma_s=[0.6, 0.7, 0.8],
             box_min=lo + 0.05, box_max=hi - 0.05, phase_g=0.3,
             density=dens)
    ])

    _, rays_n = render_vol_stepwise(scene, medium, W, H, spp, n_pass, 3, cfg,
                                    with_stats=True)
    rays = float(rays_n)

    def run(seed=np.uint32(7)):
        jax.block_until_ready(render_vol_stepwise(scene, medium, W, H, spp, n_pass, seed, cfg))

    run(np.uint32(0))
    dt = _timeit(run, label="volume")
    return _report("Mrays/sec/chip (heterogeneous volume PT 256^2)", rays / dt / 1e6)


def bench_caustic():
    """Config 5: BDPT + sharded progressive photon mapping, caustic scene,
    reported as SEPARATE metrics with their own measured ray counts."""
    import jax.numpy as jnp

    from cudatracerlib_tpu.parallel.shard import make_mesh, make_sharded_ppm
    from cudatracerlib_tpu.render.bdpt import BDPTConfig, render_bdpt_counted
    from cudatracerlib_tpu.render.ppm import (PPMConfig, progressive_radius,
                                              trace_photons)
    from cudatracerlib_tpu.scene.shapes import caustic_scene

    card()
    W = H = 128
    spp = 4
    scene = caustic_scene()
    bcfg = BDPTConfig()

    # --- BDPT passes (counted) ---
    img, rays_bdpt = render_bdpt_counted(scene, W, H, spp, 0, bcfg)
    jax.block_until_ready(img)

    def run_bdpt(seed=7):
        img, _ = render_bdpt_counted(scene, W, H, spp, seed, bcfg)
        jax.block_until_ready(img)

    dt_bdpt = _timeit(run_bdpt, label="caustic-bdpt")
    _report("Mrays/sec/chip (BDPT, caustic scene)",
            float(rays_bdpt) / dt_bdpt / 1e6)

    # --- sharded PPM pass (light pass sharded over the device mesh; on a
    # single GPU this exercises the same shard_map + all_gather program) ---
    pcfg = PPMConfig()
    mesh = make_mesh()
    ppm_fn = make_sharded_ppm(mesh, W, H, spp, pcfg)
    radius = progressive_radius(pcfg.radius0, 1)
    jax.block_until_ready(ppm_fn(scene, jnp.uint32(0), radius))

    def run_ppm(seed=np.uint32(7)):
        jax.block_until_ready(ppm_fn(scene, seed, radius))

    dt_ppm = _timeit(run_ppm, label="caustic-ppm")

    # photon-walk ray count, measured; the eye pass contributes its W*H*spp
    # camera rays (gather queries are grid lookups, not rays — not counted)
    _, rays_ph = trace_photons(scene, pcfg.n_photons, jnp.uint32(3),
                               bcfg.base._replace(max_depth=pcfg.base.max_depth),
                               with_stats=True)
    rays_ppm = float(rays_ph) + W * H * spp
    return _report("Mrays/sec/chip (sharded PPM photon+eye pass, caustics)",
                   rays_ppm / dt_ppm / 1e6)


BENCHES = {
    "smoke": bench_smoke,
    "glossy": bench_glossy,
    "bigscene": bench_bigscene,
    "volume": bench_volume,
    "caustic": bench_caustic,
    # headline LAST: the driver records the final JSON line
    "cornell": bench_cornell,
}


def _run_subprocess(name: str) -> bool:
    """Run one config in an isolated subprocess; forward its stdout JSON
    lines. Returns True if at least one JSON line was produced and rc==0."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(here, "bench.py"), name],
            cwd=here, timeout=CONFIG_TIMEOUT_S,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        rc = -1
        out = (e.stdout or b"").decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        err = f"TIMEOUT after {CONFIG_TIMEOUT_S}s"
    dt = time.perf_counter() - t0
    for line in (err or "").splitlines():
        if line.startswith("#"):
            print(line, file=sys.stderr)
    got_json = False
    for line in (out or "").splitlines():
        line = line.strip()
        if line.startswith("{"):
            print(line, flush=True)
            got_json = True
    ok = rc == 0 and got_json
    status = "ok" if ok else f"FAILED rc={rc}"
    print(f"# bench {name}: {status} ({dt:.0f}s)", file=sys.stderr)
    if not ok and err:
        tail = "\n".join(str(err).splitlines()[-6:])
        print(f"# bench {name} stderr tail:\n{tail}", file=sys.stderr)
    return ok


def main():
    only = sys.argv[1] if len(sys.argv) > 1 else None
    if only:
        BENCHES[only]()
        return
    # Crash-isolated full suite: one subprocess per config, one at a time
    # (one process per card). The XLA persistent compilation cache (enabled
    # at package import) makes the subprocess model cheap.
    for name in BENCHES:
        if name in ("cornell", "smoke"):
            continue
        _run_subprocess(name)
    for attempt in range(HEADLINE_RETRIES):
        if _run_subprocess("cornell"):
            return
        print(f"# headline retry {attempt + 1}/{HEADLINE_RETRIES}",
              file=sys.stderr)
    sys.exit(1)  # no headline number — make the failure loud


if __name__ == "__main__":
    main()
