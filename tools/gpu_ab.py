#!/usr/bin/env python3
"""A/B timings and device-trace breakdowns on the GPU (PERF.md).

    python tools/gpu_ab.py                        # both studies
    python tools/gpu_ab.py --only breakdown       # one of them
    python tools/gpu_ab.py --only breakdown --no-command-buffers

Studies, at the sizes bench.py uses:
  intersector  CUDA kernel vs XLA oracle inside the glossy and big-scene
               wavefront engines: the GPU branch's intersector is swapped,
               JAX's caches cleared, and the variants run in the order
               A B B A in one process; a time is the best warm wall time of
               REPS runs that end in block_until_ready;
  breakdown    one profiler trace per bench cell: device busy time, idle
               share of the traced call, the share of kernel time under the
               `intersect` and `photon_density_estimate` scopes, and the top
               operations. XLA runs most of a program as CUDA graphs
               ("command buffers"), whose kernels the trace cannot attribute
               to operations; --no-command-buffers turns them off for an
               attributed (and somewhat slower) run.

Every output line is one JSON object that names the card and its power
limit; lines are also appended to chiprun_out/gpu_ab.jsonl.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


REPS = 3
OUT = os.path.join(ROOT, "chiprun_out", "gpu_ab.jsonl")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def emit(rec: dict) -> None:
    rec = dict(rec, card=CARD)
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def best_time(fn, reps: int = REPS) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def patched(obj, name, value):
    import jax

    old = getattr(obj, name)
    setattr(obj, name, value)
    jax.clear_caches()
    try:
        yield
    finally:
        setattr(obj, name, old)
        jax.clear_caches()


def abba(study: str, cell: str, fn, variants) -> None:
    """variants: [(label, obj, attr, value)] x 2; runs A B B A."""
    a, b = variants
    times = {a[0]: [], b[0]: []}
    for label, obj, attr, value in (a, b, b, a):
        with patched(obj, attr, value):
            times[label].append(best_time(fn))
    emit({"study": study, "cell": cell,
          **{f"{k}_s": v for k, v in times.items()},
          "ratio_b_over_a": min(times[b[0]]) / min(times[a[0]])})


# ------------------------------------------------------------------ cells
def cells():
    import jax.numpy as jnp

    from cudatracerlib_tpu.parallel.shard import make_mesh, make_sharded_ppm
    from cudatracerlib_tpu.render.bdpt import BDPTConfig, render_bdpt
    from cudatracerlib_tpu.render.path_tracer import (PTConfig,
                                                      render_progressive,
                                                      specialize_config)
    from cudatracerlib_tpu.render.ppm import PPMConfig, progressive_radius
    from cudatracerlib_tpu.render.volpath import render_vol_stepwise
    from cudatracerlib_tpu.render.wavefront import render_wavefront
    from cudatracerlib_tpu.scene.bigscene import build_big_scene
    from cudatracerlib_tpu.scene.shapes import (caustic_scene, cornell_box,
                                                glossy_scene)

    import chip_smoke

    cfg = PTConfig(max_depth=5)
    cornell, glossy, big = cornell_box(), glossy_scene(), build_big_scene()
    caustic = caustic_scene()
    medium = chip_smoke._volume_setup(cornell)
    vcfg = specialize_config(cornell, PTConfig(max_depth=6))
    pcfg = PPMConfig()
    ppm_fn = make_sharded_ppm(make_mesh(), 128, 128, 4, pcfg)
    radius = progressive_radius(pcfg.radius0, 1)
    return {
        "cornell": lambda: render_progressive(cornell, 256, 256, 16, 5,
                                              jnp.uint32(7), cfg),
        "glossy": lambda: render_wavefront(glossy, 256, 256, 80, 7, cfg),
        "bigscene": lambda: render_wavefront(big, 512, 512, 16, 7, cfg),
        "volume": lambda: render_vol_stepwise(cornell, medium, 256, 256, 8,
                                              3, jnp.uint32(7), vcfg),
        "caustic_bdpt": lambda: render_bdpt(caustic, 128, 128, 4, 7,
                                            BDPTConfig()),
        "caustic_ppm": lambda: ppm_fn(caustic, jnp.uint32(7), radius),
    }


# ------------------------------------------------------------------ traces
def _op_names() -> dict:
    """(HLO module, instruction) -> metadata op_name over the live compiled
    programs; op_name carries the jax.named_scope path."""
    import jax

    out = {}
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?op_name=\"([^\"]*)\"")
    for ex in jax.devices()[0].client.live_executables():
        with contextlib.suppress(Exception):
            for mod in ex.hlo_modules():
                for line in mod.to_string().splitlines():
                    m = pat.match(line)
                    if m:
                        out[(mod.name, m.group(1))] = m.group(2)
    return out


def device_events(fn):
    """Run fn() once under the profiler; [(hlo_module, hlo_op, kernel name,
    start_ns, dur_ns)] of every GPU kernel event, and the host wall time of
    the traced call (the window)."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        t0 = time.perf_counter_ns()
        jax.block_until_ready(fn())
        window = time.perf_counter_ns() - t0
        jax.profiler.stop_trace()
        path = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                         recursive=True)[-1]
        pd = ProfileData.from_file(path)
        evs = []
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            # kernel and copy events live on the per-stream lines
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for e in line.events:
                    st = dict(e.stats)
                    evs.append((st.get("hlo_module", ""),
                                st.get("hlo_op", e.name), e.name, e.start_ns,
                                e.duration_ns))
    return evs, window


def busy_ns(evs) -> float:
    iv = sorted((s, s + d) for *_, s, d in evs)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def breakdown(cell: str, fn, command_buffers: bool,
              scopes=("intersect", "photon_density_estimate"),
              top: int = 8) -> None:
    """Device busy time, idle share, scope shares and top ops of one run."""
    evs, window = device_events(fn)
    names = _op_names()
    busy = busy_ns(evs)
    per_op: dict = {}
    scope_ns = {s: 0.0 for s in scopes}
    for mod, op, _, _, dur in evs:
        path = names.get((mod, op), "")
        per_op[(op, path)] = per_op.get((op, path), 0.0) + dur
        for s in scopes:
            if f"/{s}/" in f"/{path}/":
                scope_ns[s] += dur
    kern = sum(e[-1] for e in evs)
    emit({"study": "breakdown", "cell": cell,
          "command_buffers": command_buffers,
          "device_busy_ms": busy / 1e6, "window_ms": window / 1e6,
          "idle_share": 1.0 - busy / max(window, 1),
          "kernel_sum_ms": kern / 1e6, "n_kernels": len(evs),
          "op_names_known": len(names),
          **{f"share_{s}": v / max(kern, 1) for s, v in scope_ns.items()},
          "top_ops": [(op, round(v / 1e6, 4), path[-90:])
                      for (op, path), v in sorted(per_op.items(),
                                                  key=lambda kv: -kv[1])[:top]]})


def main():
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="")
    ap.add_argument("--no-command-buffers", action="store_true")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    if args.no_command_buffers:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax

    assert jax.devices()[0].platform == "gpu", "gpu_ab measures the GPU only"
    CARD = card()
    from cudatracerlib_tpu.accel import traversal
    from cudatracerlib_tpu.ops import bvh_trace

    bvh_trace.ensure_registered()
    fns = cells()
    want = lambda s: not only or s in only  # noqa: E731
    if want("intersector"):
        for cell in ("glossy", "bigscene"):
            abba("intersector", cell, fns[cell], [
                ("kernel", bvh_trace, "intersect_kernel",
                 bvh_trace.intersect_kernel),
                ("oracle", bvh_trace, "intersect_kernel",
                 traversal.intersect)])
    if want("breakdown"):
        for cell, fn in fns.items():
            breakdown(cell, fn, command_buffers=not args.no_command_buffers)


CARD = ""

if __name__ == "__main__":
    main()
