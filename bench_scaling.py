"""Scaling-efficiency harness: rays/s at 1 device / N simulated hosts.

The BASELINE north star is "≥80% rays/s scaling efficiency" across hosts
(BASELINE.json). The reference has no distributed story at all (SURVEY.md §2.8),
so the procedure here is the JAX-native one:

  * every measurement runs the SAME sharded render (parallel/shard.py
    make_sharded_render) over a parallel/distributed.py host_mesh;
  * WEAK scaling: the per-device ray load is held constant (total spp grows
    with the device count), so ideal scaling is flat per-device throughput and
      efficiency(N) = rays_per_sec(N) / (N * rays_per_sec(1));
  * multi-HOST runs use jax.distributed + Gloo CPU collectives when no pod is
    available: `python bench_scaling.py` self-launches N worker processes on
    localhost (each a separate jax runtime with its own CPU devices), which
    is the real multi-process code path minus the physical interconnect.

Usage:
    python bench_scaling.py                   # full ladder, prints JSON lines
    python bench_scaling.py --hosts 2 --devices-per-host 4
    # on real GPU hosts, run one process per host:
    JAX_COORDINATOR_ADDRESS=h0:1234 JAX_NUM_PROCESSES=4 JAX_PROCESS_ID=$i \
        python bench_scaling.py --role pod

Output: one JSON line per rung plus a final summary line
    {"metric": "multi-host weak-scaling efficiency", "value": ..., ...}
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# workload: Cornell box, path depth 5 (BASELINE config 1 geometry) — small
# enough that CPU workers finish in seconds, big enough to dominate dispatch
W = H = 128
SPP_PER_DEV = 4
MAX_DEPTH = 5
TIMED_PASSES = 3


def _measure(n_sp_devices: int) -> dict:
    """Run the weak-scaling workload on the current (possibly multi-process)
    runtime over all global devices; returns {"rays_per_s", "n_devices"}."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cudatracerlib_tpu.parallel.distributed import host_mesh, sync_hosts
    from cudatracerlib_tpu.parallel.shard import (make_sharded_render,
                                                  replicate_scene)
    from cudatracerlib_tpu.render.path_tracer import PTConfig
    from cudatracerlib_tpu.scene.shapes import cornell_box

    n_dev = jax.device_count()
    mesh = host_mesh(n_sp=1)
    scene = replicate_scene(cornell_box(), mesh)
    spp = SPP_PER_DEV * n_dev  # weak scaling: constant rays per device
    cfg = PTConfig(max_depth=MAX_DEPTH)
    fn = make_sharded_render(mesh, W, H, spp, cfg, with_stats=True)

    img, n_rays = fn(scene, jnp.uint32(0))  # compile + warm
    jax.block_until_ready(img)
    rays_per_pass = float(np.asarray(n_rays))

    sync_hosts("bench_start")
    t0 = time.perf_counter()
    for i in range(TIMED_PASSES):
        img, n_rays = fn(scene, jnp.uint32(1 + i))
    jax.block_until_ready(img)
    dt = (time.perf_counter() - t0) / TIMED_PASSES
    sync_hosts("bench_end")
    return {
        "rays_per_s": rays_per_pass / dt,
        "rays_per_pass": rays_per_pass,
        "n_devices": n_dev,
        "n_processes": jax.process_count(),
        "platform": jax.devices()[0].platform,
    }


def role_worker(args) -> None:
    """One simulated host: CPU runtime with its own virtual devices."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices_per_host}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    from cudatracerlib_tpu.parallel.distributed import init_distributed

    init_distributed(coordinator_address=args.coordinator,
                     num_processes=args.num_processes,
                     process_id=args.process_id)
    res = _measure(args.devices_per_host)
    if jax.process_index() == 0:
        print("WORKER_RESULT " + json.dumps(res), flush=True)


def role_pod(args) -> None:
    """Real multi-host run: one process per host, launched externally with
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID."""
    from cudatracerlib_tpu.parallel.distributed import init_distributed

    init_distributed()
    import jax

    res = _measure(jax.local_device_count())
    if jax.process_index() == 0:
        print(json.dumps({"metric": "pod rays/s", "unit": "rays/s", **res}),
              flush=True)


def _launch_ladder(n_hosts: int, devices_per_host: int, port: int,
                   cores_per_host: int | None = None) -> dict:
    """Spawn n_hosts localhost worker processes; return the parsed result.

    Each simulated host is pinned (taskset) to its own physical-core set so
    the hosts don't time-share one core — without pinning, "2 hosts" on a
    2-core box measures oversubscription, not scaling. The 1-host baseline
    must pass the SAME cores_per_host as the N-host rung for the efficiency
    ratio to compare equal per-host machines."""
    n_cores = os.cpu_count() or 1
    if cores_per_host is None:
        cores_per_host = max(n_cores // n_hosts, 1)
    procs = []
    # the simulated hosts are CPU runtimes; they never open the GPU
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for i in range(n_hosts):
        lo = (i * cores_per_host) % n_cores
        hi = lo + cores_per_host - 1
        pin = ["taskset", "-c", f"{lo}-{hi}" if hi > lo else str(lo)]
        procs.append(subprocess.Popen(
            pin + [sys.executable, os.path.join(REPO, "bench_scaling.py"),
                   "--role", "worker", "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(n_hosts), "--process-id", str(i),
                   "--devices-per-host", str(devices_per_host)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, cwd=REPO, env=env,
        ))
    out0, _ = procs[0].communicate(timeout=1200)
    for p in procs[1:]:
        p.communicate(timeout=1200)
    for line in out0.splitlines():
        if line.startswith("WORKER_RESULT "):
            return json.loads(line[len("WORKER_RESULT "):])
    raise RuntimeError(f"worker 0 produced no result:\n{out0}")


def role_driver(args) -> None:
    results = {}

    # rung 0: one device of the default platform (the GPU on a GPU host);
    # a failure here ends the run with its traceback
    results["single_chip"] = _measure_single_chip()

    # rungs 1..N: simulated hosts on CPU (1 host is the efficiency baseline;
    # both rungs get identical per-host cores so the ratio is pure scaling)
    port = args.port
    cph = max((os.cpu_count() or 1) // args.hosts, 1)
    one = _launch_ladder(1, args.devices_per_host, port, cores_per_host=cph)
    nh = _launch_ladder(args.hosts, args.devices_per_host, port + 1,
                        cores_per_host=cph)
    results["one_host"] = one
    results["n_hosts"] = nh
    eff = nh["rays_per_s"] / (args.hosts * one["rays_per_s"])
    for name in ("one_host", "n_hosts"):
        r = results[name]
        print(json.dumps({
            "metric": f"weak-scaling {name} ({r['n_processes']} proc x "
                      f"{r['n_devices'] // r['n_processes']} dev, CPU-sim)",
            "value": round(r["rays_per_s"] / 1e6, 3), "unit": "Mrays/s",
        }), flush=True)
    summary = {
        "metric": f"multi-host weak-scaling efficiency "
                  f"({args.hosts} hosts x {args.devices_per_host} devices, "
                  f"CPU-sim)",
        "value": round(eff, 3),
        "unit": "fraction",
        "vs_baseline": round(eff / 0.80, 3),  # bar: >=80% (BASELINE.json)
        "single_chip_Mrays_s": round(
            results["single_chip"]["rays_per_s"] / 1e6, 2),
        "single_chip_platform": results["single_chip"]["platform"],
        "single_chip_kind": results["single_chip"]["kind"],
    }
    print(json.dumps(summary), flush=True)


def _measure_single_chip() -> dict:
    import jax

    prev = jax.device_count()
    res = _measure_on_devices([jax.devices()[0]])
    res["all_local_devices"] = prev
    return res


def _measure_on_devices(devices) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cudatracerlib_tpu.parallel.distributed import host_mesh
    from cudatracerlib_tpu.parallel.shard import (make_sharded_render,
                                                  replicate_scene)
    from cudatracerlib_tpu.render.path_tracer import PTConfig
    from cudatracerlib_tpu.scene.shapes import cornell_box

    n_dev = len(devices)
    mesh = host_mesh(n_sp=1, devices=devices)
    scene = replicate_scene(cornell_box(), mesh)
    cfg = PTConfig(max_depth=MAX_DEPTH)
    fn = make_sharded_render(mesh, W, H, SPP_PER_DEV * n_dev, cfg,
                             with_stats=True)
    img, n_rays = fn(scene, jnp.uint32(0))
    jax.block_until_ready(img)
    rays_per_pass = float(np.asarray(n_rays))
    t0 = time.perf_counter()
    for i in range(TIMED_PASSES):
        img, n_rays = fn(scene, jnp.uint32(1 + i))
    jax.block_until_ready(img)
    dt = (time.perf_counter() - t0) / TIMED_PASSES
    return {
        "rays_per_s": rays_per_pass / dt,
        "n_devices": n_dev,
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=["driver", "worker", "pod"],
                    default="driver")
    ap.add_argument("--hosts", type=int, default=2)
    # 1 virtual device per simulated host by default: the CI box has few
    # cores, and pinned 1-core hosts are the only configuration where CPU-sim
    # efficiency reflects collective overhead rather than core contention
    ap.add_argument("--devices-per-host", type=int, default=1)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--port", type=int, default=12731)
    args = ap.parse_args()
    if args.role == "worker":
        role_worker(args)
    elif args.role == "pod":
        role_pod(args)
    else:
        role_driver(args)


if __name__ == "__main__":
    main()
