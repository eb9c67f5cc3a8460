"""Multi-HOST execution: jax.distributed bring-up + host-aware meshes.

The reference is strictly single-GPU — no MPI/NCCL anywhere (SURVEY.md §2.8),
so this module has no counterpart file; it is the new capability the rebuild's
north star requires ("N-host scaling efficiency", BASELINE.json). The design
follows the standard JAX multi-process recipe:

  * every host runs the SAME program; `jax.distributed.initialize` wires the
    processes into one global runtime, given an explicit coordinator
    address, process count and process id (nothing discovers them);
  * meshes are built over `jax.devices()` (all devices of all hosts),
    process-major, so a ("dp","sp") mesh puts each host's devices
    contiguous on the trailing mesh dim — collectives reduce within the
    host first and only cross hosts for the final combine;
  * the render/train shard_maps in parallel/shard.py are topology-agnostic:
    handed a multi-host mesh they run unchanged, with XLA lowering the film
    `psum` / gradient all-reduce to NCCL (GPU) or Gloo (CPU) collectives.

On CPU (tests, CI) multi-process collectives use the Gloo backend over
localhost sockets — the multi-host code path minus the physical
interconnect, which is what a scaling-efficiency *harness* needs to
validate (bench_scaling.py measures it; tests/test_multihost.py asserts the
numerics match single-process execution).
"""
from __future__ import annotations

import os
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids: Sequence[int] | None = None) -> bool:
    """Idempotent multi-process bring-up.

    With no arguments, initializes only when the environment says we are part
    of a multi-process job (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID), so single-process runs stay single-process. Returns
    True iff jax.distributed is live afterwards.

    On CPU backends the Gloo collectives implementation is enabled first —
    without it, cross-process psum/all_gather would fail to compile.
    """
    from jax._src import distributed as _dist  # no public state accessor yet
    if _dist.global_state.client is not None:  # already initialized
        return True

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None:
        return False  # single-process run

    try:
        # CPU multi-process needs Gloo for cross-process collectives
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # older/newer jax without the option: best effort
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True


def host_mesh(n_sp: int = 1, devices: Sequence[jax.Device] | None = None
              ) -> Mesh:
    """("dp", "sp") mesh over every device of every host, host-contiguous.

    `jax.devices()` enumerates process-major, so reshaping to
    (n_total // n_sp, n_sp) keeps one host's devices adjacent along both
    mesh axes: the `sp` (inner) axis never leaves a host when n_sp divides
    the per-host device count, and the `dp` reduce runs its within-host
    stage before it crosses hosts.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    assert n % n_sp == 0, (n, n_sp)
    devs = np.asarray(devices).reshape(n // n_sp, n_sp)
    return Mesh(devs, ("dp", "sp"))


def process_topology() -> dict:
    """Small report of the distributed layout (for logs / bench output)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
        "platform": jax.devices()[0].platform,
    }


def sync_hosts(name: str = "barrier") -> None:
    """Cross-host barrier: all processes reach `name` before any proceeds.

    Used by the scaling bench so timing windows line up across hosts
    (a straggler host would otherwise charge its queue delay to compute).
    """
    if jax.process_count() == 1:
        return
    from jax._src import distributed as _dist
    _dist.global_state.client.wait_at_barrier(name, timeout_in_ms=120_000)
