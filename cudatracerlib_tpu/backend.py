"""The one place the program chooses between its GPU and CPU code paths.

The choice follows the platform a computation is *lowered* for, not the
process's default device: a GPU host that runs a computation on its CPU
devices gets the CPU path for it. Both branches are traced; lowering keeps
the one for the target platform. A platform other than CUDA or the CPU has
no branch, so lowering for it fails instead of guessing.
"""
from __future__ import annotations

import jax


def by_platform(*args, gpu, cpu):
    """`gpu(*args)` when lowered for a CUDA GPU, `cpu(*args)` when lowered
    for the CPU; an error for any other platform."""
    return jax.lax.platform_dependent(*args, cuda=gpu, cpu=cpu)
