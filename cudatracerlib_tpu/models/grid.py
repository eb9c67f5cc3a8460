"""Per-cell model grids: map world positions onto a regular grid of model
instances (GMMs, histograms).

Counterpart of reference ``Kernel/ParametricModels/GridModelBuffer.h``
(192 LoC: a device buffer of per-cell models addressed by quantized
position). Translation: the "buffer of models" IS the batched model
state (models/gmm.py fits all cells in parallel); this module only supplies
the position -> flat cell index map, mirroring accel/hashgrid.py cell logic.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class ModelGrid(NamedTuple):
    box_min: jnp.ndarray   # (3,)
    inv_cell: jnp.ndarray  # (3,)
    res: int


def make_model_grid(box_min, box_max, res: int) -> ModelGrid:
    box_min = jnp.asarray(box_min, jnp.float32)
    box_max = jnp.asarray(box_max, jnp.float32)
    return ModelGrid(
        box_min=box_min,
        inv_cell=res / jnp.maximum(box_max - box_min, 1e-9),
        res=res,
    )


def cell_of_position(grid: ModelGrid, p):
    """World position (..., 3) -> flat cell id in [0, res^3)."""
    q = jnp.floor((p - grid.box_min) * grid.inv_cell).astype(jnp.int32)
    q = jnp.clip(q, 0, grid.res - 1)
    return (q[..., 0] * grid.res + q[..., 1]) * grid.res + q[..., 2]


def n_cells(grid: ModelGrid) -> int:
    return grid.res ** 3
