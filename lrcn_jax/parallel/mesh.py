"""Device-mesh construction for multi-chip LRCN training.

The reference is strictly single-process single-GPU (SURVEY.md §2, parallelism
table: no DP/TP/PP/SP/EP, no NCCL/MPI) — this module is a new
addition.  We scale with a 2-D ``jax.sharding.Mesh``:

- axis ``data``: data parallelism — the batch dimension is sharded across it
  and XLA inserts the gradient all-reduce (NCCL between GPUs);
- axis ``model``: tensor parallelism over the vocabulary dimension — the
  embedding table, output projection and logits shard across it (the decoder's
  largest matmuls; everything else is replicated at this model scale).

Shardings are expressed as ``NamedSharding`` annotations on a jitted step and
GSPMD places the collectives (the scaling-book recipe: pick a mesh, annotate,
let XLA insert collectives).
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from lrcn_jax.config import LRCNConfig


def make_mesh(shape: Sequence[int] = (-1, 1),
              axis_names: Sequence[str] = ("data", "model"),
              devices: Sequence[jax.Device] | None = None) -> Mesh:
    """Build a mesh over the available devices.

    A single ``-1`` entry in ``shape`` absorbs all remaining devices (so
    ``(-1, 1)`` is "pure DP over everything").
    """
    devices = list(devices if devices is not None else jax.devices())
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError(f"at most one -1 wildcard allowed, got {shape}")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if len(devices) % known:
            raise ValueError(
                f"{len(devices)} devices not divisible by fixed mesh dims "
                f"{known}")
        shape[shape.index(-1)] = len(devices) // known
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n} devices, have "
            f"{len(devices)}")
    grid = np.asarray(devices[:n]).reshape(shape)
    return Mesh(grid, tuple(axis_names))


def mesh_from_config(cfg: LRCNConfig,
                     devices: Sequence[jax.Device] | None = None) -> Mesh:
    return make_mesh(cfg.mesh_shape, cfg.mesh_axis_names, devices)
