"""Mesh helpers. The reference is single-process (SURVEY.md §2.7: no
MPI/NCCL anywhere); multi-device scale-out is this framework's addition,
expressed through jax.sharding.Mesh + shard_map collectives."""

from __future__ import annotations

import jax
import numpy as np


def make_mesh(num_devices: int | None = None,
              axis_name: str = "x") -> jax.sharding.Mesh:
    devs = jax.devices()
    n = num_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    return jax.sharding.Mesh(np.array(devs[:n]), (axis_name,))
