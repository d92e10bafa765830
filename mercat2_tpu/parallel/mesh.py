"""Device mesh construction for the counting engine.

The mesh has two logical axes:

- ``data``: shards of the packed sequence stream (sample/chunk DP — the
  device mapping of the reference's per-chunk Ray tasks,
  /root/reference/bin/mercat2.py:118-120).
- ``bins``: shards of the dense histogram keyspace (TP analog; partial
  histograms reduce-scatter over ``data`` so each device owns a bin range).

On a single device both axes are 1. The split follows the algorithm alone
(every device reaches every other at the same rate); callers can override.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

__all__ = ["make_mesh", "mesh_shape_for"]


def mesh_shape_for(n_devices: int, bins_parallel: int | None = None) -> tuple[int, int]:
    """Pick a (data, bins) split of ``n_devices``.

    Default: bins axis of 2 when it divides evenly and there are >= 4
    devices (keeps most parallelism on the embarrassingly-parallel data
    axis; the bins axis only pays off when the histogram is large).
    """
    if bins_parallel is None:
        bins_parallel = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    if n_devices % bins_parallel:
        raise ValueError(f"bins_parallel={bins_parallel} must divide {n_devices}")
    return n_devices // bins_parallel, bins_parallel


def make_mesh(n_devices: int | None = None, bins_parallel: int | None = None) -> Mesh:
    """Build a ('data', 'bins') mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    data, bins = mesh_shape_for(n_devices, bins_parallel)
    grid = np.asarray(devices[:n_devices]).reshape(data, bins)
    return Mesh(grid, axis_names=("data", "bins"))
