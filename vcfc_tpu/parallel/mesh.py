"""Device mesh construction.

The engine is data-parallel over variant lines (every compressed line is
self-contained — the property the reference's per-line format guarantees,
compress.cpp:5).  A flat 1-D mesh over all devices carries the line axis;
the collectives (psum for histograms, all_gather for shard byte counts)
are tiny, and every card reaches every other at the same rate, so the
mesh follows the algorithm alone.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

DATA_AXIS = "data"


def make_data_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (DATA_AXIS,))
