"""Device mesh setup for multi-chip runs.

The reference has no distributed backend (SURVEY.md §2.7 — one host, OpenMP,
files); this module is the from-scratch replacement: a 1-D mesh over all
chips, with the kmer table hash-sharded across the axis (SURVEY.md §5.8).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "x"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"need {n_devices} devices, have {len(devices)}")
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def sharded(mesh: Mesh) -> NamedSharding:
    """First-axis sharded layout."""
    return NamedSharding(mesh, P(AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
