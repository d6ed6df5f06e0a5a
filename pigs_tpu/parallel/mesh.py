"""Device-mesh construction and sharding helpers.

The reference is strictly single-GPU (SURVEY.md §2.2 parallelism inventory); this
layer is the additive distributed design: a 2D mesh with a ``data``
axis (collocation samples / query points) and a ``model`` axis (Gaussian
primitives).  Collectives are XLA's (psum within ``shard_map``), which it
hands to NCCL on GPUs.  Every GPU of a host reaches every other at the same
rate, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_sharding", "model_sharding", "replicated",
           "DATA_AXIS", "MODEL_AXIS"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Create a ``(data, model)`` mesh over the available devices.

    Default: all devices on the ``data`` axis (the sample/collocation dimension
    scales furthest — n_samples >> n_gaussians in every reference config).
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices), 1)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis sharded over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def model_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis sharded over the model (Gaussian) axis."""
    return NamedSharding(mesh, P(MODEL_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
