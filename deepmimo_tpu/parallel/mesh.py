"""Device-mesh construction for multi-chip channel generation.

The natural parallel axes of the workload (reference SURVEY §2.9):
- ``users``: every per-user computation is independent -> data parallel.
- ``tile``: subcarrier/antenna tiles of the output tensor -> model parallel.

Shardings are expressed with ``jax.sharding`` NamedSharding; XLA inserts the
collectives (psum for parameter gradients, all-gathers where needed).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

USERS_AXIS = "users"
TILE_AXIS = "tile"


def default_mesh_shape(n_devices: int, tile: int = 1) -> Tuple[int, int]:
    """Split devices into (users, tile) axes; tile divides n_devices."""
    if n_devices % tile != 0:
        raise ValueError(f"tile={tile} must divide n_devices={n_devices}")
    return (n_devices // tile, tile)


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              tile: int = 1) -> Mesh:
    """Create a (users, tile) mesh over the given (or all) devices.

    The GPUs of one host reach each other all to all (NVLink), so the
    mesh follows the algorithm alone: users data-parallel, tiles of the
    output tensor on the second axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    users, tiles = default_mesh_shape(len(devices), tile)
    dev_array = np.array(devices).reshape(users, tiles)
    return Mesh(dev_array, axis_names=(USERS_AXIS, TILE_AXIS))


def user_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (user) axis; replicate the rest."""
    return NamedSharding(mesh, P(USERS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def channel_sharding(mesh: Mesh, ndim: int = 4) -> NamedSharding:
    """Shard channels [users, rx, tx, k(, t)]: users over the users axis,
    subcarriers over the tile axis."""
    spec = [USERS_AXIS] + [None] * (ndim - 2) + [TILE_AXIS]
    return NamedSharding(mesh, P(*spec))
