"""Device mesh construction for strip processing.

The unbounded axis of a push-broom scene is the line (row) axis; the
framework shards it across devices — the moral equivalent of sequence
parallelism for imagery (SURVEY §2: the reference's 20000-line sections with
halo overlap become line-sharding + `ppermute` halo exchange between devices).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

LINE_AXIS = "line"


def line_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the line axis."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (LINE_AXIS,))


def line_sharding(mesh: Mesh) -> NamedSharding:
    """Rows sharded, columns replicated."""
    return NamedSharding(mesh, P(LINE_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(rows: int, n: int) -> int:
    return (rows + n - 1) // n * n
