"""Halo exchange over the sharded line axis.

The cubic resample needs a few rows of context beyond each device's local
block (kernel support + the fitted dy range).  Each device sends its edge
rows to its neighbours with `jax.lax.ppermute` between devices and pads the strip
ends with the border value 0 — reproducing, across devices, exactly what the
reference's in-process sectioning reads (BORDER_CONSTANT at strip ends,
neighbour rows elsewhere).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exchange_halo(x: jax.Array, top: int, bottom: int, axis_name: str):
    """Return ``x`` extended with ``top`` rows from the previous shard and
    ``bottom`` rows from the next (zeros at the strip ends).

    ``x``: (local_rows, W) block inside a shard_map over ``axis_name``.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    out = [x]
    if top > 0:
        # receive the last `top` rows of the previous device
        send_down = [(i, i + 1) for i in range(n - 1)]
        prev_tail = jax.lax.ppermute(x[-top:], axis_name, send_down)
        prev_tail = jnp.where(idx > 0, prev_tail, jnp.zeros_like(prev_tail))
        out.insert(0, prev_tail)
    if bottom > 0:
        send_up = [(i + 1, i) for i in range(n - 1)]
        next_head = jax.lax.ppermute(x[:bottom], axis_name, send_up)
        next_head = jnp.where(
            idx < n - 1, next_head, jnp.zeros_like(next_head)
        )
        out.append(next_head)
    return jnp.concatenate(out, axis=0)
