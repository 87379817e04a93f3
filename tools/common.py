"""Shared helpers for the perf tools: the card's identity and timing that
ends in a device-to-host readback."""

from __future__ import annotations

import subprocess
import time

import numpy as np


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them (every
    number a tool prints is kept beside this line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def timeit(fn, args, n=5):
    """(min_ms, median_ms) of n calls, each blocked on and read back (the
    first element of the first output leaf)."""
    import jax

    def sync(out):
        # one scalar readback after block_until_ready: every output of the
        # executable is complete by then
        jax.block_until_ready(out)
        leaf = jax.tree.leaves(out)[0]
        _ = np.asarray(leaf.reshape(-1)[0])

    sync(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts) * 1e3, float(np.median(ts)) * 1e3
