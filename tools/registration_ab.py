"""A/B of the fast registration's kx contraction dtype, and RRC bandwidth.

    python tools/registration_ab.py            # on the GPU

Band side of the fast registration (ops/phasecorr.band_window_peaks:
spectral band upsample, whitened cross-power, windowed peak) with the kx
contraction in bfloat16 (float32 accumulation) against float32
``Precision.HIGHEST``:

* stage: 8 registration tiles (16000 x 1228 PAN, 4 x 4000 x 307 band
  tiles, 64 x 64 window), one jitted ``lax.map``;
* registration: ``register_fast`` over a 65536-line scene (10 slices x 4
  sections);
* end to end: the fused scene pipeline (make_device_pipeline) on the same
  scene, serialized per-scene latency.

And the RRC (``rrc_apply`` under XLA) against a plain uint16 copy of the
same size, at 4 x 16384 x 3072 and 65536 x 12288 (4 B moved per pixel).
Times are medians of host-clock calls that end in a readback.  Every
JSON line names the card and its power limit.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from common import card, timeit  # noqa: E402

from opticalimageprocessor_tpu.ops import backend, phasecorr  # noqa: E402

HBM_PEAK_BYTES_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # NVIDIA data sheet
DTYPES = {"bf16": jnp.bfloat16, "f32_highest": jnp.float32}
CARD = None


def emit(**rec) -> None:
    rec["card"] = CARD
    print(json.dumps(rec), flush=True)


def median_ms(fn, *args, n: int = 10) -> float:
    return timeit(fn, args, n)[1]


def stage_ab(tiles: int = 8, band_tile=(4000, 307), win=(64, 64)) -> None:
    rng = np.random.default_rng(0)
    pad = (4 * band_tile[0], 4 * band_tile[1])
    pans = jnp.asarray(rng.random((tiles, *pad), np.float32) * 40000)
    bands = jnp.asarray(
        rng.random((tiles, 4, *band_tile), np.float32) * 40000
    )
    for name, dtype in DTYPES.items():
        run = jax.jit(lambda p, b, dtype=dtype: jax.lax.map(
            lambda t: phasecorr.band_window_peaks(t[0], t[1], pad, win, dtype),
            (p, b),
        ))
        ms = median_ms(run, pans, bands)
        emit(ab="band_stage", dtype=name, tiles=tiles, ms=ms,
             ms_per_tile=ms / tiles)


def registration_and_e2e_ab(lines_pan: int = 65536, slices: int = 10) -> None:
    from bench import _scene_inputs

    from opticalimageprocessor_tpu.models import device_pipeline as dp

    args = _scene_inputs(lines_pan)
    pan1, _pan2, mss, p1, _p2, mp = args
    policy = backend.band_dot_dtype
    try:
        for name, dtype in DTYPES.items():
            run = jax.jit(lambda a, b, c, d, dtype=dtype: dp.register_fast(
                a, b, slices=slices, pan_params=c, mss_params=d,
                dot_dtype=dtype,
            ))
            emit(ab="registration", dtype=name, lines=lines_pan,
                 ms=median_ms(run, pan1, mss, p1, mp, n=5))
            backend.band_dot_dtype = lambda platform=None, dtype=dtype: dtype
            pipe = dp.make_device_pipeline(slices=slices)
            emit(ab="scene_e2e", dtype=name, lines=lines_pan,
                 ms=median_ms(pipe, *args, n=5))
    finally:
        backend.band_dot_dtype = policy


def rrc_ab(shapes=((4, 16384, 3072), (65536, 12288))) -> None:
    from opticalimageprocessor_tpu.ops import rrc

    rng = np.random.default_rng(0)
    peak = HBM_PEAK_BYTES_S.get(jax.devices()[0].device_kind)
    for shape in shapes:
        x = jnp.asarray(rng.integers(0, 65536, shape, dtype=np.uint16))
        cols = shape[-1]
        par = jnp.asarray(rrc.split_rrc_params(
            0.98 + 0.04 * rng.random(cols), rng.normal(0, 20, cols)
        ))
        f = jax.jit(jax.vmap(rrc.rrc_apply, (0, None))) if x.ndim == 3 \
            else rrc.rrc_apply
        ms = median_ms(f, x, par, n=20)
        copy_ms = median_ms(jax.jit(lambda a: a ^ jnp.uint16(1)), x, n=20)
        nbytes = 4 * x.size
        emit(ab="rrc", shape=list(shape), ms=ms, copy_ms=copy_ms,
             gb_s=nbytes / ms / 1e6, copy_gb_s=nbytes / copy_ms / 1e6,
             share_of_copy=copy_ms / ms,
             share_of_peak=(nbytes / (ms / 1e3) / peak) if peak else None)


def main() -> None:
    global CARD
    if jax.devices()[0].platform != "gpu":
        sys.exit("no CUDA device")
    CARD = card()
    print("stage paths:", backend.stage_paths(), file=sys.stderr)
    rrc_ab()
    stage_ab()
    registration_and_e2e_ab()


if __name__ == "__main__":
    main()
