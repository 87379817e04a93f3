"""Stage-split timing of the fused scene pipeline on the current device.

Times each sub-program of make_device_pipeline separately (jit-wrapped,
forced readback, min/median of N) plus the whole pipeline, so the PERF.md
"Where the time goes" table can be refreshed in ONE same-process run
(times from two runs may come from two cards with other power limits).

Usage: python tools/stage_split.py [--lines 65536] [--n 5]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from common import card, timeit  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lines", type=int, default=65536)
    ap.add_argument("--n", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.constants import (
        MSS_BANDS,
        PIXELS_PER_LINE,
        PIXELS_PER_MSSBAND,
    )
    from opticalimageprocessor_tpu.models import device_pipeline as dp
    from opticalimageprocessor_tpu.ops import resample, rrc

    rng = np.random.default_rng(0)
    lines = args.lines
    lines_mss = lines // MSS_BANDS
    pan1 = jnp.asarray(
        rng.integers(0, 65535, (lines, PIXELS_PER_LINE), np.uint16)
    )
    pan2 = jnp.asarray(
        rng.integers(0, 65535, (lines, PIXELS_PER_LINE), np.uint16)
    )
    mss = jnp.asarray(
        rng.integers(
            0, 65535, (MSS_BANDS, lines_mss, PIXELS_PER_MSSBAND), np.uint16
        )
    )
    p1p = jnp.asarray(
        rrc.split_rrc_params(
            0.98 + 0.04 * rng.random(PIXELS_PER_LINE),
            rng.normal(0, 20, PIXELS_PER_LINE),
        )
    )
    msp = jnp.asarray(
        np.stack(
            [
                rrc.split_rrc_params(
                    0.98 + 0.04 * rng.random(PIXELS_PER_MSSBAND),
                    rng.normal(0, 20, PIXELS_PER_MSSBAND),
                )
            ]
            * MSS_BANDS
        )
    )
    cx = jnp.asarray([0.8, -1.2e-5], jnp.float32)
    cy = jnp.asarray([1.5, 1.0e-5, -3e-10], jnp.float32)

    d = jax.devices()[0]
    print(f"device={d.platform}/{d.device_kind} lines={lines}")
    if d.platform == "gpu":
        print(f"card: {card()}")

    # RRC of the 4 MSS bands (feeds registration + align)
    f_rrc = jax.jit(
        lambda m, p: jnp.stack(
            [rrc.rrc_apply(m[i], p[i]) for i in range(MSS_BANDS)]
        )
    )
    mss_c = f_rrc(mss, msp)
    mn, md = timeit(f_rrc, (mss, msp), args.n)
    print(f"rrc_mss x4:        min={mn:6.1f} med={md:6.1f} ms")

    # registration (tile-inline PAN RRC; band side as ops/backend picks)
    f_reg = jax.jit(
        lambda p, m, pp: dp.register_fast(p, m, pan_params=pp)[1]
    )
    mn, md = timeit(f_reg, (pan1, mss_c, p1p), args.n)
    print(f"register:          min={mn:6.1f} med={md:6.1f} ms")

    # stt estimation
    f_stt = jax.jit(lambda a, b: dp.stt_estimate_fast(a, b))
    mn, md = timeit(f_stt, (pan1, pan2), args.n)
    print(f"stt:               min={mn:6.1f} med={md:6.1f} ms")

    # 4-band alignment resample
    f_align = jax.jit(
        lambda m: jnp.stack(
            [
                resample.remap_band_fast_chunked(
                    m[i], cx, cy, chunk_rows=512, row_bound=3,
                    col_block=128, col_halo=16,
                )
                for i in range(MSS_BANDS)
            ],
            axis=-1,
        )
    )
    mn, md = timeit(f_align, (mss_c,), args.n)
    print(f"align resample x4: min={mn:6.1f} med={md:6.1f} ms")

    # fused stitch tail (RRC(PAN1) ++ remap(RRC(PAN2)))
    f_st = jax.jit(
        lambda a, b: resample.remap_const_stitch_chunked(
            a, b, p1p, p1p, jnp.float32(-3.2), jnp.float32(2.4), 200,
            chunk_rows=512, row_bound=8, col_block=128, col_halo=16,
        )
    )
    mn, md = timeit(f_st, (pan1, pan2), args.n)
    print(f"stitch tail:       min={mn:6.1f} med={md:6.1f} ms")

    # whole pipeline
    pipe = dp.make_device_pipeline()
    mn, md = timeit(pipe, (pan1, pan2, mss, p1p, p1p, msp), args.n)
    print(f"full pipeline:     min={mn:6.1f} med={md:6.1f} ms")


if __name__ == "__main__":
    main()
