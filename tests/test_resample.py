"""Resample kernel parity: upsample4 and polynomial remap vs the oracle."""

import numpy as np
import pytest

from opticalimageprocessor_tpu.ops import cv_exact, resample


def test_upsample4_matches_oracle(rng):
    src = (rng.random((48, 64), dtype=np.float32) * 4096).astype(np.float32)
    want = cv_exact.resize_cubic_f32_exact(src, 192, 256)
    got = np.asarray(resample.upsample4_f32(src))
    # XLA may contract the multiply-adds into FMAs -> last-ulp differences
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-3)


def test_upsample4_matches_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    src = (rng.random((40, 52), dtype=np.float32) * 1000).astype(np.float32)
    want = cv2.resize(src, (208, 160), interpolation=cv2.INTER_CUBIC)
    got = np.asarray(resample.upsample4_f32(src))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)


def _oracle_maps_from_plan(coeff_x, coeff_y, rows, width):
    """Build the full (rows, W) float32 maps exactly like the reference's
    per-section map fill (preproc.h:443-450): double math then float cast."""
    x = np.arange(width, dtype=np.float64)
    y = np.arange(rows, dtype=np.float64)
    xx = x * 4.0
    yy = y * 4.0
    mapx_col = (coeff_x[1] * xx + coeff_x[0] + xx) / 4.0
    g = (coeff_y[2] * xx * xx + coeff_y[1] * xx + coeff_y[0]) / 4.0
    mapx = np.tile(mapx_col.astype(np.float32)[None, :], (rows, 1))
    mapy = ((yy[:, None] + (coeff_y[2] * xx * xx + coeff_y[1] * xx + coeff_y[0])[None, :]) / 4.0).astype(np.float32)
    return mapx, mapy


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize(
    "cx,cy",
    [
        ((1.5, 0.0002), (-0.75, 0.0001, 1e-8)),
        ((-3.25, -0.0004), (2.5, -0.0002, -2e-8)),
        ((0.0, 0.0), (0.0, 0.0, 0.0)),
    ],
)
def test_remap_polynomial_matches_oracle(cx, cy, quantized, rng):
    rows, width = 96, 256
    src = rng.integers(0, 65536, (rows, width), dtype=np.uint16)
    mapx, mapy = _oracle_maps_from_plan(cx, cy, rows, width)
    want = cv_exact.remap_cubic_u16_exact(src, mapx, mapy, quantized_coords=quantized)
    got = np.asarray(
        resample.remap_polynomial_u16(src, cx, cy, quantized_coords=quantized)
    )
    diff = np.abs(want.astype(np.int32) - got.astype(np.int32))
    # XLA's CPU emitter fuses multiply-adds (FMA), flipping cvRound on a
    # small fraction of last-ulp-boundary pixels vs the numpy oracle.
    assert diff.max() <= 1, (
        f"max {diff.max()} at {np.unravel_index(diff.argmax(), diff.shape)}"
    )
    assert (diff > 0).mean() < 0.02, f"count {(diff > 0).sum()}"


@pytest.mark.parametrize("quantized", [False, True])
def test_remap_polynomial_vs_cv2(quantized):
    cv2 = pytest.importorskip("cv2")
    if quantized:
        pytest.skip("installed cv2 is 5.x (continuous coords)")
    rng = np.random.default_rng(3)
    rows, width = 120, 320
    src = rng.integers(0, 65536, (rows, width), dtype=np.uint16)
    cx, cy = (2.5, -0.0003), (-1.25, 0.0002, 3e-8)
    mapx, mapy = _oracle_maps_from_plan(cx, cy, rows, width)
    want = cv2.remap(src, mapx, mapy, cv2.INTER_CUBIC, borderMode=cv2.BORDER_CONSTANT)
    got = np.asarray(resample.remap_polynomial_u16(src, cx, cy))
    diff = np.abs(want.astype(np.int32) - got.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("dx,dy", [(3.25, -2.5), (-0.875, 0.0), (10.031, 4.97)])
def test_remap_constant_shift_matches_oracle(dx, dy, rng):
    rows, width = 64, 200
    src = rng.integers(0, 65536, (rows, width), dtype=np.uint16)
    # reference map fill (stitcher.h:93-99): double sums cast to float
    x32 = (np.arange(width, dtype=np.float64) + float(dx)).astype(np.float32)
    mapx = np.tile(x32[None, :], (rows, 1))
    mapy = np.tile(
        (np.arange(rows, dtype=np.float64) + float(dy)).astype(np.float32)[:, None],
        (1, width),
    )
    want = cv_exact.remap_cubic_u16_exact(src, mapx, mapy)
    got = np.asarray(resample.remap_constant_shift_u16(src, dx, dy))
    diff = np.abs(want.astype(np.int32) - got.astype(np.int32))
    # see test_remap_polynomial_matches_oracle: CPU FMA fusion, <= 1 DN
    assert diff.max() <= 1, f"max {diff.max()}"
    assert (diff > 0).mean() < 0.02, f"count {(diff>0).sum()}"


def test_remap_const_fast_matches_generic(rng):
    """The constant-shift fast remap (traced-scalar dx/dy, 4 direct row
    taps) equals the generic polynomial fast path on the same translation."""
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.ops import resample

    src = jnp.asarray(rng.integers(0, 65536, (300, 512), dtype=np.uint16))
    for dx, dy in ((-3.2, 2.1), (0.0, 0.0), (5.7, -4.9)):
        want = np.asarray(
            resample.remap_band_fast_chunked(
                src,
                jnp.asarray([4.0 * dx, 0.0], jnp.float32),
                jnp.asarray([4.0 * dy, 0.0, 0.0], jnp.float32),
                chunk_rows=64, row_bound=8,
            )
        )
        got = np.asarray(
            resample.remap_const_fast_chunked(
                src, jnp.float32(dx), jnp.float32(dy),
                chunk_rows=64, row_bound=8,
            )
        )
        d = np.abs(want.astype(np.int32) - got.astype(np.int32))
        assert d.max() <= 1, (dx, dy, d.max())


@pytest.mark.parametrize("chunk_rows", [128, 256, 700])
def test_fast_band_remap_chunking_envelope(rng, chunk_rows):
    """The chunked fast band remap reads true neighbour rows at chunk
    seams: every chunk size agrees with the unchunked remap within the
    fast-path envelope (<= 1 DN), including non-multiple-of-chunk row
    counts and per-column floor(G) variation."""
    import jax.numpy as jnp

    src = jnp.asarray(rng.integers(0, 65536, (700, 1536), dtype=np.uint16))
    cx = jnp.asarray([3.7, -2.1e-4], jnp.float32)
    cy = jnp.asarray([-1.9, 6.5e-4, -3.0e-7], jnp.float32)
    kw = dict(row_bound=4, col_block=128, col_halo=16)
    want = np.asarray(resample.remap_band_fast(src, cx, cy, **kw))
    got = np.asarray(
        resample.remap_band_fast_chunked(
            src, cx, cy, chunk_rows=chunk_rows, **kw
        )
    )
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max {diff.max()}"
    assert (diff > 0).mean() < 0.02, f"count {(diff > 0).sum()}"


def test_fast_band_remap_oracle_envelope(rng):
    """Chunked fast band remap vs the parity-grade plan path: the <= 1 DN
    fast-path envelope."""
    import jax.numpy as jnp

    src = jnp.asarray(rng.integers(0, 65536, (320, 512), dtype=np.uint16))
    cx = jnp.asarray([1.25, -1.0e-4], jnp.float32)
    cy = jnp.asarray([-0.75, 2.0e-4, -1.0e-7], jnp.float32)
    plan = resample.plan_for_band_alignment(
        np.asarray(cx, np.float64), np.asarray(cy, np.float64), 512,
        quantized_coords=False,
    )
    want = np.asarray(resample.remap_section_u16(src, plan))
    got = np.asarray(
        resample.remap_band_fast_chunked(
            src, cx, cy, chunk_rows=128, row_bound=4,
            col_block=128, col_halo=16,
        )
    )
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max {diff.max()}"


@pytest.mark.parametrize("dx,dy", [(-3.2, 2.4), (1.7, -2.9), (0.0, 0.0)])
def test_stitch_tail_matches_separate_stages(rng, dx, dy):
    """The fused chunked dual-CMOS tail (RRC + prestitch remap + seam
    concat in one pass) equals the separate stages: RRC(PAN1) on the
    left, the constant-shift remap of RRC(PAN2) on the right."""
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.ops import rrc

    rows, width, fold = 700, 1536, 100
    pan1 = jnp.asarray(rng.integers(0, 65535, (rows, width), np.uint16))
    pan2 = jnp.asarray(rng.integers(0, 65535, (rows, width), np.uint16))
    p1, p2 = (
        jnp.asarray(
            rrc.split_rrc_params(
                0.98 + 0.04 * rng.random(width), rng.normal(0, 20, width)
            )
        )
        for _ in range(2)
    )
    kw = dict(chunk_rows=256, row_bound=8, col_block=128, col_halo=16)
    stitched, prestt = resample.remap_const_stitch_chunked(
        pan1, pan2, p1, p2, jnp.float32(dx), jnp.float32(dy), fold,
        want_prestt=True, **kw,
    )
    want_p = resample.remap_const_fast_chunked(
        rrc.rrc_apply(pan2, p2), jnp.float32(dx), jnp.float32(dy), **kw
    )
    np.testing.assert_array_equal(np.asarray(prestt), np.asarray(want_p))
    want_left = np.asarray(rrc.rrc_apply(pan1, p1))[:, : width - fold]
    np.testing.assert_array_equal(
        np.asarray(stitched)[:, : width - fold], want_left
    )
    np.testing.assert_array_equal(
        np.asarray(stitched)[:, width - fold :], np.asarray(prestt)[:, fold:]
    )
