"""Validate the numpy parity oracle bit-for-bit against the installed OpenCV.

The oracle (ops/cv_exact.py) encodes the semantics the C++ reference gets
from cv::remap / cv::resize / cv::phaseCorrelate; these tests pin the oracle
to the real library so the device kernels can be tested against the oracle with
confidence.
"""

import numpy as np
import pytest

from opticalimageprocessor_tpu.ops import cv_exact

cv2 = pytest.importorskip("cv2")


def test_optimal_dft_size():
    for n in [1, 2, 3, 7, 11, 128, 200, 1228, 1250, 16000, 12289, 99991]:
        assert cv_exact.get_optimal_dft_size(n) == cv2.getOptimalDFTSize(n)


def test_cubic_weights_match_opencv_tables(rng):
    # Sanity: weights sum to ~1 and match the known OpenCV A=-0.75 kernel.
    t = rng.random(1000, dtype=np.float32)
    w = cv_exact.interpolate_cubic_f32(t)
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=2e-6)
    w0 = cv_exact.interpolate_cubic_f32(np.float32(0.0))
    np.testing.assert_array_equal(w0, np.array([0, 1, 0, 0], np.float32))


def _assert_remap_envelope(want, got, max_mismatch_frac=0.01):
    """The oracle is the spec; the installed cv2 5.x SIMD kernel may differ
    in last-ulp accumulation order, which after cvRound shows as occasional
    +-1 DN.  Assert that envelope: max |diff| <= 1 DN, on < 1% of pixels."""
    diff = np.abs(want.astype(np.int32) - got.astype(np.int32))
    assert diff.max() <= 1, f"max DN diff {diff.max()}"
    frac = float((diff > 0).mean())
    assert frac < max_mismatch_frac, f"mismatch fraction {frac}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_remap_cubic_u16_vs_cv2(seed):
    rng = np.random.default_rng(seed)
    h, w = 64, 96
    src = rng.integers(0, 65536, size=(h, w), dtype=np.uint16)
    # maps spanning interior, borders, and fully-outside regions
    mapx = (
        rng.random((h, w), dtype=np.float32) * (w + 16) - 8.0
    ).astype(np.float32)
    mapy = (
        rng.random((h, w), dtype=np.float32) * (h + 16) - 8.0
    ).astype(np.float32)
    want = cv2.remap(src, mapx, mapy, cv2.INTER_CUBIC, borderMode=cv2.BORDER_CONSTANT)
    got = cv_exact.remap_cubic_u16_exact(src, mapx, mapy)
    assert want.dtype == got.dtype
    _assert_remap_envelope(want, got)


def test_remap_cubic_u16_smooth_maps():
    # Maps shaped like the real alignment maps: x + small poly shift.
    rng = np.random.default_rng(7)
    h, w = 200, 256
    src = rng.integers(0, 65536, size=(h, w), dtype=np.uint16)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    mapx = ((1.0003 * xx - 2.25)).astype(np.float32)
    mapy = (yy + 1e-7 * xx * xx + 3.1e-4 * xx - 0.75).astype(np.float32)
    want = cv2.remap(src, mapx, mapy, cv2.INTER_CUBIC, borderMode=cv2.BORDER_CONSTANT)
    got = cv_exact.remap_cubic_u16_exact(src, mapx, mapy)
    _assert_remap_envelope(want, got)


def test_remap_quantized_mode_self_consistent():
    # OpenCV<=4.x semantics: coordinates snap to the 1/32 grid, so perturbing
    # a map value by < 1/64 px must not change the output.
    rng = np.random.default_rng(11)
    h, w = 32, 48
    src = rng.integers(0, 65536, size=(h, w), dtype=np.uint16)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mapx = xx + np.float32(0.25)
    mapy = yy + np.float32(0.125)
    a = cv_exact.remap_cubic_u16_exact(src, mapx, mapy, quantized_coords=True)
    b = cv_exact.remap_cubic_u16_exact(
        src, mapx + np.float32(0.01), mapy, quantized_coords=True
    )
    np.testing.assert_array_equal(a, b)
    # and at exact 1/32 grid points both modes use the same weights
    c = cv_exact.remap_cubic_u16_exact(src, mapx, mapy, quantized_coords=False)
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("shape,factor", [((64, 96), 4), ((37, 53), 4), ((64, 96), 2)])
def test_resize_cubic_f32_vs_cv2(shape, factor, rng):
    src = rng.random(shape, dtype=np.float32) * 4096
    want = cv2.resize(
        src, (shape[1] * factor, shape[0] * factor), interpolation=cv2.INTER_CUBIC
    )
    got = cv_exact.resize_cubic_f32_exact(src, shape[0] * factor, shape[1] * factor)
    # last-ulp accumulation-order differences only
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-2)


def test_resize_cubic_impulse_bit_exact():
    src = np.zeros((8, 16), np.float32)
    src[4, 8] = 1.0
    want = cv2.resize(src, (64, 32), interpolation=cv2.INTER_CUBIC)
    got = cv_exact.resize_cubic_f32_exact(src, 32, 64)
    np.testing.assert_array_equal(got, want)


def test_phase_correlate_matches_cv2(rng):
    base = rng.random((128, 160), dtype=np.float64) * 100
    # shift by (3.0, -2.0) whole pixels via roll for a clean peak
    shifted = np.roll(np.roll(base, 3, axis=1), -2, axis=0)
    a32 = base.astype(np.float32)
    b32 = shifted.astype(np.float32)
    (dx, dy), resp = cv2.phaseCorrelate(a32, b32)
    mdx, mdy, mresp = cv_exact.phase_correlate(a32, b32, precision=np.float32)
    assert abs(mdx - dx) < 1e-4 and abs(mdy - dy) < 1e-4
    assert abs(mresp - resp) < 1e-5
    # the synthetic shift is recovered
    assert abs(dx - 3.0) < 0.05 and abs(dy - (-2.0)) < 0.05


def test_phase_correlate_subpixel_vs_cv2(rng):
    # Non-integer shift through cv2.warpAffine, non-optimal DFT size (pads).
    base = (rng.random((150, 201)) * 1000).astype(np.float32)
    m = np.float32([[1, 0, 1.6], [0, 1, -0.4]])
    shifted = cv2.warpAffine(base, m, (201, 150), flags=cv2.INTER_LINEAR)
    (dx, dy), resp = cv2.phaseCorrelate(base, shifted)
    mdx, mdy, mresp = cv_exact.phase_correlate(base, shifted, precision=np.float32)
    assert abs(mdx - dx) < 1e-3 and abs(mdy - dy) < 1e-3
    assert abs(mresp - resp) < 1e-4


def test_rrc_exact_contract():
    src = np.array([[0, 1, 1000, 65535]], dtype=np.uint16)
    k = np.array([1.0, 2.5, 1.0, 1.5])
    b = np.array([0.0, -10.0, -0.5, 10.0])
    out = cv_exact.rrc_exact(src, k, b)
    # trunc toward zero; negative wraps two's complement; overflow wraps
    assert out[0, 0] == 0
    assert out[0, 1] == np.uint16((int(2.5 * 1 - 10.0) + (1 << 16)) % (1 << 16))
    assert out[0, 2] == 999  # 999.5 truncates
    assert out[0, 3] == (int(1.5 * 65535 + 10.0)) % (1 << 16)
