"""Phase-correlation op: parity vs cv2/oracle and batch consistency."""

import numpy as np
import pytest

from opticalimageprocessor_tpu.ops import cv_exact, phasecorr


def test_phase_correlate_integer_shift(rng):
    base = (rng.random((128, 160)) * 1000).astype(np.float32)
    shifted = np.roll(np.roll(base, 5, axis=1), -3, axis=0)
    dx, dy, resp = phasecorr.phase_correlate(base, shifted)
    assert abs(dx - 5.0) < 0.05
    assert abs(dy - (-3.0)) < 0.05
    assert resp > 0.9


def test_phase_correlate_matches_oracle_f32(rng):
    a = (rng.random((96, 200)) * 500).astype(np.float32)
    b = np.roll(a, 2, axis=1) + rng.normal(0, 5, a.shape).astype(np.float32)
    dx, dy, resp = phasecorr.phase_correlate(a, b)
    odx, ody, oresp = cv_exact.phase_correlate(a, b, precision=np.float32)
    assert abs(dx - odx) < 1e-3
    assert abs(dy - ody) < 1e-3
    assert abs(resp - oresp) < 1e-3


def test_phase_correlate_matches_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    a = (rng.random((150, 201)) * 1000).astype(np.float32)
    m = np.float32([[1, 0, -2.4], [0, 1, 1.3]])
    b = cv2.warpAffine(a, m, (201, 150), flags=cv2.INTER_LINEAR)
    (cdx, cdy), cresp = cv2.phaseCorrelate(a, b)
    dx, dy, resp = phasecorr.phase_correlate(a, b)
    assert abs(dx - cdx) < 2e-3
    assert abs(dy - cdy) < 2e-3
    assert abs(resp - cresp) < 1e-3


def test_phase_correlate_batch_matches_single(rng):
    a = (rng.random((6, 64, 80)) * 100).astype(np.float32)
    b = np.stack([np.roll(x, i % 3, axis=1) for i, x in enumerate(a)])
    dxs, dys, rs = phasecorr.phase_correlate_batch(a, b)
    for i in range(a.shape[0]):
        dx, dy, r = phasecorr.phase_correlate(a[i], b[i])
        assert abs(float(dxs[i]) - dx) < 1e-5
        assert abs(float(dys[i]) - dy) < 1e-5
        assert abs(float(rs[i]) - r) < 1e-5


def test_polyfit_recovers_model(rng):
    from opticalimageprocessor_tpu.ops import polyfit

    cx = np.linspace(100, 12000, 40)
    dx = 0.5 + 1e-4 * cx + rng.normal(0, 1e-6, cx.size)
    dy = -1.5 + 2e-4 * cx + 3e-9 * cx * cx
    valid = np.ones(cx.size, bool)
    valid[5] = False
    cxc, cyc = polyfit.fit_shift_models(cx, dx, dy, valid)
    assert abs(cxc[0] - 0.5) < 1e-3 and abs(cxc[1] - 1e-4) < 1e-6
    assert abs(cyc[0] + 1.5) < 1e-3 and abs(cyc[2] - 3e-9) < 1e-12


def _band_case(rng, rows, cols, n_bands):
    """PAN tile = shifted x4 upsample of band 0; band b is band 0 rolled
    by (b, -b) band pixels, so every band has a clean peak."""
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.ops import resample

    base = (rng.random((rows, cols)) * 1000).astype(np.float32)
    bands = [np.roll(base, (b, -b), axis=(0, 1)) for b in range(n_bands)]
    up = np.asarray(resample.upsample4_f32(jnp.asarray(base)))
    pan = np.roll(np.roll(up, 4, axis=0), -2, axis=1)
    return jnp.asarray(pan), jnp.asarray(np.stack(bands))


# band tile shapes: odd and even keep widths, a tile height that is not a
# power of two, a window of 5 (11 columns), one to four bands
@pytest.mark.parametrize(
    "rows,cols,win,n_bands",
    [
        (248, 64, 16, 1),
        (248, 64, 16, 4),
        (250, 60, 16, 2),
        (248, 64, 5, 4),
        (96, 40, 8, 3),
    ],
)
def test_bf16_contraction_matches_float32(rng, rows, cols, win, n_bands):
    """The GPU path's bfloat16 kx contraction (float32 accumulation) stays
    within 2e-3 px / 2e-3 response of the float32 HIGHEST contraction on
    every peak the response filter keeps."""
    import jax.numpy as jnp

    pan, bands = _band_case(rng, rows, cols, n_bands)
    f32 = phasecorr.band_window_peaks(
        pan, bands, pan.shape, (win, win), jnp.float32
    )
    bf16 = phasecorr.band_window_peaks(
        pan, bands, pan.shape, (win, win), jnp.bfloat16
    )
    # compare the peaks the pipeline keeps (response >= the reference's
    # 0.4 threshold); a shift outside the window has no peak to agree on
    kept = np.asarray(f32[2]) >= 0.4
    assert kept[0]
    for k in range(3):
        np.testing.assert_allclose(
            np.asarray(bf16[k])[kept], np.asarray(f32[k])[kept], atol=2e-3
        )
    # band 0 (a pure shift of the PAN) registers the constructed shift
    # (cv::phaseCorrelate sign convention) when the 5x5 centroid fits in
    # the window
    if win >= 8:
        assert abs(float(bf16[0][0]) - 2.0) < 0.1
        assert abs(float(bf16[1][0]) + 4.0) < 0.1


def test_band_window_peaks_matches_per_band_peaks(rng):
    """The per-tile entry point shares the PAN spectrum across bands and
    equals separate per-band windowed peaks bit for bit."""
    import jax.numpy as jnp

    pan, bands = _band_case(rng, 248, 64, 4)
    got = phasecorr.band_window_peaks(
        pan, bands, pan.shape, (16, 16), jnp.float32
    )
    far, fai = phasecorr.rfft2_padded(pan, pan.shape)
    for b in range(4):
        want = phasecorr.peak_from_spectra_windowed(
            far, fai, *phasecorr.upsampled_band_spectrum(bands[b]),
            pan.shape, 16, 16,
        )
        for k in range(3):
            assert float(got[k][b]) == float(want[k]), (b, k)


@pytest.mark.parametrize(
    "shape,pad",
    [
        ((64, 50), (64, 50)),
        ((128, 128), (128, 128)),
        ((250, 96), (256, 100)),
        ((500, 250), (500, 250)),
        ((1600, 128), (1600, 135)),
    ],
)
def test_rfft2_padded_matches_numpy(shape, pad, rng):
    """Zero-padded half spectrum against numpy's float64 FFT."""
    import jax.numpy as jnp

    x = (rng.random(shape) * 100).astype(np.float32)
    re, im = phasecorr.rfft2_padded(jnp.asarray(x), pad)
    padded = np.zeros(pad)
    padded[: shape[0], : shape[1]] = x
    want = np.fft.rfft2(padded)
    assert re.shape == want.shape and re.dtype == jnp.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(re), want.real, atol=2e-6 * scale)
    np.testing.assert_allclose(np.asarray(im), want.imag, atol=2e-6 * scale)


@pytest.mark.parametrize(
    "shape,shift",
    [
        ((64, 50), (3, -2)),
        ((250, 96), (-5, 7)),
        ((320, 250), (0, 11)),
        ((64, 51), (2, 2)),       # odd width: no Nyquist column
        ((50, 2500), (-1, 40)),   # wide strip (> 2048 columns)
    ],
)
def test_peak_from_spectra_matches_numpy_oracle(shape, shift, rng):
    """Full-surface peak from shared spectra against the float64 numpy
    cv::phaseCorrelate oracle at the same padded size."""
    import jax.numpy as jnp

    a = (rng.random(shape) * 1000).astype(np.float32)
    b = np.roll(a, shift, axis=(0, 1)) + rng.normal(0, 3, shape).astype(
        np.float32
    )
    pad = (
        cv_exact.get_optimal_dft_size(shape[0]),
        cv_exact.get_optimal_dft_size(shape[1]),
    )
    far, fai = phasecorr.rfft2_padded(jnp.asarray(a), pad)
    fbr, fbi = phasecorr.rfft2_padded(jnp.asarray(b), pad)
    dx, dy, resp = phasecorr.peak_from_spectra(far, fai, fbr, fbi, pad)
    odx, ody, oresp = cv_exact.phase_correlate(a, b)
    assert abs(float(dx) - odx) < 1e-3, (float(dx), odx)
    assert abs(float(dy) - ody) < 1e-3, (float(dy), ody)
    assert abs(float(resp) - oresp) < 1e-3
    assert abs(odx - shift[1]) < 0.5 and abs(ody - shift[0]) < 0.5
