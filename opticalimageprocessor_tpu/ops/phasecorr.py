"""Phase-correlation shift estimation (jnp.fft).

Implements ``cv::phaseCorrelate`` semantics (OpenCV phasecorr.cpp), used by
the reference at two call sites:

* PAN slice vs 4x-upsampled MSS band slice (preproc.h:316)
* PAN1 right-edge strip vs PAN2 left-edge strip (stitcher.h:180)

Semantics reproduced exactly (float32):
  1. zero-pad each tile to the optimal DFT size (2^a 3^b 5^c),
  2. cross-power spectrum C = F1 * conj(F2) / |F1 * conj(F2)| (no window —
     the reference passes cv::noArray()),
  3. inverse FFT, fftshift,
  4. arg-max peak (row-major first-match, like cv::minMaxLoc),
  5. 5x5 weighted centroid around the peak (edge-clipped), response = window
     sum (OpenCV's unnormalised idft sum divided by M*N equals the normalised
     ifft sum directly),
  6. shift = (pad_center - centroid).

The whole routine is jit-compatible with static tile shapes, and
`phase_correlate_batch` maps it over a leading tile axis so the 200
tile-correlations of a default registration run execute as one device
program (the reference loops them serially through OpenCV,
preproc.h:251-327).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .cv_exact import get_optimal_dft_size

_HI = jax.lax.Precision.HIGHEST


def rfft2_padded(x: jax.Array, pad_to: tuple[int, int]):
    """Zero-pad to ``pad_to`` and rfft2; returns (re, im) float32 pair."""
    h, w = x.shape[-2], x.shape[-1]
    M, N = pad_to
    pad_width = [(0, 0)] * (x.ndim - 2) + [(0, M - h), (0, N - w)]
    f = jnp.fft.rfft2(jnp.pad(x, pad_width))
    return jnp.real(f), jnp.imag(f)


def peak_from_spectra(far, fai, fbr, fbi, pad_to: tuple[int, int]):
    """Cross-power spectrum -> correlation peak (dx, dy, response), given
    precomputed half spectra of the two tiles (lets callers share the
    reference-tile FFT across many candidates)."""
    M, N = pad_to
    pr = far * fbr + fai * fbi            # fa * conj(fb)
    pi = fai * fbr - far * fbi
    mag = jnp.sqrt(pr * pr + pi * pi)
    den = jnp.where(mag == 0, 1.0, mag)
    c = jax.lax.complex(pr / den, pi / den)
    corr = jnp.fft.fftshift(jnp.fft.irfft2(c, s=(M, N)))
    return _peak_and_centroid(corr, M, N)


@functools.partial(jax.jit, static_argnames=("pad_to",))
def _phase_correlate_padded(a: jax.Array, b: jax.Array, pad_to):
    """Core routine on already-shaped f32 tiles; returns (dx, dy, response)."""
    far, fai = rfft2_padded(a, pad_to)
    fbr, fbi = rfft2_padded(b, pad_to)
    return peak_from_spectra(far, fai, fbr, fbi, pad_to)


def _peak_and_centroid(corr: jax.Array, M: int, N: int):
    """Arg-max peak + 5x5 weighted centroid (cv::phaseCorrelate semantics)."""
    peak = jnp.argmax(corr)          # row-major first max, like minMaxLoc
    py = peak // N
    px = peak % N

    # 5x5 centroid window, clipped at the edges exactly like weightedCentroid
    minr = jnp.maximum(py - 2, 0)
    maxr = jnp.minimum(py + 2, M - 1)
    minc = jnp.maximum(px - 2, 0)
    maxc = jnp.minimum(px + 2, N - 1)
    # gather a static 5x5 window anchored at minr/minc then mask rows/cols
    # beyond maxr/maxc (anchor is already clipped >= 0; when the peak sits at
    # the far edge the window start also needs clipping so the slice stays
    # in-bounds)
    start_r = jnp.minimum(minr, M - 5)
    start_c = jnp.minimum(minc, N - 5)
    win = jax.lax.dynamic_slice(corr, (start_r, start_c), (5, 5))
    rr = start_r + jnp.arange(5)[:, None]
    cc = start_c + jnp.arange(5)[None, :]
    valid = (rr >= minr) & (rr <= maxr) & (cc >= minc) & (cc <= maxc)
    winm = jnp.where(valid, win, 0.0)

    s = jnp.sum(winm)
    response = s
    s_eps = s + jnp.asarray(np.float32(np.finfo(np.float64).eps), winm.dtype)
    cx = jnp.sum(winm * cc.astype(winm.dtype)) / s_eps
    cy = jnp.sum(winm * rr.astype(winm.dtype)) / s_eps
    dx = N / 2.0 - cx
    dy = M / 2.0 - cy
    return dx, dy, response


@functools.lru_cache(maxsize=16)
def _upsample_filter_response(m: int, factor: int = 4):
    """DFT of the x4 cubic upsample kernel on the length ``factor*m`` grid.

    For a *circular* 4-phase cubic upsample U (the fast-mode approximation
    of cv::resize's edge-replicated one — they differ only in the 2-3
    border samples), F(U b)[K] = U_hat(K) * F(b)[K mod m], so the upsampled
    tile's spectrum costs a small-tile FFT plus an elementwise multiply
    instead of a full-size transform.  Returns (re, im) float32 of length
    factor*m.
    """
    from .resample import _X4_BASE, _X4_W

    big_n = factor * m
    # up[factor*q + r] = sum_c w[r,c] * b[q + base_r + c]  (base = first-tap
    # offset) => kernel support s = r - factor*(base_r + c)
    taps = {}
    for r in range(factor):
        for c in range(4):
            taps[r - factor * (_X4_BASE[r] + c)] = float(_X4_W[r, c])
    k = np.arange(big_n, dtype=np.float64)
    re = np.zeros(big_n)
    im = np.zeros(big_n)
    for s, w in taps.items():
        ang = -2.0 * np.pi * k * s / big_n
        re += w * np.cos(ang)
        im += w * np.sin(ang)
    return re.astype(np.float32), im.astype(np.float32)


def upsampled_band_spectrum(band: jax.Array, factor: int = 4):
    """Half spectrum of the x``factor`` cubic-upsampled band tile, computed
    spectrally: F_up[Ky,Kx] = Hr(Ky) Hc(Kx) F_band[Ky mod m, Kx mod n].

    16x cheaper than upsample + full-size transform; exact for circular
    upsampling (fast-mode: differs from the replicate-edge cv::resize only
    in the tiles' 2-3 border samples).  Returns (re, im) with shape
    (factor*m, (factor*n)//2 + 1).
    """
    m, n = band.shape
    M, N = factor * m, factor * n
    keep = N // 2 + 1
    f = jnp.fft.fft2(band.astype(jnp.float32))  # (m, n) full small spectrum
    fr, fi = jnp.real(f), jnp.imag(f)

    # tile: rows x factor, cols to cover Kx in [0, keep)
    fr = jnp.tile(fr, (factor, 1))
    fi = jnp.tile(fi, (factor, 1))
    reps = -(-keep // n)
    fr = jnp.tile(fr, (1, reps + 1))[:, :keep]
    fi = jnp.tile(fi, (1, reps + 1))[:, :keep]

    hr_re, hr_im = (jnp.asarray(v) for v in _upsample_filter_response(m, factor))
    hc_re, hc_im = (jnp.asarray(v) for v in _upsample_filter_response(n, factor))
    hc_re = hc_re[:keep]
    hc_im = hc_im[:keep]
    # complex multiply by Hr (per row) then Hc (per column)
    r1 = fr * hr_re[:, None] - fi * hr_im[:, None]
    i1 = fr * hr_im[:, None] + fi * hr_re[:, None]
    r2 = r1 * hc_re[None, :] - i1 * hc_im[None, :]
    i2 = r1 * hc_im[None, :] + i1 * hc_re[None, :]
    return r2, i2


@functools.lru_cache(maxsize=32)
def _eval_consts(n: int, keep: int, win: int, rows_axis: bool):
    """DFT-evaluation matrices for reconstructing the correlation surface
    only at shifts s in [-win, win] (float64 trig, float32 storage)."""
    k = np.arange(keep, dtype=np.float64)
    s = np.arange(-win, win + 1, dtype=np.float64)
    # evaluate ifft(C) at index -s so the returned displacement keeps
    # cv::phaseCorrelate's sign (peak of ifft lands at minus the shift)
    ang = -2.0 * np.pi * np.outer(k, s) / n
    cos = np.cos(ang)
    sin = np.sin(ang)
    if not rows_axis:
        # half-spectrum doubling along the W axis (kx=0 once; Nyquist once)
        wgt = np.full(keep, 2.0)
        wgt[0] = 1.0
        if n % 2 == 0 and keep == n // 2 + 1:
            wgt[-1] = 1.0
        cos = cos * wgt[:, None]
        sin = sin * wgt[:, None]
    return cos.astype(np.float32), sin.astype(np.float32)


def clamp_win(win: tuple[int, int], pad_to: tuple[int, int]):
    """Clamp a (win_y, win_x) peak window to at most half the tile: the
    windowed evaluation is circular, so shifts s and s +- dim coincide —
    a window reaching dim/2 would contain duplicate peaks and the arg-max
    could alias a true shift s to s -+ dim.  Callers clamp BEFORE invoking
    the windowed peak (real camera geometry is unaffected: 64 << every
    default tile dimension; only tiny test/exotic tiles clamp)."""
    return (
        min(win[0], (pad_to[0] - 1) // 2),
        min(win[1], (pad_to[1] - 1) // 2),
    )


@functools.partial(
    jax.jit, static_argnames=("pad_to", "win_y", "win_x", "dot_dtype")
)
def peak_from_spectra_windowed(
    far, fai, fbr, fbi, pad_to: tuple[int, int],
    win_y: int = 64, win_x: int = 64, dot_dtype=jnp.float32,
):
    """Fast-mode peak: evaluate the (normalised) correlation surface only at
    shifts |dy| <= win_y, |dx| <= win_x, as two small matmuls against DFT
    evaluation matrices — no full-size inverse transform, no fftshift, no
    whole-surface arg-max.

    Identical values to the exact path at the evaluated shifts (the inverse
    DFT restricted to a window); the semantic difference from
    cv::phaseCorrelate is only that a global peak OUTSIDE the window cannot
    be found — such tiles surface as low-response samples, which the
    pipeline's validity threshold already discards.  Windows must satisfy
    win < dim/2 (see :func:`clamp_win`).

    ``dot_dtype`` is the operand type of the kx contraction: float32 runs
    it at ``Precision.HIGHEST``; bfloat16 accumulates in float32 (peaks
    within 2e-3 px of float32).  The ky contraction is always float32 at
    ``Precision.HIGHEST``.
    """
    M, N = pad_to
    keep = far.shape[-1]
    pr = far * fbr + fai * fbi            # fa * conj(fb)
    pi = fai * fbr - far * fbi
    mag = jnp.sqrt(pr * pr + pi * pi)
    den = jnp.where(mag == 0, 1.0, mag)
    cr = pr / den
    ci = pi / den

    def mm_x(a, b):
        if dot_dtype == jnp.float32:
            return jnp.dot(a, b, precision=_HI)
        return jnp.dot(
            a.astype(dot_dtype), b.astype(dot_dtype),
            preferred_element_type=jnp.float32,
        )

    def mm_y(a, b):
        return jnp.dot(a, b, precision=_HI)

    cx_c, cx_s = (jnp.asarray(v) for v in _eval_consts(N, keep, win_x, False))
    # contract kx -> window columns (complex x complex evaluation basis)
    dr = mm_x(cr, cx_c) - mm_x(ci, cx_s)
    di = mm_x(ci, cx_c) + mm_x(cr, cx_s)
    cy_c, cy_s = (jnp.asarray(v) for v in _eval_consts(M, M, win_y, True))
    # contract ky -> window rows, real output: Re((dr+idi)(cos+isin))
    corr = (mm_y(cy_c.T, dr) - mm_y(cy_s.T, di)) / jnp.float32(M * N)

    return _centroid_on_window(corr, win_y, win_x)


def _centroid_on_window(corr: jax.Array, win_y: int, win_x: int):
    """Arg-max + 5x5 weighted centroid on a (2*win_y+1, 2*win_x+1) windowed
    correlation surface; returns (dx, dy, response)."""
    wy = 2 * win_y + 1
    wx = 2 * win_x + 1
    peak = jnp.argmax(corr)
    py = peak // wx
    px = peak % wx
    start_r = jnp.clip(py - 2, 0, wy - 5)
    start_c = jnp.clip(px - 2, 0, wx - 5)
    win = jax.lax.dynamic_slice(corr, (start_r, start_c), (5, 5))
    rr = start_r + jnp.arange(5)[:, None]
    cc = start_c + jnp.arange(5)[None, :]
    valid = (
        (rr >= py - 2) & (rr <= py + 2) & (cc >= px - 2) & (cc <= px + 2)
    )
    winm = jnp.where(valid, win, 0.0)
    s = jnp.sum(winm)
    s_eps = s + jnp.asarray(np.float32(np.finfo(np.float64).eps), winm.dtype)
    cxc = jnp.sum(winm * cc.astype(winm.dtype)) / s_eps
    cyc = jnp.sum(winm * rr.astype(winm.dtype)) / s_eps
    # window coordinate w maps to shift s = w - win  (corr(s) = surface at
    # displacement s of b relative to a, sign-matched to cv::phaseCorrelate)
    dx = cxc - win_x
    dy = cyc - win_y
    return dx, dy, s


def band_window_peaks(pan_tile, band_tiles, pad_to, win, dot_dtype):
    """Fast windowed peaks of one PAN tile against its band tiles: the
    PAN spectrum is shared, each band's x4-upsampled spectrum is built
    spectrally (no padding: ``pad_to`` is the PAN tile shape), and the kx
    contraction runs in ``dot_dtype`` (ops/backend.band_dot_dtype).
    Returns (dx, dy, response), each (bands,)."""
    far, fai = rfft2_padded(pan_tile.astype(jnp.float32), pad_to)
    outs = [
        peak_from_spectra_windowed(
            far, fai, *upsampled_band_spectrum(band_tiles[b]), pad_to,
            win[0], win[1], dot_dtype,
        )
        for b in range(band_tiles.shape[0])
    ]
    return tuple(jnp.stack([o[k] for o in outs]) for k in range(3))


def phase_correlate(a, b):
    """Single-pair correlation; returns python floats (dx, dy, response)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    M = get_optimal_dft_size(a.shape[0])
    N = get_optimal_dft_size(a.shape[1])
    dx, dy, r = _phase_correlate_padded(a, b, (M, N))
    return float(dx), float(dy), float(r)


@functools.partial(jax.jit, static_argnames=("pad_to",))
def _phase_correlate_batch_padded(a, b, pad_to):
    return jax.lax.map(
        lambda xy: _phase_correlate_padded(xy[0], xy[1], pad_to), (a, b)
    )


def phase_correlate_batch(a, b):
    """Batched correlation over a leading axis: (T, H, W) x (T, H, W) →
    (dx[T], dy[T], response[T]) as jnp arrays.  Tiles run sequentially
    (lax.map) so device memory holds one tile's transform working set."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    M = get_optimal_dft_size(a.shape[1])
    N = get_optimal_dft_size(a.shape[2])
    return _phase_correlate_batch_padded(a, b, (M, N))
