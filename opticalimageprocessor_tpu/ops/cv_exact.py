"""Reference-exact numpy implementations of the OpenCV primitives used by the
reference pipeline.  These are the *parity oracles*: the device kernels in this
package are tested against them, and they themselves are tested bit-for-bit
against an installed ``cv2`` (when available).

Covered semantics (call sites in the reference):

* ``cv::remap`` INTER_CUBIC / BORDER_CONSTANT on CV_16U with CV_32F maps —
  band alignment (preproc.h:453-457) and pre-stitch translation
  (imageop.h:258 via stitcher.h:125-131).  OpenCV quantises map coordinates
  to 1/32 px and, for 16U, interpolates with *float* weights
  (cubic_tab in imgwarp.cpp: ``remapBicubic<Cast<float, ushort>, float, 1>``),
  rounding the result with ``cvRound`` (half-to-even) and saturating.
* ``cv::resize`` INTER_CUBIC on CV_32F — the 4x band upsample
  (preproc.h:302-307).  Float path: exact float weights, replicate-clamped
  taps, horizontal then vertical pass.
* ``cv::phaseCorrelate`` (phasecorr.cpp) — registration (preproc.h:316) and
  stitch parameter estimation (stitcher.h:180): pad to optimal DFT size,
  cross-power spectrum, unnormalised inverse DFT, fftShift, arg-max peak and
  5x5 weighted centroid, response normalised by M*N.
* The RRC cast contract ``(uint16_t)(k*src + b)`` (imageop.h:129-138):
  double math, truncation toward zero, x86-64 wrap semantics.
"""

from __future__ import annotations

import numpy as np

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS  # 32


# ---------------------------------------------------------------------------
# Cubic convolution weights (OpenCV interpolateCubic, A = -0.75), float32.
# ---------------------------------------------------------------------------
def interpolate_cubic_f32(x: np.ndarray) -> np.ndarray:
    """Exact float32 transcription of OpenCV's ``interpolateCubic``.

    ``x``: fractional offsets (float32, any shape); returns ``x.shape + (4,)``
    weights.  The expression order matches imgwarp.cpp so float rounding is
    identical.
    """
    x = np.asarray(x, dtype=np.float32)
    A = np.float32(-0.75)
    f1, f5, f8, f4 = (np.float32(v) for v in (1.0, 5.0, 8.0, 4.0))
    f2, f3 = np.float32(2.0), np.float32(3.0)
    xp1 = x + f1
    c0 = ((A * xp1 - f5 * A) * xp1 + f8 * A) * xp1 - f4 * A
    c1 = ((A + f2) * x - (A + f3)) * x * x + f1
    omx = f1 - x
    c2 = ((A + f2) * omx - (A + f3)) * omx * omx + f1
    c3 = f1 - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


def cubic_tab_f32() -> np.ndarray:
    """The 32-entry 1-D float cubic table (initInterTab1D at i/32)."""
    t = (np.arange(INTER_TAB_SIZE, dtype=np.float32)) * np.float32(
        1.0 / INTER_TAB_SIZE
    )
    return interpolate_cubic_f32(t)  # (32, 4)


def cv_round_f32(v: np.ndarray) -> np.ndarray:
    """cvRound on float32: round half to even, to int32."""
    return np.rint(np.asarray(v, dtype=np.float32)).astype(np.int32)


def cv_round_f64(v: np.ndarray) -> np.ndarray:
    return np.rint(np.asarray(v, dtype=np.float64)).astype(np.int64)


def saturate_cast_u16_from_f32(v: np.ndarray) -> np.ndarray:
    """saturate_cast<ushort>(float): cvRound then clamp to [0, 65535]."""
    return np.clip(cv_round_f32(v), 0, 65535).astype(np.uint16)


def get_optimal_dft_size(n: int) -> int:
    """Smallest integer >= n whose only prime factors are 2, 3, 5."""
    if n <= 1:
        return max(n, 1)
    best = None
    p5 = 1
    while p5 < n * 2:
        p53 = p5
        while p53 < n * 2:
            # smallest power of two >= n / p53
            q = max(0, -(-n // p53))
            p2 = 1
            while p2 < q:
                p2 <<= 1
            cand = p53 * p2
            if cand >= n and (best is None or cand < best):
                best = cand
            p53 *= 3
        p5 *= 5
    return int(best)


# ---------------------------------------------------------------------------
# cv::remap INTER_CUBIC, CV_16U src, CV_32FC1 map pair, BORDER_CONSTANT(0)
# ---------------------------------------------------------------------------
def convert_maps_quantized(
    mapx: np.ndarray, mapy: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Coordinate quantisation of remap with float maps.

    Returns (ix, iy, fx, fy): integer top-left-of-kernel-center coords
    (short-saturated) and 5-bit fractional indices, exactly as remap's
    ``sx = cvRound(mapx*32); XY = saturate_cast<short>(sx >> 5);
    FXY = (sy&31)*32 + (sx&31)`` (imgwarp.cpp RemapInvoker).
    """
    sx = cv_round_f32(np.asarray(mapx, np.float32) * np.float32(INTER_TAB_SIZE))
    sy = cv_round_f32(np.asarray(mapy, np.float32) * np.float32(INTER_TAB_SIZE))
    ix = np.clip(sx >> INTER_BITS, -32768, 32767).astype(np.int32)
    iy = np.clip(sy >> INTER_BITS, -32768, 32767).astype(np.int32)
    fx = (sx & (INTER_TAB_SIZE - 1)).astype(np.int32)
    fy = (sy & (INTER_TAB_SIZE - 1)).astype(np.int32)
    return ix, iy, fx, fy


def convert_maps_continuous(
    mapx: np.ndarray, mapy: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV 5.x semantics: continuous coordinates, fraction = x - floor(x)."""
    mapx = np.asarray(mapx, np.float32)
    mapy = np.asarray(mapy, np.float32)
    ix = np.floor(mapx).astype(np.int32)
    iy = np.floor(mapy).astype(np.int32)
    fx = (mapx - ix).astype(np.float32)
    fy = (mapy - iy).astype(np.float32)
    return ix, iy, fx, fy


def remap_cubic_u16_exact(
    src: np.ndarray,
    mapx: np.ndarray,
    mapy: np.ndarray,
    quantized_coords: bool = False,
) -> np.ndarray:
    """cv::remap(src16U, mapx32F, mapy32F, INTER_CUBIC, BORDER_CONSTANT, 0).

    Two coordinate conventions exist across OpenCV versions; both use *float*
    cubic weights for 16U (fixed-point weights are the 8U path only):

    * ``quantized_coords=True`` — OpenCV <= 4.x: coordinates are rounded to a
      1/32-px grid (``sx = cvRound(map*32)``, integer part saturated to
      int16), the fraction is ``(sx & 31)/32``.  This is what the reference
      binary (built against OpenCV 4.x-era releases) executes.
    * ``quantized_coords=False`` (default) — OpenCV 5.x: continuous
      coordinates, fraction ``map - floor(map)``.

    Accumulation: per tap-row ``a``, ``t = S0*(wy_a*wx_0) + S1*(wy_a*wx_1) +
    S2*(wy_a*wx_2) + S3*(wy_a*wx_3)`` left-associated in float32, rows summed
    in order; final ``cvRound`` (half-to-even) + clamp.  Empirically this is
    within +-1 DN of cv2 5.0's SIMD kernel on ~99.5% of pixels and exactly
    equal elsewhere; the installed-cv2 test asserts that envelope.  The
    device kernels are tested against THIS oracle.

    Outside taps contribute the border value 0; a pixel whose whole 4x4
    support is outside the image is exactly 0 (remapBicubic's
    BORDER_CONSTANT shortcut).
    """
    src = np.asarray(src, dtype=np.uint16)
    h, w = src.shape
    if quantized_coords:
        ix, iy, fxi, fyi = convert_maps_quantized(mapx, mapy)
        tab = cubic_tab_f32()  # (32, 4)
        wx = tab[fxi]
        wy = tab[fyi]
    else:
        ix, iy, fx, fy = convert_maps_continuous(mapx, mapy)
        wx = interpolate_cubic_f32(fx)
        wy = interpolate_cubic_f32(fy)
    sx0 = ix - 1  # top-left tap
    sy0 = iy - 1

    srcf = src.astype(np.float32)
    padded = np.zeros((h + 8, w + 8), dtype=np.float32)
    padded[4 : 4 + h, 4 : 4 + w] = srcf
    # Clip tap origins so fancy indexing stays in bounds; clipped-away pixels
    # are exactly the all_outside ones, forced to 0 below.
    py = np.clip(sy0 + 4, 0, h + 4)
    px = np.clip(sx0 + 4, 0, w + 4)
    all_outside = (sx0 >= w) | (sx0 + 4 <= 0) | (sy0 >= h) | (sy0 + 4 <= 0)

    acc = _remap_interior_order(padded, py, px, wy, wx)
    out = saturate_cast_u16_from_f32(acc)
    out[all_outside] = 0
    return out


def _remap_interior_order(padded, py, px, wy, wx) -> np.ndarray:
    """sum over a of (((S0*W[a,0] + S1*W[a,1]) + S2*W[a,2]) + S3*W[a,3]) with
    W[a,b] = float32(wy[a] * wx[b]) — the exact 2-D table product + interior
    accumulation order of remapBicubic."""
    acc = np.zeros(px.shape, dtype=np.float32)
    for a in range(4):
        ya = py + a
        wa = wy[..., a]
        t = padded[ya, px] * (wa * wx[..., 0])
        t = t + padded[ya, px + 1] * (wa * wx[..., 1])
        t = t + padded[ya, px + 2] * (wa * wx[..., 2])
        t = t + padded[ya, px + 3] * (wa * wx[..., 3])
        acc = acc + t
    return acc


# ---------------------------------------------------------------------------
# cv::resize INTER_CUBIC on CV_32FC1 (float path)
# ---------------------------------------------------------------------------
def resize_cubic_f32_exact(src: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    """Exact cv::resize(src32F, (dst_w, dst_h), INTER_CUBIC) float path.

    Horizontal pass then vertical pass, float32 weights from
    interpolateCubic, replicate-clamped taps, boundary fx/sx overrides as in
    resize's offset setup (imgproc resize.cpp).
    """
    src = np.asarray(src, dtype=np.float32)
    sh, sw = src.shape

    def offsets(dn: int, sn: int):
        scale = sn / dn  # double
        dx = np.arange(dn, dtype=np.float64)
        fxx = (dx + 0.5) * scale - 0.5
        sx = np.floor(fxx).astype(np.int64)
        fx = (fxx - sx).astype(np.float32)
        # Border handling: replicate-clamped taps with the *real* fraction
        # (OpenCV 5.x; 4.x additionally snapped fx to 0 when sx fell outside
        # [0, sn-1], a <=2-output-px border detail the alignment pipeline
        # never observes because slice borders are interior to the strip).
        w = interpolate_cubic_f32(fx)  # (dn, 4)
        taps = np.clip(sx[:, None] + np.arange(-1, 3)[None, :], 0, sn - 1)
        return taps, w

    # horizontal
    tx, wxt = offsets(dst_w, sw)
    g = src[:, tx]  # (sh, dst_w, 4)
    hbuf = (
        (g[..., 0] * wxt[None, :, 0] + g[..., 1] * wxt[None, :, 1])
        + g[..., 2] * wxt[None, :, 2]
    ) + g[..., 3] * wxt[None, :, 3]
    # vertical
    ty, wyt = offsets(dst_h, sh)
    gv = hbuf[ty]  # (dst_h, 4, dst_w) row-tap fancy index
    out = (
        (gv[:, 0, :] * wyt[:, 0:1] + gv[:, 1, :] * wyt[:, 1:2])
        + gv[:, 2, :] * wyt[:, 2:3]
    ) + gv[:, 3, :] * wyt[:, 3:4]
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# cv::phaseCorrelate
# ---------------------------------------------------------------------------
def fft_shift(c: np.ndarray) -> np.ndarray:
    return np.fft.fftshift(c)


def phase_correlate(
    a: np.ndarray, b: np.ndarray, precision=np.float64
) -> tuple[float, float, float]:
    """cv::phaseCorrelate(a, b, noArray(), &response) → (dx, dy, response).

    ``precision`` selects the FFT dtype (OpenCV computes in the input type,
    float32 for the reference's call sites; float64 gives the idealised
    answer for tolerance tests).
    """
    a = np.asarray(a, dtype=precision)
    b = np.asarray(b, dtype=precision)
    if a.shape != b.shape:
        raise ValueError("inputs must share shape")
    h, w = a.shape
    M = get_optimal_dft_size(h)
    N = get_optimal_dft_size(w)
    pa = np.zeros((M, N), dtype=precision)
    pb = np.zeros((M, N), dtype=precision)
    pa[:h, :w] = a
    pb[:h, :w] = b

    fa = np.fft.rfft2(pa)
    fb = np.fft.rfft2(pb)
    p = fa * np.conj(fb)
    mag = np.abs(p)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(mag != 0, p / mag, 0)
    corr = np.fft.irfft2(c, s=(M, N))  # normalised by 1/(M*N) vs OpenCV idft
    corr = fft_shift(corr)

    peak = int(np.argmax(corr))
    py, px = divmod(peak, N)
    minr = max(py - 2, 0)
    maxr = min(py + 2, M - 1)
    minc = max(px - 2, 0)
    maxc = min(px + 2, N - 1)
    win = corr[minr : maxr + 1, minc : maxc + 1].astype(np.float64)
    xs = np.arange(minc, maxc + 1, dtype=np.float64)
    ys = np.arange(minr, maxr + 1, dtype=np.float64)
    s = float(win.sum())
    response = s  # OpenCV divides by M*N after; our corr already is
    s_eps = s + np.finfo(np.float64).eps
    cx = float((win * xs[None, :]).sum()) / s_eps
    cy = float((win * ys[:, None]).sum()) / s_eps
    center_x = N / 2.0
    center_y = M / 2.0
    return center_x - cx, center_y - cy, response


# ---------------------------------------------------------------------------
# RRC cast contract
# ---------------------------------------------------------------------------
def rrc_exact(src: np.ndarray, k: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Reference ``InplaceRRC`` semantics (imageop.h:129-138).

    ``dst = (uint16_t)(k[x]*src + b[x])`` with k,b double: double-precision
    multiply-add, C truncation toward zero, x86-64 wrap behaviour
    (cvttsd2si then low 16 bits; out-of-int32-range/NaN → 0x80000000 → 0).
    """
    src = np.asarray(src, dtype=np.uint16)
    v = np.asarray(k, np.float64)[None, :] * src.astype(np.float64) + np.asarray(
        b, np.float64
    )[None, :]
    t = np.trunc(v)
    out_of_range = ~(t >= -2147483648.0) | ~(t <= 2147483647.0)  # catches NaN
    i = np.where(out_of_range, -2147483648.0, t).astype(np.int64).astype(np.int32)
    return (i & 0xFFFF).astype(np.uint16)
