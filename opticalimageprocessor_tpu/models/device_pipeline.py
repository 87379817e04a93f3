"""The fused single-chip device pipeline (the framework's flagship model).

One jitted program covering the whole per-scene compute chain of the
reference's default + prestitch + stitch commands, device-resident end to
end:

  RRC(4 x MSS)                                 # elementwise XLA; the PAN
                                               # RRC is fused into its
                                               # consumers below
  -> registration: sections x slices sampling grid with tile-inline PAN
     RRC, PAN tile spectrum (jnp.fft) shared across bands, spectral band
     upsample, windowed correlation peak (kx contraction in the backend
     policy's dtype, ops/backend), response filter at the reference's 0.4
     threshold
  -> weighted dd-float32 polynomial shift fit (on device, ops/ddf32)
  -> stt-parameter estimation: PAN1 right-edge vs PAN2 left-edge overlap
     correlation over sampled sections (CalcSttParameters analogue)
  -> 4-band alignment resample (blocked-matmul remap, lax.map row-chunk
     streaming) + ONE fused chunk pass for the dual-CMOS tail:
     RRC(PAN1) left half ++ prestitch-remap(RRC(PAN2)) right half
     (resample.remap_const_stitch_chunked)

This is the throughput path measured by bench.py (see PERF.md).  The
host-orchestrated models (PreProcessor/Stitcher) remain the parity-exact
route with file IO and the reference's sectioning semantics; this pipeline
trades those for the documented fast-mode envelope (see
ops/resample.remap_band_fast, ops/phasecorr.peak_from_spectra_windowed).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import (
    CORRELATION_LINES,
    IBCV_DEF_THRESHOLD,
    IBCV_MIN_COUNT,
    MSS_BANDS,
)
from ..ops import backend, phasecorr, resample, rrc
from ..ops.cv_exact import get_optimal_dft_size
from ..ops.rrc import _rrc_math


def _fit_poly(cx, y, deg: int, w=None):
    """Small weighted least-squares on device, in double-word float32.

    Matches the host float64 Vandermonde fit (ops/polyfit, the NumCpp
    Poly1d::fit analogue) to ~2^-48 relative — the normal equations are
    accumulated and solved in dd arithmetic (ops/ddf32) on x normalised by
    an exact power of two, so flagship-path coefficients agree with the
    parity fit to <=1e-6 px over the strip (was ~1e-2 px with the old
    plain-f32 lstsq)."""
    from ..ops import ddf32

    scale = jnp.float32(1.0 / 4096.0)     # exact pow2: xn = cx*scale exact
    xn = cx * scale
    if w is None:
        w = jnp.ones_like(xn)
    coeffs = ddf32.fit_poly_weighted_dd(xn, y, deg, w)
    # de-normalise: coeff for x^k is c_k * scale^k (exact pow2 scaling)
    return jnp.stack(
        [
            ddf32.dd_to_f32((c[0] * scale**k, c[1] * scale**k))
            for k, c in enumerate(coeffs)
        ]
    )


def register_fast(
    pan_c: jax.Array,
    mss_c: jax.Array,
    slices: int = 10,
    n_sections: int | None = None,
    win: tuple[int, int] = (64, 64),
    exact_sizes: bool = False,
    threshold: float = IBCV_DEF_THRESHOLD,
    dot_dtype=None,
    pan_params: jax.Array | None = None,
    unroll: int = 1,
    mss_params: jax.Array | None = None,
):
    """Fast registration: per-(section, slice) windowed phase correlation.

    ``pan_c``: (L_pan, W) uint16 (RRC'd) — or the RAW strip when
    ``pan_params`` is given, in which case each sampled tile is RRC'd
    inline (identical per-pixel math; the corrected full strip is never
    materialised in HBM).  ``mss_c``: (4, L_mss, W/4) uint16 — or the RAW
    band strips when ``mss_params`` (4, 6, W/4) is given, in which case
    each sampled band tile is RRC'd inline the same way (the staged
    estimate uses this: its transform re-corrects the full bands anyway,
    so correcting them here would be pure wasted HBM traffic).
    Returns (coeffs, n_valid): per-band (coeff_x[2], coeff_y[3]) fitted on
    the device over samples with response >= ``threshold`` (the reference's
    0.4 filter, oipshared.h:35 + preproc.h:492-503), and the per-band valid
    sample count (4,) int32 — check it against IBCV_MIN_COUNT with
    :func:`check_registration_valid` outside the jitted program (the
    reference errors below 5 valid, preproc.h:505-510).

    Fast-mode choices (vs models.preprocessor's parity registration): the
    correlation length equals the tile (no optimal-DFT padding) so the band
    side uses the spectral-upsample identity, and the peak search is
    restricted to ``win`` — deviations measured ~0.015 px.
    ``exact_sizes=True`` restores the OpenCV padding and explicit upsample.

    ``dot_dtype`` is the operand dtype of the fast path's kx contraction
    (default: the backend policy, ops/backend.band_dot_dtype — float32 on
    the CPU, bfloat16 with float32 accumulation on the GPU).  ``unroll``
    unrolls the tile loop (a ``lax.scan`` in place of ``lax.map``).
    """
    lines_pan, width = pan_c.shape
    corr_rows = min(lines_pan, CORRELATION_LINES)
    if not exact_sizes:
        # fast mode skips optimal-DFT padding; the tile height is rounded
        # to a multiple of 64 (a no-op at the reference's 16000-line
        # window), kept so that outputs stay comparable across versions
        corr_rows = max(64, corr_rows - corr_rows % 64)
    if n_sections is None:
        n_sections = max(1, min(5, lines_pan // CORRELATION_LINES))
    cols = width // slices
    bcols = cols // MSS_BANDS
    brows = corr_rows // MSS_BANDS
    if exact_sizes:
        pad = (get_optimal_dft_size(corr_rows), get_optimal_dft_size(cols))
    else:
        pad = (corr_rows, cols)
    win = phasecorr.clamp_win(win, pad)
    if dot_dtype is None:
        dot_dtype = backend.band_dot_dtype()
    sec_stride = (
        (lines_pan - corr_rows) // max(1, n_sections - 1)
        if n_sections > 1
        else 0
    )

    def one_slice(idx):
        sec = idx // slices
        i = idx % slices
        row0 = sec * sec_stride
        pt = jax.lax.dynamic_slice(
            pan_c, (row0, i * cols), (corr_rows, cols)
        )
        if pan_params is not None:
            pp = jax.lax.dynamic_slice(pan_params, (0, i * cols), (6, cols))
            pt = _rrc_math(
                pt.astype(jnp.int32), *[pp[k][None, :] for k in range(6)]
            ).astype(jnp.uint16)
        bt4 = jax.lax.dynamic_slice(
            mss_c,
            (0, row0 // MSS_BANDS, i * bcols),
            (MSS_BANDS, brows, bcols),
        )
        if mss_params is not None:
            mp = jax.lax.dynamic_slice(
                mss_params, (0, 0, i * bcols), (MSS_BANDS, 6, bcols)
            )
            bt4 = _rrc_math(
                bt4.astype(jnp.int32),
                *[mp[:, k][:, None, :] for k in range(6)],
            ).astype(jnp.uint16)
        if not exact_sizes:
            return phasecorr.band_window_peaks(pt, bt4, pad, win, dot_dtype)
        far, fai = phasecorr.rfft2_padded(pt.astype(jnp.float32), pad)
        outs = []
        for band in range(MSS_BANDS):
            up = resample.upsample4_f32(bt4[band].astype(jnp.float32))
            fbr, fbi = phasecorr.rfft2_padded(up, pad)
            outs.append(
                phasecorr.peak_from_spectra_windowed(
                    far, fai, fbr, fbi, pad, win[0], win[1]
                )
            )
        return tuple(jnp.stack([o[k] for o in outs]) for k in range(3))

    if unroll > 1:
        # lax.map is scan-of-batch-1; unrolling the scan body lets XLA
        # schedule ``unroll`` tiles' chains together (the working set
        # grows by the unroll factor, so keep it small)
        _, (dx, dy, rs) = jax.lax.scan(
            lambda _, idx: (None, one_slice(idx)),
            None,
            jnp.arange(n_sections * slices),
            unroll=unroll,
        )
    else:
        dx, dy, rs = jax.lax.map(one_slice, jnp.arange(n_sections * slices))
    dx = dx.reshape(n_sections * slices, MSS_BANDS).T
    dy = dy.reshape(n_sections * slices, MSS_BANDS).T
    rs = rs.reshape(n_sections * slices, MSS_BANDS).T
    cx = jnp.tile(
        (jnp.arange(slices) * cols + cols // 2).astype(jnp.float32),
        n_sections,
    )
    coeffs = []
    n_valid = []
    for band in range(MSS_BANDS):
        w = (rs[band] >= threshold).astype(jnp.float32)
        n_valid.append(w.sum().astype(jnp.int32))
        coeffs.append(
            (_fit_poly(cx, dx[band], 1, w), _fit_poly(cx, dy[band], 2, w))
        )
    return coeffs, jnp.stack(n_valid)


def check_registration_valid(n_valid) -> None:
    """Host-side min-count check on :func:`register_fast`'s per-band valid
    sample counts (the reference's FilterInterBandShiftValues failure,
    preproc.h:505-510)."""
    counts = [int(v) for v in n_valid]
    for b, n in enumerate(counts):
        if n < IBCV_MIN_COUNT:
            raise RuntimeError(
                f"Not enough valid correlation values for band#{b + 1}: "
                f"{n} valid values found, {IBCV_MIN_COUNT} expected at least"
            )


def stt_estimate_fast(
    pan1_c: jax.Array,
    pan2_c: jax.Array,
    sections: int = 10,
    line_per_section: int | None = None,
    overlap_cols: int = 200,
    edge_cols: int = 0,
    threshold: float = IBCV_DEF_THRESHOLD,
    max_delta_y: float = 0.0,
    win: tuple[int, int] = (64, 64),
):
    """On-device stitching-parameter estimation (CalcSttParameters,
    stitcher.h:148-201): phase-correlate ``sections`` sampled windows of
    PAN1's right overlap strip against PAN2's left overlap strip, then
    average the deltas over valid samples (response >= ``threshold``;
    |dy| <= ``max_delta_y`` when positive).

    Returns (delta_x, delta_y, response, n_valid) as traced scalars;
    ``n_valid == 0`` is the reference's "No valid delta value found" error
    — check on the host via :func:`check_stt_valid`.
    """
    lines, width = pan1_c.shape
    lps = line_per_section or max(64, min(16000, lines // sections))
    # window height rounded to a multiple of 64, kept so that outputs
    # stay comparable across versions
    lps = max(64, lps - lps % 64)
    if sections * lps > lines:
        # the host Stitcher ctor's error (stitcher.h:66-78) — without this
        # the gap goes negative and dynamic_slice clamping silently samples
        # duplicate windows
        raise ValueError(
            "PAN line count less than sections times line-per-section, "
            "use smaller -s and/or -l value(s)"
        )
    gap = (lines - sections * lps) // (sections + 1)
    step = gap + lps
    ow = overlap_cols - edge_cols
    win = phasecorr.clamp_win(win, (lps, ow))

    def one(i):
        off = gap + i * step
        t1 = jax.lax.dynamic_slice(
            pan1_c, (off, width - overlap_cols), (lps, ow)
        ).astype(jnp.float32)
        t2 = jax.lax.dynamic_slice(
            pan2_c, (off, edge_cols), (lps, ow)
        ).astype(jnp.float32)
        f1r, f1i = phasecorr.rfft2_padded(t1, (lps, ow))
        f2r, f2i = phasecorr.rfft2_padded(t2, (lps, ow))
        return phasecorr.peak_from_spectra_windowed(
            f1r, f1i, f2r, f2i, (lps, ow), win[0], win[1]
        )

    dx, dy, rs = jax.lax.map(one, jnp.arange(sections))
    ok = rs >= threshold
    if max_delta_y > 0.0:
        ok = ok & (jnp.abs(dy) <= max_delta_y)
    w = ok.astype(jnp.float32)
    n = w.sum()
    denom = jnp.maximum(n, 1.0)
    return (
        (dx * w).sum() / denom,
        (dy * w).sum() / denom,
        (rs * w).sum() / denom,
        n.astype(jnp.int32),
    )


def check_stt_valid(n_valid) -> None:
    """Host-side check of :func:`stt_estimate_fast`'s valid count
    (stitcher.h:187-190)."""
    if int(n_valid) == 0:
        raise RuntimeError(
            "No valid delta value found for stitching parameter calculating"
        )


def make_device_pipeline(
    slices: int = 10,
    n_sections: int | None = None,
    fold: int = 200,
    chunk_rows: int = 512,
    row_bound: int = 3,
    stt_sections: int = 10,
    stt_lines: int | None = None,
    overlap_cols: int = 200,
    col_block: int = 128,
    col_halo: int = 16,
    stt_threshold: float = IBCV_DEF_THRESHOLD,
    stt_max_delta_y: float = 0.0,
    threshold: float = IBCV_DEF_THRESHOLD,
    prestt_row_bound: int = 8,
    return_prestt: bool = False,
):
    """Build the jitted full device pipeline.

    signature: (pan1 u16 (L, 12288), pan2 u16 (L, 12288),
                mss u16 (4, L/4, 3072), pan1_params (6, 12288) f32,
                pan2_params (6, 12288) f32, mss_params (4, 6, 3072) f32)
             -> (aligned u16 (L/4, 3072, 4),
                 stitched u16 (L, 2*(12288-fold)),
                 n_valid_register (4,) i32, n_valid_stt () i32,
                 params = (cx (4, 2), cy (4, 3), stt_dx (), stt_dy (),
                           raw_stt_dx (), raw_stt_dy ()) — stt_dx/dy are
                 the clamped values the prestitch resample consumed,
                 raw_* the unclamped averages for the reference log)

    Every input pixel is processed exactly once: PAN1 takes RRC +
    registration + the stitch left half; PAN2 takes its own RRC, the
    on-device stt-parameter estimation against PAN1's overlap strip, the
    constant-shift prestitch resample, and the stitch right half; MSS takes
    RRC + registration + the 4-band alignment resample.  Check the two
    valid counts with :func:`check_registration_valid` /
    :func:`check_stt_valid` after the step.

    ``col_block``/``col_halo`` shape the remap's banded column matmul
    (128/16 by default); ``col_halo`` statically bounds the
    supported horizontal shift — |dx| <= col_halo - 2 — and
    ``prestt_row_bound`` the prestitch |dy| (the measured mounting offsets
    enter the resample as traced values, so the static bands must cover
    them; physical offsets are a few pixels — raise both for exotic
    geometry).  The stt estimate clamps to those supported ranges so an
    out-of-band estimate degrades loudly (validity counts) rather than
    silently zeroing taps.
    """

    @jax.jit
    def pipeline(pan1, pan2, mss, pan1_params, pan2_params, mss_params):
        # the corrected PAN strips are never materialised: registration
        # RRCs its sampled tiles inline, and the stitch tail fuses RRC +
        # prestitch remap + seam concat into one chunk-streamed pass
        # (resample.remap_const_stitch_chunked) — ~3 strip-sized HBM
        # round trips less than the separate-stage structure
        aligned, n_valid, coeffs = _rrc_register_align(
            pan1, mss, mss_params, slices, n_sections, threshold,
            chunk_rows, row_bound, col_block, col_halo,
            pan_params=pan1_params,
        )
        # reference order: CalcSttParameters correlates the *uncorrected*
        # strips (main.cpp:280-284 runs it before DoRRC)
        raw_dx, raw_dy, _resp, n_stt = stt_estimate_fast(
            pan1, pan2, stt_sections, stt_lines, overlap_cols,
            threshold=stt_threshold, max_delta_y=stt_max_delta_y,
        )
        dxs = jnp.clip(raw_dx, -(col_halo - 2.0), col_halo - 2.0)
        dys = jnp.clip(
            raw_dy, -(prestt_row_bound - 2.0), prestt_row_bound - 2.0
        )
        out = resample.remap_const_stitch_chunked(
            pan1, pan2, pan1_params, pan2_params, dxs, dys, fold,
            chunk_rows=chunk_rows,
            row_bound=prestt_row_bound,
            col_block=col_block,
            col_halo=col_halo,
            want_prestt=return_prestt,
        )
        params = (coeffs[0], coeffs[1], dxs, dys, raw_dx, raw_dy)
        if return_prestt:
            stitched, prestt = out
            return aligned, stitched, prestt, n_valid, n_stt, params
        return aligned, out, n_valid, n_stt, params

    return pipeline


def make_scene_estimate(
    slices: int = 10,
    n_sections: int | None = None,
    stt_sections: int = 10,
    stt_lines: int | None = None,
    overlap_cols: int = 200,
    stt_threshold: float = IBCV_DEF_THRESHOLD,
    stt_max_delta_y: float = 0.0,
    threshold: float = IBCV_DEF_THRESHOLD,
):
    """The scene's parameter-estimation program over its MINIMAL inputs:
    ``estimate(pan1, pan2_left, mss, pan1_params, mss_params)`` where
    ``pan2_left`` is PAN2's left ``overlap_cols`` columns — the only part
    of PAN2 the stt sampling reads (stitcher.h:148-201 correlates the
    CMOS overlap strips only).  Both strips stay RAW: register_fast RRCs
    only the sampled tiles inline (bit-identical per-pixel math) — the
    transform re-corrects the full bands anyway, so a full-strip RRC here
    is wasted HBM traffic.

    :func:`make_device_pipeline_staged`'s estimate delegates here; section
    drivers that keep PAN2 only in halo-padded form (bench.py's sectioned
    schedule) call this directly with a persistent narrow PAN2 copy.
    """

    @jax.jit
    def estimate(pan1, pan2_left, mss, pan1_params, mss_params):
        coeffs, n_valid = register_fast(
            pan1, mss, slices, n_sections, threshold=threshold,
            pan_params=pan1_params, mss_params=mss_params,
        )
        raw_dx, raw_dy, _resp, n_stt = stt_estimate_fast(
            pan1, pan2_left, stt_sections, stt_lines, overlap_cols,
            threshold=stt_threshold, max_delta_y=stt_max_delta_y,
        )
        cx = jnp.stack([coeffs[i][0] for i in range(MSS_BANDS)])
        cy = jnp.stack([coeffs[i][1] for i in range(MSS_BANDS)])
        return cx, cy, n_valid, raw_dx, raw_dy, n_stt

    return estimate


def make_device_pipeline_staged(
    slices: int = 10,
    n_sections: int | None = None,
    fold: int = 200,
    chunk_rows: int = 512,
    row_bound: int = 3,
    stt_sections: int = 10,
    stt_lines: int | None = None,
    overlap_cols: int = 200,
    col_block: int = 128,
    col_halo: int = 16,
    stt_threshold: float = IBCV_DEF_THRESHOLD,
    stt_max_delta_y: float = 0.0,
    threshold: float = IBCV_DEF_THRESHOLD,
    prestt_row_bound: int = 8,
    return_prestt: bool = False,
    donate_inputs: bool = False,
):
    """:func:`make_device_pipeline` split at the parameter boundary.

    Returns ``(estimate, transform)``, two jitted executions computing the
    same scene as the fused pipeline:

      estimate(pan1, pan2, mss, pan1_params, mss_params)
        -> (cx (4, 2), cy (4, 3), n_valid_register (4,),
            raw_stt_dx (), raw_stt_dy (), n_valid_stt ())
      transform(pan1, pan2, mss, pan1_params, pan2_params, mss_params,
                cx, cy, raw_stt_dx, raw_stt_dy)
        -> (aligned, stitched[, prestt])   # fused-pipeline layouts

    Why split: one fused 65536-line execution reserves ~8 GB of device
    memory (outputs + temps) at enqueue, so two iterations in flight need
    twice that — but a transform and the NEXT scene's estimate together
    need less, so back-to-back scenes can software-pipeline at stage
    granularity and still hide the host round trip.  This mirrors the reference's own
    materialisation boundary: parameter estimation and the remap transform
    are separate passes there too (preproc.h:212-221 vs :428-468,
    stitcher.h:148-201 vs :83-139).

    ``donate_inputs`` donates ``pan1``/``pan2``/``mss`` to ``transform``
    (callers that hand per-scene strips across stages let XLA reuse those
    buffers for intermediates, lowering the in-flight peak; the arrays are
    invalidated by the call).
    """

    estimate_narrow = make_scene_estimate(
        slices=slices, n_sections=n_sections, stt_sections=stt_sections,
        stt_lines=stt_lines, overlap_cols=overlap_cols,
        stt_threshold=stt_threshold, stt_max_delta_y=stt_max_delta_y,
        threshold=threshold,
    )

    @jax.jit
    def estimate(pan1, pan2, mss, pan1_params, mss_params):
        # only PAN2's left overlap columns feed the stt sampling, so the
        # shared narrow-input estimate body sees a small in-jit slice
        # (identical sampled windows -> bit-identical result)
        return estimate_narrow(
            pan1, pan2[:, :overlap_cols], mss, pan1_params, mss_params
        )

    def _transform(
        pan1, pan2, mss, pan1_params, pan2_params, mss_params,
        cx, cy, raw_dx, raw_dy,
    ):
        mss_c = jnp.stack(
            [rrc.rrc_apply(mss[i], mss_params[i]) for i in range(MSS_BANDS)]
        )
        aligned = jnp.stack(
            [
                resample.remap_band_fast_chunked(
                    mss_c[i], cx[i], cy[i],
                    chunk_rows=chunk_rows, row_bound=row_bound,
                    col_block=col_block, col_halo=col_halo,
                )
                for i in range(MSS_BANDS)
            ],
            axis=-1,
        )
        dxs = jnp.clip(raw_dx, -(col_halo - 2.0), col_halo - 2.0)
        dys = jnp.clip(
            raw_dy, -(prestt_row_bound - 2.0), prestt_row_bound - 2.0
        )
        out = resample.remap_const_stitch_chunked(
            pan1, pan2, pan1_params, pan2_params, dxs, dys, fold,
            chunk_rows=chunk_rows,
            row_bound=prestt_row_bound,
            col_block=col_block,
            col_halo=col_halo,
            want_prestt=return_prestt,
        )
        if return_prestt:
            return aligned, out[0], out[1]
        return aligned, out

    transform = jax.jit(
        _transform, donate_argnums=(0, 1, 2) if donate_inputs else ()
    )
    return estimate, transform


def _rrc_register_align(
    pan_c, mss, mss_params, slices, n_sections, threshold,
    chunk_rows, row_bound, col_block, col_halo, pan_params=None,
):
    """Shared core of the CMOS1 pipeline and the CMOS2 (mss2) align:
    RRC the bands, register against ``pan_c`` (raw + inline tile RRC when
    ``pan_params`` is given), resample each band.  Also returns the fitted
    per-band coefficients ``(cx (4, 2), cy (4, 3))`` so the scene driver
    can log them (the reference OLOGs every fit, preproc.h:552-560)."""
    mss_c = jnp.stack(
        [rrc.rrc_apply(mss[i], mss_params[i]) for i in range(MSS_BANDS)]
    )
    coeffs, n_valid = register_fast(
        pan_c, mss_c, slices, n_sections, threshold=threshold,
        pan_params=pan_params,
    )
    aligned = jnp.stack(
        [
            resample.remap_band_fast_chunked(
                mss_c[i], coeffs[i][0], coeffs[i][1],
                chunk_rows=chunk_rows, row_bound=row_bound,
                col_block=col_block, col_halo=col_halo,
            )
            for i in range(MSS_BANDS)
        ],
        axis=-1,
    )
    cx = jnp.stack([coeffs[i][0] for i in range(MSS_BANDS)])
    cy = jnp.stack([coeffs[i][1] for i in range(MSS_BANDS)])
    return aligned, n_valid, (cx, cy)


def make_mss_align(
    slices: int = 10,
    n_sections: int | None = None,
    threshold: float = IBCV_DEF_THRESHOLD,
    chunk_rows: int = 512,
    row_bound: int = 6,
    col_block: int = 128,
    col_halo: int = 16,
):
    """Build a jitted MSS-against-PAN align step (RRC + registration +
    resample) for an already-corrected PAN raster — the second half of the
    full scene workflow, where CMOS2's MSS aligns against the *prestitched*
    PAN2 (sample-task.sh step 3.2 registers against S1_PAN2 =
    ``*.RRC.PRESTT.RAW``).

    ``row_bound`` defaults wider (6) than the CMOS1 pipeline's: MSS2's
    fitted vertical offset combines the band misregistration with the
    band-scale residue of the prestitch translation.

    signature: (pan_c u16 (L, W), mss u16 (4, L/4, W/4),
                mss_params (4, 6, W/4) f32)
             -> (aligned u16 (L/4, W/4, 4), n_valid (4,) i32,
                 (cx (4, 2), cy (4, 3)))
    """

    @jax.jit
    def align(pan_c, mss, mss_params):
        return _rrc_register_align(
            pan_c, mss, mss_params, slices, n_sections, threshold,
            chunk_rows, row_bound, col_block, col_halo,
        )

    return align
