"""Fused device pipeline: registration accuracy, response filtering, stt
estimation, and end-to-end shapes."""

import jax.numpy as jnp
import numpy as np
import pytest

from opticalimageprocessor_tpu.models.device_pipeline import (
    check_registration_valid,
    check_stt_valid,
    make_device_pipeline,
    register_fast,
    stt_estimate_fast,
)
from opticalimageprocessor_tpu.ops import resample, rrc


def _scene_pair(rng, lines_mss, band_px):
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0,
        65535,
    ).astype(np.uint16)
    return scene, pan


def test_register_fast_recovers_shifts(rng):
    """register_fast finds the constructed per-band shifts (PAN = upsampled
    scene, bands = rolled scene -> measured shift = 4x the band roll)."""
    lines_mss, band_px = 512, 3072 // 4  # full width so slices divide evenly
    scene, pan = _scene_pair(rng, lines_mss, band_px)
    vy = [0, -1, 1, 0]
    vx = [1, 0, -1, 2]
    mss = np.stack(
        [np.roll(np.roll(scene, vy[b], 0), vx[b], 1) for b in range(4)]
    )
    coeffs, n_valid = register_fast(
        jnp.asarray(pan), jnp.asarray(mss), slices=8, n_sections=1,
        win=(16, 16),
    )
    check_registration_valid(n_valid)
    for b in range(4):
        cx, cy = np.asarray(coeffs[b][0]), np.asarray(coeffs[b][1])
        # constant shifts: c0 ~= 4*v, slope ~= 0
        assert abs(cx[0] - 4 * vx[b]) < 0.3, (b, cx)
        assert abs(cy[0] - 4 * vy[b]) < 0.3, (b, cy)


def test_register_fast_bf16_matches_f32(rng):
    """The GPU path's bfloat16 kx contraction and the CPU path's float32
    one give the same fitted coefficients to the bf16 2e-3 px bound."""
    lines_mss, band_px = 512, 3072 // 4
    scene, pan = _scene_pair(rng, lines_mss, band_px)
    vy = [0, -1, 1, 0]
    vx = [1, 0, -1, 2]
    mss = np.stack(
        [np.roll(np.roll(scene, vy[b], 0), vx[b], 1) for b in range(4)]
    )
    kw = dict(slices=8, n_sections=1, win=(16, 16))
    c_f32, nv_f32 = register_fast(
        jnp.asarray(pan), jnp.asarray(mss), dot_dtype=jnp.float32, **kw
    )
    c_bf16, nv_bf16 = register_fast(
        jnp.asarray(pan), jnp.asarray(mss), dot_dtype=jnp.bfloat16, **kw
    )
    assert np.array_equal(np.asarray(nv_bf16), np.asarray(nv_f32))
    for b in range(4):
        for k in range(2):
            d = np.max(
                np.abs(np.asarray(c_bf16[b][k]) - np.asarray(c_f32[b][k]))
            )
            assert d < 2e-3, (b, k, d)


def test_register_fast_inline_mss_rrc_matches_precorrected(rng):
    """``mss_params`` RRCs only the sampled band tiles inline (the staged
    estimate's path — the full corrected bands are never materialised);
    the coefficients must be bit-identical to registering against
    fully-RRC'd band strips, with the float32 and bfloat16 contractions
    alike."""
    from opticalimageprocessor_tpu.ops import rrc

    lines_mss, band_px = 512, 3072 // 4
    scene, pan = _scene_pair(rng, lines_mss, band_px)
    mss = np.stack([np.roll(scene, b - 2, 1) for b in range(4)])
    mp = jnp.asarray(
        np.stack(
            [
                rrc.split_rrc_params(
                    0.99 + 0.02 * rng.random(band_px),
                    rng.normal(0, 10, band_px),
                )
                for _ in range(4)
            ]
        )
    )
    mss_d = jnp.asarray(mss)
    mss_c = jnp.stack([rrc.rrc_apply(mss_d[b], mp[b]) for b in range(4)])
    kw = dict(slices=8, n_sections=1, win=(16, 16))
    for extra in (
        dict(dot_dtype=jnp.float32),
        dict(dot_dtype=jnp.bfloat16),
    ):
        c_pre, nv_pre = register_fast(jnp.asarray(pan), mss_c, **kw, **extra)
        c_inl, nv_inl = register_fast(
            jnp.asarray(pan), mss_d, mss_params=mp, **kw, **extra
        )
        assert np.array_equal(np.asarray(nv_inl), np.asarray(nv_pre)), extra
        for b in range(4):
            for k in range(2):
                assert np.array_equal(
                    np.asarray(c_inl[b][k]), np.asarray(c_pre[b][k])
                ), (extra, b, k)


def test_register_fast_scan_unroll_matches_lax_map(rng):
    """``unroll>1`` swaps lax.map for an unrolled lax.scan over the same
    tile body — identical math, different step scheduling — so the
    coefficients must match the default path bit-for-bit (incl. an unroll
    that doesn't divide the tile count)."""
    lines_mss, band_px = 512, 3072 // 4
    scene, pan = _scene_pair(rng, lines_mss, band_px)
    mss = np.stack([np.roll(scene, b - 2, 1) for b in range(4)])
    kw = dict(slices=8, n_sections=1, win=(16, 16), dot_dtype=jnp.float32)
    c_map, nv_map = register_fast(jnp.asarray(pan), jnp.asarray(mss), **kw)
    for unroll in (2, 3, 8):
        c_u, nv_u = register_fast(
            jnp.asarray(pan), jnp.asarray(mss), unroll=unroll, **kw
        )
        assert np.array_equal(np.asarray(nv_u), np.asarray(nv_map))
        for b in range(4):
            for k in range(2):
                assert np.array_equal(
                    np.asarray(c_u[b][k]), np.asarray(c_map[b][k])
                ), (unroll, b, k)


def test_register_fast_excludes_low_response(rng):
    """Flat (zero-texture) tiles fall below the 0.4 response threshold and
    are provably excluded from the fit; all-flat bands trip the reference's
    min-count error (preproc.h:505-510)."""
    lines_mss, band_px = 512, 3072 // 4
    scene, pan = _scene_pair(rng, lines_mss, band_px)
    mss = np.stack([np.roll(scene, 1, 1) for _ in range(4)])

    # flatten slices 0-2 of band 0 in BOTH sensors (cloud/water analogue):
    # their response collapses, the rest stay valid
    cols = band_px // 8
    mss_flat = mss.copy()
    mss_flat[0, :, : 3 * cols] = 9000
    pan_flat = pan.copy()
    pan_flat[:, : 3 * cols * 4] = 9000
    coeffs_all, valid_all = register_fast(
        jnp.asarray(pan), jnp.asarray(mss), slices=8, n_sections=1,
        win=(16, 16),
    )
    coeffs_fl, valid_fl = register_fast(
        jnp.asarray(pan_flat), jnp.asarray(mss_flat), slices=8, n_sections=1,
        win=(16, 16),
    )
    valid_all = np.asarray(valid_all)
    valid_fl = np.asarray(valid_fl)
    assert valid_all[0] == 8
    assert valid_fl[0] == valid_all[0] - 3   # the 3 flat slices dropped out
    check_registration_valid(valid_fl)       # 5 remain: still fittable
    # the surviving fit still recovers the constructed shift
    cx0 = np.asarray(coeffs_fl[0][0])
    assert abs(cx0[0] - 4.0) < 0.5, cx0

    # fully flat scene -> 0 valid -> reference error
    flat_pan = np.full_like(pan, 9000)
    flat_mss = np.full_like(mss, 9000)
    _, valid_none = register_fast(
        jnp.asarray(flat_pan), jnp.asarray(flat_mss), slices=8, n_sections=1,
        win=(16, 16),
    )
    with pytest.raises(RuntimeError, match="Not enough valid correlation"):
        check_registration_valid(valid_none)


def test_stt_estimate_fast_recovers_overlap_shift(rng):
    """stt_estimate_fast recovers the constructed CMOS overlap translation
    (CalcSttParameters analogue)."""
    lines, width = 1024, 1024
    ov = 200
    wide = rng.integers(2000, 42000, (lines + 8, 2 * width)).astype(np.uint16)
    pan1 = np.ascontiguousarray(wide[4 : 4 + lines, :width])
    pan2 = np.ascontiguousarray(
        wide[2 : 2 + lines, width - ov + 3 : 2 * width - ov + 3]
    )
    dx, dy, resp, n = stt_estimate_fast(
        jnp.asarray(pan1), jnp.asarray(pan2), sections=4,
        overlap_cols=ov,
    )
    check_stt_valid(n)
    assert int(n) == 4
    # pan2's left block = roll(pan1's right block, rows +2, cols -3)
    assert abs(float(dx) - (-3.0)) < 0.2, float(dx)
    assert abs(float(dy) - 2.0) < 0.2, float(dy)

    # non-overlapping noise -> no valid deltas -> reference error
    p3 = rng.integers(2000, 42000, (lines, width)).astype(np.uint16)
    _, _, _, n0 = stt_estimate_fast(
        jnp.asarray(pan1), jnp.asarray(p3), sections=4, overlap_cols=ov
    )
    with pytest.raises(RuntimeError, match="No valid delta value"):
        check_stt_valid(n0)


def test_device_pipeline_shapes(rng):
    from opticalimageprocessor_tpu.constants import PIXELS_PER_LINE

    lines_pan = 2048
    lines_mss = lines_pan // 4
    scene = rng.integers(2000, 42000, (lines_mss, 3072)).astype(np.uint16)
    pan1_h = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    # PAN2's left 200 cols = PAN1's right-edge ground, small offset
    pan2_h = np.roll(
        np.roll(pan1_h, 2, axis=0), 200 - 3 - PIXELS_PER_LINE, axis=1
    )
    mss = jnp.asarray(
        np.stack(
            [
                np.roll(np.roll(scene, b % 2, axis=0), b - 1, axis=1)
                for b in range(4)
            ]
        )
    )
    pp = jnp.asarray(
        rrc.split_rrc_params(np.ones(PIXELS_PER_LINE), np.zeros(PIXELS_PER_LINE))
    )
    mp = jnp.asarray(
        np.stack([rrc.split_rrc_params(np.ones(3072), np.zeros(3072))] * 4)
    )
    pipeline = make_device_pipeline(slices=8, fold=200, stt_sections=4)
    aligned, stitched, n_valid, n_stt, params = pipeline(
        jnp.asarray(pan1_h), jnp.asarray(pan2_h), mss, pp, pp, mp
    )
    # the logged params are the fit/stt values the resamples consumed
    assert np.asarray(params[0]).shape == (4, 2)
    assert np.asarray(params[1]).shape == (4, 3)
    assert aligned.shape == (lines_mss, 3072, 4)
    assert stitched.shape == (lines_pan, 2 * (PIXELS_PER_LINE - 200))
    assert aligned.dtype == jnp.uint16 and stitched.dtype == jnp.uint16
    check_registration_valid(n_valid)
    check_stt_valid(n_stt)
    # stitch left half is PAN1's RRC'd left columns verbatim (identity RRC)
    np.testing.assert_array_equal(
        np.asarray(stitched[:, : PIXELS_PER_LINE - 200]),
        pan1_h[:, : PIXELS_PER_LINE - 200],
    )


def test_staged_pipeline_matches_fused(rng):
    """make_device_pipeline_staged (the two-execution split used by the
    multi-GB bench's stage-granular software pipelining) must reproduce
    the fused pipeline's outputs on the same scene."""
    from opticalimageprocessor_tpu.constants import PIXELS_PER_LINE
    from opticalimageprocessor_tpu.models.device_pipeline import (
        make_device_pipeline_staged,
    )

    lines_pan = 2048
    lines_mss = lines_pan // 4
    scene = rng.integers(2000, 42000, (lines_mss, 3072)).astype(np.uint16)
    pan1_h = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    pan2_h = np.roll(
        np.roll(pan1_h, 2, axis=0), 200 - 3 - PIXELS_PER_LINE, axis=1
    )
    mss = jnp.asarray(
        np.stack(
            [
                np.roll(np.roll(scene, b % 2, axis=0), b - 1, axis=1)
                for b in range(4)
            ]
        )
    )
    # REAL (non-identity, distinct) RRC params: identity or shared params
    # would let a staged split that drops or swaps an RRC application
    # still match the fused outputs bit-for-bit
    def rand_params(n):
        return jnp.asarray(
            rrc.split_rrc_params(
                0.98 + 0.04 * rng.random(n), rng.normal(0, 20, n)
            )
        )

    p1p = rand_params(PIXELS_PER_LINE)
    p2p = rand_params(PIXELS_PER_LINE)
    mp = jnp.asarray(
        np.stack(
            [
                rrc.split_rrc_params(
                    0.99 + 0.02 * rng.random(3072), rng.normal(0, 10, 3072)
                )
                for _ in range(4)
            ]
        )
    )
    pan1, pan2 = jnp.asarray(pan1_h), jnp.asarray(pan2_h)

    pipeline = make_device_pipeline(slices=8, fold=200, stt_sections=4)
    aligned_f, stitched_f, n_valid_f, n_stt_f, params_f = pipeline(
        pan1, pan2, mss, p1p, p2p, mp
    )

    est, tra = make_device_pipeline_staged(
        slices=8, fold=200, stt_sections=4
    )
    cx, cy, n_valid, raw_dx, raw_dy, n_stt = est(pan1, pan2, mss, p1p, mp)
    aligned_s, stitched_s = tra(
        pan1, pan2, mss, p1p, p2p, mp, cx, cy, raw_dx, raw_dy
    )

    np.testing.assert_array_equal(np.asarray(n_valid), np.asarray(n_valid_f))
    assert int(n_stt) == int(n_stt_f)
    np.testing.assert_array_equal(np.asarray(cx), np.asarray(params_f[0]))
    np.testing.assert_array_equal(np.asarray(cy), np.asarray(params_f[1]))
    np.testing.assert_array_equal(np.asarray(raw_dx), np.asarray(params_f[4]))
    np.testing.assert_array_equal(np.asarray(raw_dy), np.asarray(params_f[5]))
    np.testing.assert_array_equal(
        np.asarray(aligned_s), np.asarray(aligned_f)
    )
    np.testing.assert_array_equal(
        np.asarray(stitched_s), np.asarray(stitched_f)
    )


def test_staged_pipeline_defaults_match_fused():
    """The staged maker mirrors the fused maker's keyword defaults; a
    tuning change to one but not the other would make the multi-GB bench
    silently measure a differently-configured pipeline above vs below
    the staged threshold."""
    import inspect

    from opticalimageprocessor_tpu.models.device_pipeline import (
        make_device_pipeline_staged,
    )

    fused = inspect.signature(make_device_pipeline).parameters
    staged = inspect.signature(make_device_pipeline_staged).parameters
    for name, param in fused.items():
        assert name in staged, f"staged maker lost parameter {name}"
        assert staged[name].default == param.default, (
            name, staged[name].default, param.default,
        )


def test_staged_pipeline_donate_inputs(rng):
    """donate_inputs=True invalidates the strip buffers and still returns
    the right outputs (the bench's cross-stage handoff contract)."""
    from opticalimageprocessor_tpu.models.device_pipeline import (
        make_device_pipeline_staged,
    )

    lines_pan = 1024
    scene = rng.integers(2000, 42000, (lines_pan // 4, 3072)).astype(
        np.uint16
    )
    pan1_h = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    pan2_h = np.roll(np.roll(pan1_h, 2, axis=0), 200 - 3 - 12288, axis=1)
    mss = jnp.asarray(
        np.stack([np.roll(scene, b - 1, axis=1) for b in range(4)])
    )
    pp = jnp.asarray(rrc.split_rrc_params(np.ones(12288), np.zeros(12288)))
    mp = jnp.asarray(
        np.stack([rrc.split_rrc_params(np.ones(3072), np.zeros(3072))] * 4)
    )
    est, tra = make_device_pipeline_staged(
        slices=8, stt_sections=2, donate_inputs=True
    )
    base_e, base_t = make_device_pipeline_staged(slices=8, stt_sections=2)
    pan1, pan2 = jnp.asarray(pan1_h), jnp.asarray(pan2_h)
    cx, cy, _nv, rdx, rdy, _ns = est(pan1, pan2, mss, pp, mp)
    want = base_t(pan1, pan2, mss, pp, pp, mp, cx, cy, rdx, rdy)
    aligned, stitched = tra(pan1, pan2, mss, pp, pp, mp, cx, cy, rdx, rdy)
    np.testing.assert_array_equal(np.asarray(aligned), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(stitched), np.asarray(want[1]))
    # donation is best-effort per backend; when honoured, the buffers are
    # dead after the call and any further read must fail loudly
    if pan1.is_deleted():
        with pytest.raises(RuntimeError):
            _ = np.asarray(pan1)


def test_pipeline_odd_strip_lengths(rng):
    """Arbitrary (prime-ish) strip lengths must not break the fast path
    (stt window heights are rounded to x64)."""
    import jax
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.models import device_pipeline as dp
    from opticalimageprocessor_tpu.ops import rrc

    lines_pan, width = 1310, 640   # lines//10 = 131 (prime)
    pan1 = jnp.asarray(
        rng.integers(0, 65536, (lines_pan, width), dtype=np.uint16)
    )
    pan2 = jnp.roll(pan1, 3, axis=1)
    mss = jnp.asarray(
        rng.integers(
            0, 65536, (4, lines_pan // 4, width // 4), dtype=np.uint16
        )
    )
    params = jnp.asarray(
        rrc.split_rrc_params(np.ones(width), np.zeros(width))
    )
    bparams = jnp.asarray(
        np.stack(
            [rrc.split_rrc_params(np.ones(width // 4), np.zeros(width // 4))]
            * 4
        )
    )
    pipe = dp.make_device_pipeline(
        slices=8, stt_sections=2, overlap_cols=32, fold=32
    )
    aligned, stitched, n_valid, n_stt, _params = jax.jit(pipe)(
        pan1, pan2, mss, params, params, bparams
    )
    assert aligned.shape == (lines_pan // 4, width // 4, 4)
    assert stitched.shape == (lines_pan, 2 * (width - 32))


def test_fit_poly_matches_float64(rng):
    """The on-device dd-float32 fit (ops/ddf32) matches the host float64
    Vandermonde lstsq to sub-1e-6 px over the whole strip — locking the
    NUMERICS envelope for the flagship fit (was ~1e-2 px with plain f32)."""
    import jax

    from opticalimageprocessor_tpu.models.device_pipeline import _fit_poly

    cx = np.tile((np.arange(10) * 1228.8 + 614.4).astype(np.float32), 5)
    true = (0.73, 2.1e-4, -3.7e-9)
    y64 = (
        true[0]
        + true[1] * cx.astype(np.float64)
        + true[2] * cx.astype(np.float64) ** 2
        + rng.normal(0, 0.03, cx.size)
    )
    y = y64.astype(np.float32)
    w = (rng.random(cx.size) > 0.2).astype(np.float32)
    for deg in (1, 2):
        c_dev = np.asarray(
            jax.jit(lambda cx, y, w, d=deg: _fit_poly(cx, y, d, w))(
                jnp.asarray(cx), jnp.asarray(y), jnp.asarray(w)
            )
        )
        m = w > 0
        v = np.vander(cx[m].astype(np.float64), deg + 1, increasing=True)
        c_host, *_ = np.linalg.lstsq(v, y[m].astype(np.float64), rcond=None)
        x = np.linspace(0.0, 12288.0, 2049)
        dev_eval = sum(c_dev[k] * x**k for k in range(deg + 1))
        host_eval = sum(c_host[k] * x**k for k in range(deg + 1))
        assert np.abs(dev_eval - host_eval).max() < 1e-6, (
            deg, c_dev, c_host,
        )


def test_windowed_peak_edge_behaviour(rng):
    """Adversarial check of the fast peak's +-win window claim
    (device_pipeline.py register_fast / phasecorr.peak_from_spectra_windowed):
    a shift inside the window registers accurately; a shift AT the window
    edge must not produce a silently-wrong value; a shift BEYOND the window
    surfaces as low-response samples and trips the reference's loud
    min-count error — never a plausible-but-wrong small shift."""
    lines_mss, band_px = 512, 768
    scene, pan = _scene_pair(rng, lines_mss, band_px)
    win = 16  # PAN pixels

    def run(roll_px):
        mss = np.stack([np.roll(scene, roll_px, axis=1)] * 4)
        return register_fast(
            jnp.asarray(pan), jnp.asarray(mss), slices=8, n_sections=1,
            win=(win, win),
        )

    # inside: band roll 3 -> PAN shift 12 < 16
    coeffs, n_valid = run(3)
    check_registration_valid(n_valid)
    assert abs(float(coeffs[0][0][0]) - 12.0) < 0.3

    # at the edge: PAN shift exactly 16 == win; the truncated centroid must
    # still land on the true peak (no silent small-shift bias)
    coeffs_e, n_valid_e = run(4)
    if int(np.asarray(n_valid_e)[0]) >= 5:
        assert abs(float(coeffs_e[0][0][0]) - 16.0) < 1.0, coeffs_e[0][0]

    # beyond: PAN shift 32 >> 16; the true peak is outside the evaluated
    # window, so every sample must FAIL the response filter (loud error),
    # not fit a wrong in-window shift
    _, n_valid_b = run(8)
    assert int(np.asarray(n_valid_b)[0]) < 5, np.asarray(n_valid_b)
    with pytest.raises(RuntimeError, match="Not enough valid correlation"):
        check_registration_valid(n_valid_b)


def test_fast_stt_rounding_vs_parity_geometry(rng):
    """Measure the fast stt's x64 window rounding (device_pipeline
    stt_estimate_fast) against the reference window geometry
    (stitcher.h:151-156: exact line_per_section, optimal-DFT padding, full
    peak search) on the same strips: the sampled windows differ, the
    averaged deltas must not (<< 0.1 px on a common scene)."""
    from opticalimageprocessor_tpu.ops import phasecorr

    lines, width, ov, sections, lps = 1000, 640, 64, 3, 333
    wide = rng.integers(2000, 42000, (lines + 8, 2 * width)).astype(np.uint16)
    pan1 = np.ascontiguousarray(wide[4 : 4 + lines, :width])
    pan2 = np.ascontiguousarray(
        wide[2 : 2 + lines, width - ov + 3 : 2 * width - ov + 3]
    )

    # parity estimate on the reference geometry (no x64 rounding)
    gap = (lines - sections * lps) // (sections + 1)
    step = gap + lps
    dxs, dys, rss = [], [], []
    for i in range(sections):
        off = gap + i * step
        t1 = pan1[off : off + lps, width - ov :].astype(np.float32)
        t2 = pan2[off : off + lps, :ov].astype(np.float32)
        dx, dy, r = phasecorr.phase_correlate(t1, t2)
        dxs.append(dx)
        dys.append(dy)
        rss.append(r)
    ok = [i for i in range(sections) if rss[i] >= 0.4]
    assert ok
    dx_p = float(np.mean([dxs[i] for i in ok]))
    dy_p = float(np.mean([dys[i] for i in ok]))

    dx_f, dy_f, _, n = stt_estimate_fast(
        jnp.asarray(pan1), jnp.asarray(pan2), sections=sections,
        line_per_section=lps, overlap_cols=ov,
    )
    check_stt_valid(n)
    # both recover the constructed (-3, +2) offset; fast-mode's rounded
    # window geometry moves the average by far less than the validity
    # threshold's own granularity
    assert abs(dx_p - (-3.0)) < 0.2 and abs(dy_p - 2.0) < 0.2
    assert abs(float(dx_f) - dx_p) < 0.1, (float(dx_f), dx_p)
    assert abs(float(dy_f) - dy_p) < 0.1, (float(dy_f), dy_p)


def test_stt_sections_exceed_strip_raises(rng):
    """Reference parity: too many stt sections for the strip is the host
    Stitcher ctor's error, not silently clamped duplicate windows."""
    import jax.numpy as jnp
    import pytest

    from opticalimageprocessor_tpu.models import device_pipeline as dp

    pan = jnp.asarray(rng.integers(0, 65536, (512, 640), dtype=np.uint16))
    with pytest.raises(ValueError, match="less than sections times"):
        dp.stt_estimate_fast(pan, pan, sections=10, overlap_cols=32)


def test_stt_windowed_peak_beyond_window_fails_loudly(rng):
    """stt counterpart of the register window-edge check: a mounting
    offset beyond the fast peak's +-win window must surface as ZERO valid
    sections (the reference's 'No valid delta value found' hard error),
    never as a silently wrong small translation."""
    lines, width, ov, win = 1024, 512, 64, 8
    wide = rng.integers(2000, 42000, (lines + 64, 2 * width)).astype(np.uint16)
    pan1 = np.ascontiguousarray(wide[32 : 32 + lines, :width])

    def pair(dx, dy):
        return np.ascontiguousarray(
            wide[32 - dy : 32 - dy + lines,
                 width - ov + dx : 2 * width - ov + dx]
        )

    # inside the window: registers accurately
    dxv, dyv, _, n = stt_estimate_fast(
        jnp.asarray(pan1), jnp.asarray(pair(3, 2)), sections=2,
        overlap_cols=ov, win=(win, win),
    )
    check_stt_valid(n)
    assert abs(float(dxv) + 3.0) < 0.2 and abs(float(dyv) - 2.0) < 0.2

    # beyond the window (|dx| = 20 > 8): every section must fail the
    # response filter -> loud error
    _, _, _, n0 = stt_estimate_fast(
        jnp.asarray(pan1), jnp.asarray(pair(20, 0)), sections=2,
        overlap_cols=ov, win=(win, win),
    )
    assert int(n0) == 0, int(n0)
    with pytest.raises(RuntimeError, match="No valid delta value"):
        check_stt_valid(n0)
