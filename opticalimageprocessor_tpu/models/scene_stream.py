"""Streamed whole-scene pipeline: the fused fast path without the HBM bound.

``models/scene.run_scene`` keeps the whole scene HBM-resident (~10x the
PAN bytes).  This module runs the *same fast-mode math* on scenes of any
size with bounded HBM and host RSS, exploiting the reference's own data
flow (preproc.h:245-259, stitcher.h:151-156): parameter estimation only
ever reads *sampled windows*, and every whole-strip stage (RRC, the
alignment/prestitch resamples, the seam concat) is line-local up to a few
halo rows.

Phase 1 — estimation from sampled windows only:
  * per registration section, upload just that section's sections x
    slices tiles straight from the memory maps and run the batched fast
    windowed correlation (the register_fast per-tile math, RRC applied
    per tile on device);
  * upload the stt overlap windows (uncorrected strips, reference order
    main.cpp:280-284) and run the windowed peaks;
  * fit with the same on-device dd-f32 fit and average/clamp the stt
    deltas with the same jitted expressions as the resident pipeline —
    so the estimated parameters are bit-identical to
    ``make_device_pipeline``'s on the same scene.

Phase 2 — streamed transform:
  * sections of ``section_rows`` PAN lines are uploaded with their halo
    rows (true neighbour rows from the file; zeros at strip ends), pushed
    through ONE jitted section step (RRC both PANs + bands, banded-matmul
    alignment + prestitch resamples, seam concat), and drained into the
    streaming writers;
  * the next section's device work is dispatched *before* the previous
    section's host drain (JAX async dispatch), overlapping DMA/compute
    with file IO — the double-buffered streaming the blueprint promised
    (SURVEY §7);
  * chunk boundaries inside a section and section boundaries both read
    true neighbour rows, exactly like the resident chunked remap — the
    streamed outputs are bit-identical to the resident pipeline's
    (locked by ``test_scene_streamed_matches_resident``).

With ``mss2_file`` the prestitched PAN2 is also materialised as
``.PRESTT.RAW`` (reference naming) and CMOS2's MSS aligns against it the
same way (sampled-window estimation + streamed remap), then the two
ALIGNED rasters stitch by streaming both TIFFs.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ..constants import (
    BYTES_PER_PIXEL,
    IBCV_DEF_THRESHOLD,
    IBPA_STEM_EXT,
    MSS_BANDS,
    PIXELS_PER_LINE,
    PRESTT_STEM_EXT,
    TIFF_FILE_EXT,
)
from ..formats.naming import build_output_file_path
from ..formats.rrc_csv import load_split_params
from ..io import raw as raw_io
from ..io import tiff as tiff_io
from ..utils.logging import olog, stage


def _window_rows(mm, lines: int, a: int, b: int) -> np.ndarray:
    """Rows [a, b) of a (lines, W) memory map with zero fill outside the
    strip (the resample's border-0 at strip ends)."""
    out = np.zeros((b - a,) + mm.shape[1:], np.uint16)
    lo, hi = max(a, 0), min(b, lines)
    if hi > lo:
        out[lo - a : hi - a] = mm[lo:hi]
    return out


# ---------------------------------------------------------------------------
# jitted programs (estimation + section step)
# ---------------------------------------------------------------------------

def _reg_batch_fn():
    import jax
    import jax.numpy as jnp

    from ..ops.rrc import rrc_apply
    from ..ops import phasecorr

    @functools.partial(
        jax.jit, static_argnames=("pad", "dot_dtype", "win")
    )
    def reg_batch(
        pan_tiles, band_tiles, pan_par, mss_par,
        *, pad, dot_dtype, win,
    ):
        """(Ts, R, C) x (Ts, 4, r, c) tiles + per-tile RRC param slices ->
        (dx, dy, rs) each (Ts, 4)."""
        def one(args):
            pt, bt, pp, mp = args
            pan_c = rrc_apply(pt, pp)
            bs_c = jnp.stack(
                [rrc_apply(bt[b], mp[b]) for b in range(MSS_BANDS)]
            )
            return phasecorr.band_window_peaks(
                pan_c, bs_c, pad, win, dot_dtype
            )

        return jax.lax.map(one, (pan_tiles, band_tiles, pan_par, mss_par))

    return reg_batch


def _stt_batch_fn():
    import jax

    from ..ops import phasecorr

    @functools.partial(jax.jit, static_argnames=("pad", "win"))
    def stt_batch(t1, t2, *, pad, win):
        import jax.numpy as jnp

        f32 = jnp.float32

        def one(args):
            f1r, f1i = phasecorr.rfft2_padded(args[0].astype(f32), pad)
            f2r, f2i = phasecorr.rfft2_padded(args[1].astype(f32), pad)
            return phasecorr.peak_from_spectra_windowed(
                f1r, f1i, f2r, f2i, pad, win[0], win[1]
            )

        return jax.lax.map(one, (t1, t2))

    return stt_batch


def _fit_fn():
    import jax

    from ..parallel.sharded_scene import _fit_bands

    @functools.partial(jax.jit, static_argnames=("threshold",))
    def fit(centers, dx, dy, rs, *, threshold):
        return _fit_bands(centers, dx, dy, rs, threshold)

    return fit


def _stt_avg_fn():
    import jax
    import jax.numpy as jnp

    @functools.partial(
        jax.jit,
        static_argnames=(
            "threshold", "max_delta_y", "col_halo", "prestt_row_bound",
        ),
    )
    def stt_avg(dx, dy, rs, *, threshold, max_delta_y, col_halo,
                prestt_row_bound):
        """Masked average + clamps, the exact expressions of
        stt_estimate_fast + make_device_pipeline (bit-parity with the
        resident program)."""
        f32 = jnp.float32
        ok = rs >= threshold
        if max_delta_y > 0.0:
            ok = ok & (jnp.abs(dy) <= max_delta_y)
        w = ok.astype(f32)
        n = w.sum()
        denom = jnp.maximum(n, 1.0)
        raw_dx = (dx * w).sum() / denom
        raw_dy = (dy * w).sum() / denom
        dxs = jnp.clip(raw_dx, -(col_halo - 2.0), col_halo - 2.0)
        dys = jnp.clip(
            raw_dy, -(prestt_row_bound - 2.0), prestt_row_bound - 2.0
        )
        return dxs, dys, raw_dx, raw_dy, n.astype(jnp.int32)

    return stt_avg


def _section_math(
    p1_sec, p2_pad, mss_pad, p2_mask, mss_mask,
    pan1_par, pan2_par, mss_par, coeff_x, coeff_y, dxs, dys,
    *, fold, chunk_rows, row_bound, prestt_row_bound, col_block,
    col_halo,
):
    """One streamed section: RRC + resamples + concat (shared by the
    single-device jit and the shard_map local body — every output row is
    a function of its halo'd neighbourhood and the fitted constants only,
    so the same math gives bit-identical rows under any row partitioning).

    ``p1_sec``: (S, W) u16 (no halo — concat only); ``p2_pad``:
    (S + 2*(prestt_row_bound+2), W); ``mss_pad``:
    (4, S/4 + 2*(row_bound+2), W/4) — halo rows are true neighbour
    rows from the file.  ``p2_mask``/``mss_mask`` flag rows inside
    the strip: rows beyond the strip must read the resample's
    border value 0 *after* RRC (the RRC bias would otherwise turn
    the zero-filled file rows nonzero — the resident pipeline pads
    post-RRC)."""
    import jax.numpy as jnp

    from ..ops import resample
    from ..ops.rrc import rrc_apply

    width = p1_sec.shape[1]
    sec_rows = p1_sec.shape[0]

    p1c = rrc_apply(p1_sec, pan1_par)
    p2c = jnp.where(
        p2_mask[:, None], rrc_apply(p2_pad, pan2_par), jnp.uint16(0)
    )
    prestt = resample._remap_const_over_padded(
        resample.pad_for_fast_remap(
            p2c, sec_rows, chunk_rows, prestt_row_bound
        ),
        sec_rows, dxs, dys, chunk_rows, prestt_row_bound,
        col_block, col_halo,
    )
    stitched = jnp.concatenate(
        [p1c[:, : width - fold], prestt[:, fold:]], axis=1
    )
    aligned = _mss_section_math(
        mss_pad, mss_mask, mss_par, coeff_x, coeff_y,
        chunk_rows=chunk_rows, row_bound=row_bound,
        col_block=col_block, col_halo=col_halo,
    )
    return aligned, stitched, prestt


def _mss_section_math(
    mss_pad, mss_mask, mss_par, coeff_x, coeff_y,
    *, chunk_rows, row_bound, col_block, col_halo,
):
    """RRC + alignment resample of a halo'd (4, rows, W/4) band section
    (``mss_mask`` zeroes the beyond-strip halo rows post-RRC)."""
    import jax.numpy as jnp

    from ..ops import resample
    from ..ops.rrc import rrc_apply

    f32 = jnp.float32
    sec_b = mss_pad.shape[1] - 2 * (row_bound + 2)
    band_w = mss_pad.shape[2]
    outs = []
    for b in range(MSS_BANDS):
        bc = jnp.where(
            mss_mask[:, None], rrc_apply(mss_pad[b], mss_par[b]),
            jnp.uint16(0),
        )
        col_matrix = resample._col_interp_matrix(
            jnp.asarray(coeff_x[b], f32), band_w, col_block, col_halo
        )
        g = resample._band_g(coeff_y[b], band_w)
        outs.append(
            resample._remap_fast_over_padded(
                resample.pad_for_fast_remap(
                    bc, sec_b, chunk_rows, row_bound
                ),
                sec_b, coeff_x[b], coeff_y[b], chunk_rows, row_bound,
                col_matrix, g,
            )
        )
    return jnp.stack(outs, axis=-1)


def _section_step_fn():
    import jax

    @functools.partial(
        jax.jit,
        static_argnames=(
            "fold", "chunk_rows", "row_bound", "prestt_row_bound",
            "col_block", "col_halo",
        ),
    )
    def section_step(*args, **kw):
        return _section_math(*args, **kw)

    return section_step


def _section_step_mesh_fn(mesh):
    """Mesh variant of the section step: the host stacks per-device row
    blocks (each with its own true-neighbour halos, so no collectives are
    needed) and every device runs the identical section math on its block
    under shard_map — per-chip HBM is bounded by section_rows/N."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import LINE_AXIS

    @functools.partial(
        jax.jit,
        static_argnames=(
            "fold", "chunk_rows", "row_bound", "prestt_row_bound",
            "col_block", "col_halo",
        ),
    )
    def section_step(
        p1_st, p2_st, mss_st, p2m_st, mssm_st,
        pan1_par, pan2_par, mss_par, coeff_x, coeff_y, dxs, dys,
        **static,
    ):
        def local(p1_l, p2_l, mss_l, p2m_l, mssm_l, *params):
            aligned, stitched, prestt = _section_math(
                p1_l[0], p2_l[0], mss_l[0], p2m_l[0], mssm_l[0],
                *params, **static,
            )
            return aligned[None], stitched[None], prestt[None]

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(LINE_AXIS),) * 5 + (P(),) * 7,
            out_specs=(P(LINE_AXIS),) * 3,
            check_vma=False,
        )(
            p1_st, p2_st, mss_st, p2m_st, mssm_st,
            pan1_par, pan2_par, mss_par, coeff_x, coeff_y, dxs, dys,
        )

    return section_step


def _mss_section_fn():
    import jax

    @functools.partial(
        jax.jit,
        static_argnames=("chunk_rows", "row_bound", "col_block", "col_halo"),
    )
    def mss_section(*args, **kw):
        """Streamed CMOS2 MSS section: RRC + alignment resample only."""
        return _mss_section_math(*args, **kw)

    return mss_section


def _mss_section_mesh_fn(mesh):
    """Mesh variant of the CMOS2 MSS section step (host-stacked per-device
    halo'd blocks, same math per device under shard_map)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import LINE_AXIS

    @functools.partial(
        jax.jit,
        static_argnames=("chunk_rows", "row_bound", "col_block", "col_halo"),
    )
    def mss_section(mss_st, mssm_st, mss_par, coeff_x, coeff_y, **static):
        def local(mss_l, mssm_l, *params):
            return _mss_section_math(
                mss_l[0], mssm_l[0], *params, **static
            )[None]

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(LINE_AXIS),) * 2 + (P(),) * 3,
            out_specs=P(LINE_AXIS),
            check_vma=False,
        )(mss_st, mssm_st, mss_par, coeff_x, coeff_y)

    return mss_section


# ---------------------------------------------------------------------------
# estimation driver (sampled windows only)
# ---------------------------------------------------------------------------

def _estimate_registration(
    pan_strip, mss_strip, pan_params, mss_params,
    slices, n_sections, threshold, win, pan_corrected: bool,
):
    """Phase-1 registration: per section, upload just the sampled tiles
    and run the batched fast windowed correlation; fit on device (dd-f32,
    identical to the resident pipeline's)."""
    import jax
    import jax.numpy as jnp

    from ..parallel.sharded_scene import _RegGeom
    from ..ops import backend, phasecorr, rrc

    geom = _RegGeom.build(
        pan_strip.lines, pan_strip.pixels_per_line, slices, n_sections
    )
    pad = (geom.corr_rows, geom.cols)
    win = phasecorr.clamp_win(win, pad)
    dot_dtype = backend.band_dot_dtype()
    reg_batch = _reg_batch_fn()

    band_px = mss_strip.pixels_per_line // MSS_BANDS
    mss_view = mss_strip._mm.reshape(mss_strip.lines, MSS_BANDS, band_px)
    ident_pan = rrc.split_rrc_params(
        np.ones(pan_strip.pixels_per_line),
        np.zeros(pan_strip.pixels_per_line),
    )

    stats = []
    for sec in range(geom.n_sections):
        row0 = sec * geom.sec_stride
        br0 = row0 // MSS_BANDS
        pan_tiles = np.stack(
            [
                np.ascontiguousarray(
                    pan_strip._mm[
                        row0 : row0 + geom.corr_rows,
                        i * geom.cols : (i + 1) * geom.cols,
                    ]
                )
                for i in range(slices)
            ]
        )
        band_tiles = np.stack(
            [
                np.stack(
                    [
                        np.ascontiguousarray(
                            mss_view[
                                br0 : br0 + geom.brows,
                                b,
                                i * geom.bcols : (i + 1) * geom.bcols,
                            ]
                        )
                        for b in range(MSS_BANDS)
                    ]
                )
                for i in range(slices)
            ]
        )
        # per-tile RRC param column slices (identity when the source is
        # already corrected, e.g. the prestitched PAN2)
        pan_src = ident_pan if pan_corrected else pan_params
        pan_par = np.stack(
            [
                pan_src[:, i * geom.cols : (i + 1) * geom.cols]
                for i in range(slices)
            ]
        )
        mss_par = np.stack(
            [
                mss_params[:, :, i * geom.bcols : (i + 1) * geom.bcols]
                for i in range(slices)
            ]
        )
        dx, dy, rs = reg_batch(
            jnp.asarray(pan_tiles), jnp.asarray(band_tiles),
            jnp.asarray(pan_par, jnp.float32),
            jnp.asarray(mss_par, jnp.float32),
            pad=pad, dot_dtype=dot_dtype, win=win,
        )
        stats.append((dx, dy, rs))

    dx = jnp.concatenate([s[0] for s in stats])
    dy = jnp.concatenate([s[1] for s in stats])
    rs = jnp.concatenate([s[2] for s in stats])
    fit = _fit_fn()
    coeff_x, coeff_y, n_valid = fit(
        geom.centers, dx, dy, rs, threshold=threshold
    )
    return coeff_x, coeff_y, n_valid


def _estimate_stt(
    p1, p2, stt_sections, overlap_cols, threshold, max_delta_y,
    col_halo, prestt_row_bound, win,
):
    """Phase-1 stt: upload the sampled overlap windows of the uncorrected
    strips (reference order) and run the fast windowed peaks."""
    import jax.numpy as jnp

    from ..ops import phasecorr

    lines = p1.lines
    width = p1.pixels_per_line
    lps = max(64, min(16000, lines // stt_sections))
    lps = max(64, lps - lps % 64)
    if stt_sections * lps > lines:
        raise ValueError(
            "PAN line count less than sections times line-per-section, "
            "use smaller -s and/or -l value(s)"
        )
    gap = (lines - stt_sections * lps) // (stt_sections + 1)
    step = gap + lps
    pad = (lps, overlap_cols)
    win = phasecorr.clamp_win(win, pad)
    t1 = np.stack(
        [
            np.ascontiguousarray(
                p1._mm[gap + i * step : gap + i * step + lps,
                       width - overlap_cols :]
            )
            for i in range(stt_sections)
        ]
    )
    t2 = np.stack(
        [
            np.ascontiguousarray(
                p2._mm[gap + i * step : gap + i * step + lps, :overlap_cols]
            )
            for i in range(stt_sections)
        ]
    )
    stt_batch = _stt_batch_fn()
    dx, dy, rs = stt_batch(
        jnp.asarray(t1), jnp.asarray(t2), pad=pad, win=win
    )
    return _stt_avg_fn()(
        dx, dy, rs, threshold=threshold, max_delta_y=max_delta_y,
        col_halo=col_halo, prestt_row_bound=prestt_row_bound,
    )


# ---------------------------------------------------------------------------
# streamed driver
# ---------------------------------------------------------------------------

def run_scene_streamed(*args, profile_dir: str = "", **kw):
    """Run the streamed scene pipeline (see :func:`_run_scene_streamed`);
    with ``profile_dir`` the whole run is wrapped in a JAX device profile
    (utils.logging.device_profile)."""
    from ..utils.logging import device_profile

    with device_profile(profile_dir):
        return _run_scene_streamed(*args, **kw)


def _run_scene_streamed(
    pan1_file: str,
    pan2_file: str,
    mss_file: str,
    rrc_pan1: str = "",
    rrc_pan2: str = "",
    rrc_mss_files: tuple[str, str, str, str] | None = None,
    mss2_file: str = "",
    rrc_mss2_files: tuple[str, str, str, str] | None = None,
    slices: int = 10,
    sections: int | None = None,
    fold_cols: int = 200,
    stt_sections: int = 10,
    threshold: float = IBCV_DEF_THRESHOLD,
    stt_threshold: float = IBCV_DEF_THRESHOLD,
    stt_max_delta_y: float = 0.0,
    out_stitched: str = "",
    out_stitched_mss: str = "",
    out_dir: str | None = None,
    pixels_per_line: int = PIXELS_PER_LINE,
    bgr_tiff_order: bool = True,
    section_rows: int = 4096,
    chunk_rows: int = 512,
    row_bound: int = 3,
    mss2_row_bound: int = 6,
    col_block: int = 128,
    col_halo: int = 16,
    prestt_row_bound: int = 8,
    mesh: int = 0,
):
    """Streamed scene: same outputs as ``run_scene`` (bit-identical on the
    same scene) with HBM and host RSS bounded by one ``section_rows``
    section regardless of strip size.

    ``mesh=N`` (`scene --stream --mesh N`) runs N streamed sections
    concurrently, one per device of an N-device line mesh: the host
    stacks N single-device-SHAPED section blocks, each carrying its own
    true-neighbour halo rows, so every device runs the identical section
    program with no collectives — per-chip HBM stays bounded by one
    section and the transform rate scales with N.  Keeping the per-device
    block shape equal to the single-device section shape keeps the
    outputs BIT-identical to the unsharded stream (XLA codegen is
    shape-dependent at small block sizes).  Estimation (phase 1) stays
    single-device: it reads only sampled windows and is a negligible
    share of the work."""
    import jax
    import jax.numpy as jnp

    from .device_pipeline import check_registration_valid, check_stt_valid

    if mss2_file and out_stitched_mss and (
        os.path.splitext(out_stitched_mss)[1].lower() not in (".tiff", ".tif")
    ):
        raise ValueError("Output file should be a tiff image")

    band_px = pixels_per_line // MSS_BANDS
    p1 = raw_io.RawStrip(pan1_file, pixels_per_line)
    p2 = raw_io.RawStrip(pan2_file, pixels_per_line)
    ms = raw_io.RawStrip(mss_file, pixels_per_line)
    if p1.nbytes != p2.nbytes:
        raise ValueError("PAN1 size doesn't match PAN2 size")
    raw_io.check_pan_mss_sizes(p1, ms)
    olog(
        "Streamed scene: PAN %d lines, MSS %d lines, %d-line sections.",
        p1.lines, ms.lines, section_rows,
    )
    section_rows = min(section_rows, max(chunk_rows, p1.lines))
    if section_rows % MSS_BANDS:
        raise ValueError("section_rows must be a multiple of 4")
    if mesh < 0:
        raise ValueError(f"mesh must be >= 0, got {mesh}")
    mesh_obj = None
    if mesh:
        if len(jax.devices()) < mesh:
            raise RuntimeError(
                f"--mesh {mesh} needs {mesh} devices, only "
                f"{len(jax.devices())} available"
            )
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import LINE_AXIS, line_mesh

        mesh_obj = line_mesh(mesh)
        shard_line = NamedSharding(mesh_obj, P(LINE_AXIS))
        olog(
            "Streamed scene sharded over %d-device '%s' mesh "
            "(%d sections of %d PAN lines in flight).",
            mesh, LINE_AXIS, mesh, section_rows,
        )

    pan1_params = load_split_params(rrc_pan1, pixels_per_line)
    pan2_params = load_split_params(rrc_pan2, pixels_per_line)
    mss_params = np.stack(
        [
            load_split_params(f, band_px)
            for f in (rrc_mss_files or ("",) * 4)
        ]
    )

    # ---- phase 1: estimation from sampled windows
    with stage("stream_estimate", 0):
        coeff_x, coeff_y, n_valid = _estimate_registration(
            p1, ms, pan1_params, mss_params, slices, sections, threshold,
            (64, 64), pan_corrected=False,
        )
        dxs, dys, raw_dx, raw_dy, n_stt = _estimate_stt(
            p1, p2, stt_sections, fold_cols, stt_threshold,
            stt_max_delta_y, col_halo, prestt_row_bound, (64, 64),
        )
    check_registration_valid(np.asarray(n_valid))
    check_stt_valid(np.asarray(n_stt))
    from .scene import log_scene_params

    log_scene_params(
        (coeff_x, coeff_y, dxs, dys, raw_dx, raw_dy),
        np.asarray(n_valid), int(n_stt),
    )

    # ---- phase 2: streamed RRC + resamples + concat
    fold = fold_cols // 2
    order = [2, 1, 0, 3] if bgr_tiff_order else [0, 1, 2, 3]
    aligned_path = build_output_file_path(
        mss_file, IBPA_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir
    )
    st_w = 2 * (pixels_per_line - fold)
    if not out_stitched:
        out_stitched = os.path.join(
            out_dir or os.getcwd(),
            f"stitched_{st_w}n{BYTES_PER_PIXEL * 8}b{TIFF_FILE_EXT}",
        )
    stitched_tiff = os.path.splitext(out_stitched)[1].lower() in (
        ".tiff", ".tif",
    )
    aligned_w = tiff_io.TiffStripWriter(
        aligned_path, band_px, ms.lines, samples=MSS_BANDS
    )
    stitched_w = (
        tiff_io.TiffStripWriter(out_stitched, st_w, p1.lines, samples=1)
        if stitched_tiff
        else raw_io.RawStripWriter(out_stitched, st_w)
    )
    prestt_path = ""
    prestt_w = None
    if mss2_file:
        prestt_path = build_output_file_path(
            pan2_file, PRESTT_STEM_EXT, out_dir=out_dir
        )
        prestt_w = raw_io.RawStripWriter(prestt_path, pixels_per_line)

    step = (
        _section_step_mesh_fn(mesh_obj) if mesh_obj else _section_step_fn()
    )
    params_dev = (
        jnp.asarray(pan1_params, jnp.float32),
        jnp.asarray(pan2_params, jnp.float32),
        jnp.asarray(mss_params, jnp.float32),
    )
    halo_p = prestt_row_bound + 2
    halo_b = row_bound + 2
    sec_b = section_rows // MSS_BANDS
    # with a mesh, N single-device-SHAPED sections run concurrently (one
    # per device): every device block is the exact section the one-device
    # loop would process, so the per-row programs compile to the same
    # shapes and the outputs stay bit-identical to the unsharded stream
    # (XLA codegen is shape-dependent at small block sizes — measured
    # 1 DN flips when the same rows go through differently-shaped blocks)
    span = section_rows * (mesh or 1)
    n_secs = -(-p1.lines // span)

    def stack_blocks(base, n, local, halo):
        """(rows, ...) halo'd window -> (n, local + 2*halo, ...) per-device
        blocks; block d covers rows [d*local - halo, (d+1)*local + halo)
        of the un-halo'd range (true neighbour rows shared at seams)."""
        return np.stack(
            [base[d * local : d * local + local + 2 * halo] for d in range(n)]
        )

    def submit(k):
        a = k * span
        valid = min(span, p1.lines - a)
        ab = a // MSS_BANDS
        span_b = span // MSS_BANDS
        p1_sec = _window_rows(p1._mm, p1.lines, a, a + span)
        p2_pad = _window_rows(
            p2._mm, p2.lines, a - halo_p, a + span + halo_p
        )
        mss_base = _window_rows(
            ms._mm.reshape(ms.lines, MSS_BANDS, band_px),
            ms.lines, ab - halo_b, ab + span_b + halo_b,
        )
        p2m = np.arange(a - halo_p, a + span + halo_p)
        p2m = (p2m >= 0) & (p2m < p2.lines)
        msm = np.arange(ab - halo_b, ab + span_b + halo_b)
        msm = (msm >= 0) & (msm < ms.lines)
        if mesh_obj is None:
            args = (
                jnp.asarray(p1_sec),
                jnp.asarray(p2_pad),
                jnp.asarray(np.ascontiguousarray(mss_base.transpose(1, 0, 2))),
                jnp.asarray(p2m),
                jnp.asarray(msm),
            )
        else:
            dev = jax.device_put
            args = (
                dev(p1_sec.reshape(mesh, section_rows, -1), shard_line),
                dev(
                    stack_blocks(p2_pad, mesh, section_rows, halo_p),
                    shard_line,
                ),
                dev(
                    np.ascontiguousarray(
                        stack_blocks(
                            mss_base, mesh, sec_b, halo_b
                        ).transpose(0, 2, 1, 3)
                    ),
                    shard_line,
                ),
                dev(
                    stack_blocks(p2m, mesh, section_rows, halo_p), shard_line
                ),
                dev(stack_blocks(msm, mesh, sec_b, halo_b), shard_line),
            )
        aligned, stitched, prestt = step(
            *args,
            *params_dev, coeff_x, coeff_y, dxs, dys,
            fold=fold, chunk_rows=chunk_rows, row_bound=row_bound,
            prestt_row_bound=prestt_row_bound, col_block=col_block,
            col_halo=col_halo,
        )
        return aligned, stitched, prestt, valid

    def merge(arr):
        """Host view of a section output, per-device blocks merged."""
        a = np.asarray(arr)
        return a.reshape(-1, *a.shape[2:]) if mesh_obj is not None else a

    def drain(out):
        aligned, stitched, prestt, valid = out
        vb = valid // MSS_BANDS
        aligned_w.write_rows(merge(aligned)[:vb][:, :, order])
        st_h = merge(stitched)[:valid]
        if stitched_tiff:
            stitched_w.write_rows(st_h)
        else:
            stitched_w.write_lines(st_h)
        if prestt_w is not None:
            prestt_w.write_lines(merge(prestt)[:valid])

    with stage("stream_transform", p1.nbytes * 2 + ms.nbytes):
        pending = None
        for k in range(n_secs):
            out = submit(k)          # async dispatch: device works on k
            if pending is not None:
                drain(pending)       # while the host drains k-1
            pending = out
        drain(pending)
    aligned_w.close()
    stitched_w.close()
    if prestt_w is not None:
        prestt_w.close()
    olog("Aligned MSS written to %s", aligned_path)
    olog("Stitched PAN written to %s", out_stitched)
    outs = {"aligned": aligned_path, "stitched": out_stitched}
    if not mss2_file:
        return outs
    outs["prestt"] = prestt_path

    # ---- CMOS2 MSS against the prestitched PAN2 (sample-task steps 3.2+4)
    ms2 = raw_io.RawStrip(mss2_file, pixels_per_line)
    raw_io.check_pan_mss_sizes(p2, ms2)
    mss2_params = np.stack(
        [
            load_split_params(f, band_px)
            for f in (rrc_mss2_files or ("",) * 4)
        ]
    )
    prestt_strip = raw_io.RawStrip(prestt_path, pixels_per_line)
    with stage("stream_estimate_mss2", 0):
        coeff_x2, coeff_y2, n_valid2 = _estimate_registration(
            prestt_strip, ms2, None, mss2_params, slices, sections,
            threshold, (64, 64), pan_corrected=True,
        )
    check_registration_valid(np.asarray(n_valid2))
    from .scene import log_band_coeffs

    log_band_coeffs(coeff_x2, coeff_y2, np.asarray(n_valid2))

    aligned2_path = build_output_file_path(
        mss2_file, IBPA_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir
    )
    aligned2_w = tiff_io.TiffStripWriter(
        aligned2_path, band_px, ms2.lines, samples=MSS_BANDS
    )
    mss_sec = (
        _mss_section_mesh_fn(mesh_obj) if mesh_obj else _mss_section_fn()
    )
    halo_b2 = mss2_row_bound + 2
    mss2_par_dev = jnp.asarray(mss2_params, jnp.float32)

    span_b2 = sec_b * (mesh or 1)

    def submit2(k):
        ab = k * span_b2
        valid = min(span_b2, ms2.lines - ab)
        base = _window_rows(
            ms2._mm.reshape(ms2.lines, MSS_BANDS, band_px),
            ms2.lines, ab - halo_b2, ab + span_b2 + halo_b2,
        )
        r = np.arange(ab - halo_b2, ab + span_b2 + halo_b2)
        mask = (r >= 0) & (r < ms2.lines)
        if mesh_obj is None:
            mss_pad = jnp.asarray(
                np.ascontiguousarray(base.transpose(1, 0, 2))
            )
            mask_dev = jnp.asarray(mask)
        else:
            mss_pad = jax.device_put(
                np.ascontiguousarray(
                    stack_blocks(base, mesh, sec_b, halo_b2).transpose(
                        0, 2, 1, 3
                    )
                ),
                shard_line,
            )
            mask_dev = jax.device_put(
                stack_blocks(mask, mesh, sec_b, halo_b2), shard_line
            )
        aligned = mss_sec(
            mss_pad, mask_dev, mss2_par_dev, coeff_x2, coeff_y2,
            chunk_rows=chunk_rows, row_bound=mss2_row_bound,
            col_block=col_block, col_halo=col_halo,
        )
        return aligned, valid

    n_secs2 = -(-ms2.lines // span_b2)
    with stage("stream_transform_mss2", ms2.nbytes):
        pending2 = None
        for k in range(n_secs2):
            out = submit2(k)
            if pending2 is not None:
                a2, v2 = pending2
                aligned2_w.write_rows(merge(a2)[:v2][:, :, order])
            pending2 = out
        a2, v2 = pending2
        aligned2_w.write_rows(merge(a2)[:v2][:, :, order])
    aligned2_w.close()
    olog("Aligned MSS (CMOS2) written to %s", aligned2_path)

    # stream-stitch the aligned MSS pair (fold_cols/4, half lost each side)
    foldm_half = max(1, fold_cols // MSS_BANDS // 2)
    half = band_px - foldm_half
    if not out_stitched_mss:
        out_stitched_mss = os.path.join(
            out_dir or os.getcwd(), f"stitched-MSS{TIFF_FILE_EXT}"
        )
    wmss = tiff_io.TiffStripWriter(
        out_stitched_mss, 2 * half, ms.lines, samples=MSS_BANDS
    )
    with stage("stream_stitch_mss", ms.lines * 2 * half * MSS_BANDS * 2):
        for b1, b2 in zip(
            tiff_io.iter_tiff_rows(aligned_path, 2048),
            tiff_io.iter_tiff_rows(aligned2_path, 2048),
        ):
            wmss.write_rows(
                np.concatenate([b1[:, :half], b2[:, foldm_half:]], axis=1)
            )
    wmss.close()
    olog("Stitched MSS written to %s", out_stitched_mss)
    outs.update(
        {"aligned2": aligned2_path, "stitched_mss": out_stitched_mss}
    )
    return outs
