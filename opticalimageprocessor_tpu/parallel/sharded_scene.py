"""SPMD fused scene pipeline: the flagship device program over a line mesh.

``models/device_pipeline.make_device_pipeline`` — the bench.py surface —
runs the whole per-scene compute chain (RRC both PANs + the MSS bands,
fast sections x slices registration, dd-f32 polynomial fit, on-device stt
estimation, banded-matmul alignment + prestitch resamples, CMOS seam concat)
as ONE jitted program on one chip.  This module runs the *same fast-mode
math* SPMD over an ``n_devices`` 1-D ``line`` mesh (the ``scene --mesh N``
CLI route):

* elementwise RRC is sharding-preserving over the line axis;
* the registration / stt sampling tiles are extracted in-graph from the
  line-sharded strips and redistributed over the *tile* axis
  (with_sharding_constraint), then each device runs the identical
  single-tile fast math under shard_map — the windowed cross-power peaks
  run the kx contraction in the backend policy's dtype (ops/backend),
  exactly like the single-chip path;
* the tiny (dx, dy, response) statistics are fitted with the same dd-f32
  fit (replicated — XLA inserts the all-gather), so multi-chip
  coefficients match single-chip coefficients given the same samples;
* the alignment and prestitch resamples run under shard_map with
  ppermute halo exchange between devices (true neighbour rows at shard seams —
  the cross-device analogue of the reference's in-process sectioning,
  preproc.h:374-408 / imageop.h:230-275), reusing the banded-matmul chunked
  remap cores (ops/resample._remap_fast_over_padded /
  _remap_const_over_padded);
* the seam concat is a per-shard column concat (no communication).

Semantics: identical fast-mode envelope as the single-chip fused pipeline
(both read true neighbour rows at internal chunk/shard seams); outputs
agree except where FFT partitioning noise moves a fit by ~1e-6 px (see
docs/NUMERICS.md), and the validity-count errors surface identically.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import CORRELATION_LINES, IBCV_DEF_THRESHOLD, MSS_BANDS
from ..ops import backend, phasecorr, resample
from ..ops.rrc import rrc_apply
from .halo import exchange_halo
from .mesh import LINE_AXIS
from .sharded import pad_to  # noqa: F401 — pad_to re-exported


def _pad_tile_axis(t: jax.Array, t_total: int, t_pad: int) -> jax.Array:
    """Round the leading tile axis up to ``t_pad`` by repetition (padding
    work, not correctness: the extra tiles' outputs are sliced off)."""
    if t_pad == t_total:
        return t
    reps = [t] * (t_pad // t_total) + [t[: t_pad % t_total]]
    return jnp.concatenate([r for r in reps if r.shape[0]])


@dataclass(frozen=True)
class _RegGeom:
    """register_fast's fast-mode sampling geometry (device_pipeline)."""

    corr_rows: int
    n_sections: int
    slices: int
    cols: int
    bcols: int
    brows: int
    sec_stride: int

    @classmethod
    def build(cls, lines_pan, width, slices, n_sections):
        corr_rows = min(lines_pan, CORRELATION_LINES)
        corr_rows = max(64, corr_rows - corr_rows % 64)
        if n_sections is None:
            n_sections = max(1, min(5, lines_pan // CORRELATION_LINES))
        cols = width // slices
        sec_stride = (
            (lines_pan - corr_rows) // max(1, n_sections - 1)
            if n_sections > 1
            else 0
        )
        return cls(
            corr_rows, n_sections, slices, cols, cols // MSS_BANDS,
            corr_rows // MSS_BANDS, sec_stride,
        )

    @property
    def t_total(self):
        return self.n_sections * self.slices

    @property
    def centers(self):
        return jnp.tile(
            (jnp.arange(self.slices) * self.cols + self.cols // 2).astype(
                jnp.float32
            ),
            self.n_sections,
        )


def _correlate_sharded(
    mesh, pan_c, mss_c, g: _RegGeom, dot_dtype, win, pan_params=None
):
    """Extract the tile grid from line-sharded strips, redistribute over
    the tile axis, run the fast windowed peaks under shard_map.
    Returns (dx, dy, rs) each (T, 4), replicated.

    With ``pan_params`` the PAN input is the RAW strip and each sampled
    tile is RRC'd at extraction (static per-tile column params slice) —
    the flagship pipeline's structure: the corrected strip is never
    materialised."""
    n_dev = mesh.shape[LINE_AXIS]
    t_pad = -(-g.t_total // n_dev) * n_dev
    pad = (g.corr_rows, g.cols)
    win = phasecorr.clamp_win(win, pad)

    def pan_tile(sec, i):
        t = jax.lax.slice(
            pan_c,
            (sec * g.sec_stride, i * g.cols),
            (sec * g.sec_stride + g.corr_rows, (i + 1) * g.cols),
        )
        if pan_params is not None:
            t = rrc_apply(t, pan_params[:, i * g.cols : (i + 1) * g.cols])
        return t

    pan_tiles = jnp.stack(
        [
            pan_tile(sec, i)
            for sec in range(g.n_sections)
            for i in range(g.slices)
        ]
    )
    band_tiles = jnp.stack(
        [
            jnp.stack(
                [
                    jax.lax.slice(
                        mss_c,
                        (b, (sec * g.sec_stride) // MSS_BANDS, i * g.bcols),
                        (
                            b + 1,
                            (sec * g.sec_stride) // MSS_BANDS + g.brows,
                            (i + 1) * g.bcols,
                        ),
                    )[0]
                    for b in range(MSS_BANDS)
                ]
            )
            for sec in range(g.n_sections)
            for i in range(g.slices)
        ]
    )
    pan_tiles = jax.lax.with_sharding_constraint(
        _pad_tile_axis(pan_tiles, g.t_total, t_pad),
        NamedSharding(mesh, P(LINE_AXIS, None, None)),
    )
    band_tiles = jax.lax.with_sharding_constraint(
        _pad_tile_axis(band_tiles, g.t_total, t_pad),
        NamedSharding(mesh, P(LINE_AXIS, None, None, None)),
    )

    def corr_local(pt, bt):
        return jax.lax.map(
            lambda args: phasecorr.band_window_peaks(
                args[0], args[1], pad, win, dot_dtype
            ),
            (pt, bt),
        )

    dx, dy, rs = jax.shard_map(
        corr_local,
        mesh=mesh,
        in_specs=(
            P(LINE_AXIS, None, None),
            P(LINE_AXIS, None, None, None),
        ),
        out_specs=(P(LINE_AXIS, None),) * 3,
        check_vma=False,
    )(pan_tiles, band_tiles)
    return dx[: g.t_total], dy[: g.t_total], rs[: g.t_total]


def _fit_bands(centers, dx, dy, rs, threshold):
    """Per-band response filter + dd-f32 fit (device_pipeline._fit_poly):
    returns (coeff_x (4,2), coeff_y (4,3), n_valid (4,))."""
    from ..models.device_pipeline import _fit_poly

    f32 = jnp.float32
    coeff_x, coeff_y, n_valid = [], [], []
    for b in range(MSS_BANDS):
        w = (rs[:, b] >= threshold).astype(f32)
        n_valid.append(w.sum().astype(jnp.int32))
        coeff_x.append(_fit_poly(centers, dx[:, b], 1, w))
        coeff_y.append(_fit_poly(centers, dy[:, b], 2, w))
    return jnp.stack(coeff_x), jnp.stack(coeff_y), jnp.stack(n_valid)


def _align_local(mss_l, cxs, cys, loc_mss, chunk_rows, row_bound,
                 col_block, col_halo):
    """Per-shard 4-band alignment resample with ppermute halos."""
    f32 = jnp.float32
    halo = row_bound + 2
    band_w = mss_l.shape[2]
    outs = []
    for b in range(MSS_BANDS):
        col_matrix = resample._col_interp_matrix(
            jnp.asarray(cxs[b], f32), band_w, col_block, col_halo
        )
        g = resample._band_g(cys[b], band_w)
        padded = resample.pad_for_fast_remap(
            exchange_halo(mss_l[b], halo, halo, LINE_AXIS),
            loc_mss, chunk_rows, row_bound,
        )
        outs.append(
            resample._remap_fast_over_padded(
                padded, loc_mss, cxs[b], cys[b], chunk_rows, row_bound,
                col_matrix, g,
            )
        )
    return jnp.stack(outs, axis=-1)


@functools.lru_cache(maxsize=4)
def make_sharded_scene_fn(
    mesh: Mesh,
    lines_pan: int,
    width: int,
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
    win: tuple[int, int] = (64, 64),
    return_prestt: bool = False,
):
    """Build the jitted SPMD scene pipeline over ``mesh`` (axis 'line').

    Same signature and outputs as
    ``models.device_pipeline.make_device_pipeline`` — (pan1, pan2, mss,
    pan1_params, pan2_params, mss_params) -> (aligned, stitched[, prestt],
    n_valid_register, n_valid_stt, params) — with the strip inputs
    line-sharded and the raster outputs line-sharded (drain via
    addressable_shards); the fitted ``params`` are replicated.

    Strip-length contract: line-sharded arrays must divide the mesh
    evenly, so callers ZERO-PAD the strips at the bottom to
    ``pad_to(mesh, lines)`` rows (``lines_pan`` here is the REAL strip
    length; the program masks the pad rows to border-0 post-RRC) and
    trim the outputs — which come back at the padded length — when
    draining.
    """
    f32 = jnp.float32
    n_dev = mesh.shape[LINE_AXIS]
    dot_dtype = backend.band_dot_dtype(
        backend.platform_of(mesh.devices.flat)
    )
    lines_mss = lines_pan // MSS_BANDS
    lines_pan_pad = pad_to(mesh, lines_pan)
    lines_mss_pad = pad_to(mesh, lines_mss)
    geom = _RegGeom.build(lines_pan, width, slices, n_sections)

    # --- stt geometry (stt_estimate_fast) ---
    lps = stt_lines or max(64, min(16000, lines_pan // stt_sections))
    lps = max(64, lps - lps % 64)
    if stt_sections * lps > lines_pan:
        raise ValueError(
            "PAN line count less than sections times line-per-section, "
            "use smaller -s and/or -l value(s)"
        )
    stt_gap = (lines_pan - stt_sections * lps) // (stt_sections + 1)
    stt_step = stt_gap + lps
    s_pad = -(-stt_sections // n_dev) * n_dev
    stt_win = phasecorr.clamp_win(win, (lps, overlap_cols))

    def _stt(pan1, pan2):
        """Sampled overlap windows -> section-sharded windowed peaks ->
        masked average (the CalcSttParameters analogue, on the uncorrected
        strips per the reference order, main.cpp:280-284)."""
        t1 = jnp.stack(
            [
                jax.lax.slice(
                    pan1,
                    (stt_gap + i * stt_step, width - overlap_cols),
                    (stt_gap + i * stt_step + lps, width),
                )
                for i in range(stt_sections)
            ]
        )
        t2 = jnp.stack(
            [
                jax.lax.slice(
                    pan2,
                    (stt_gap + i * stt_step, 0),
                    (stt_gap + i * stt_step + lps, overlap_cols),
                )
                for i in range(stt_sections)
            ]
        )
        t1 = jax.lax.with_sharding_constraint(
            _pad_tile_axis(t1, stt_sections, s_pad),
            NamedSharding(mesh, P(LINE_AXIS, None, None)),
        )
        t2 = jax.lax.with_sharding_constraint(
            _pad_tile_axis(t2, stt_sections, s_pad),
            NamedSharding(mesh, P(LINE_AXIS, None, None)),
        )

        def stt_local(a, b):
            def one(args):
                f1r, f1i = phasecorr.rfft2_padded(
                    args[0].astype(f32), (lps, overlap_cols))
                f2r, f2i = phasecorr.rfft2_padded(
                    args[1].astype(f32), (lps, overlap_cols))
                return phasecorr.peak_from_spectra_windowed(
                    f1r, f1i, f2r, f2i, (lps, overlap_cols),
                    stt_win[0], stt_win[1],
                )

            return jax.lax.map(one, (a, b))

        dx, dy, rs = jax.shard_map(
            stt_local,
            mesh=mesh,
            in_specs=(P(LINE_AXIS, None, None),) * 2,
            out_specs=(P(LINE_AXIS),) * 3,
            check_vma=False,
        )(t1, t2)
        dx, dy, rs = dx[:stt_sections], dy[:stt_sections], rs[:stt_sections]
        ok = rs >= stt_threshold
        if stt_max_delta_y > 0.0:
            ok = ok & (jnp.abs(dy) <= stt_max_delta_y)
        w = ok.astype(f32)
        n = w.sum()
        denom = jnp.maximum(n, 1.0)
        return (
            (dx * w).sum() / denom,
            (dy * w).sum() / denom,
            n.astype(jnp.int32),
        )

    def pipeline(pan1, pan2, mss, pan1_params, pan2_params, mss_params):
        # flagship structure: the corrected PAN strips are never
        # materialised — registration RRCs its sampled tiles at
        # extraction, and the remap shard_map RRCs per shard (halo rows
        # exchange post-RRC, so strip-end zeros stay border-0 semantics)
        mss_c = jnp.stack(
            [rrc_apply(mss[b], mss_params[b]) for b in range(MSS_BANDS)]
        )
        if lines_mss_pad != lines_mss:
            # zero-filled pad rows must stay border-0 post-RRC
            rows_m = jnp.arange(lines_mss_pad)
            mss_c = jnp.where(
                (rows_m < lines_mss)[None, :, None], mss_c, jnp.uint16(0)
            )
        dx, dy, rs = _correlate_sharded(
            mesh, pan1, mss_c, geom, dot_dtype, win, pan_params=pan1_params
        )
        coeff_x, coeff_y, n_valid = _fit_bands(
            geom.centers, dx, dy, rs, threshold
        )

        raw_dx, raw_dy, n_stt = _stt(pan1, pan2)
        dxs = jnp.clip(raw_dx, -(col_halo - 2.0), col_halo - 2.0)
        dys = jnp.clip(
            raw_dy, -(prestt_row_bound - 2.0), prestt_row_bound - 2.0
        )

        # --- remaps + concat: one shard_map with ppermute halos; RRC of
        # both PANs happens per shard inside it (inputs arrive padded to
        # the mesh; the pad rows are masked to border-0 post-RRC)
        loc_pan = lines_pan_pad // n_dev
        loc_mss = lines_mss_pad // n_dev

        def local(p1_l, p2_l, mss_l, p1par, p2par, cxs, cys, dxv, dyv):
            aligned_l = _align_local(
                mss_l, cxs, cys, loc_mss, chunk_rows, row_bound,
                col_block, col_halo,
            )
            p1c_l = rrc_apply(p1_l, p1par)
            p2c_l = rrc_apply(p2_l, p2par)
            if lines_pan_pad != lines_pan:
                # the zero-filled bottom pad rows must read border-0
                # post-RRC (they feed the last real shard's halo)
                g_rows = (
                    jax.lax.axis_index(LINE_AXIS) * loc_pan
                    + jnp.arange(loc_pan)
                )
                p2c_l = jnp.where(
                    (g_rows < lines_pan)[:, None], p2c_l, jnp.uint16(0)
                )
            phalo = prestt_row_bound + 2
            # halo exchange AFTER RRC: strip-end zeros stay the
            # resample's border value 0 (RRC(0) = bias otherwise)
            p2_padded = resample.pad_for_fast_remap(
                exchange_halo(p2c_l, phalo, phalo, LINE_AXIS),
                loc_pan, chunk_rows, prestt_row_bound,
            )
            prestt_l = resample._remap_const_over_padded(
                p2_padded, loc_pan, dxv, dyv, chunk_rows,
                prestt_row_bound, col_block, col_halo,
            )
            stitched_l = jnp.concatenate(
                [p1c_l[:, : width - fold], prestt_l[:, fold:]], axis=1
            )
            return aligned_l, stitched_l, prestt_l

        aligned, stitched, prestt = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(LINE_AXIS, None),
                P(LINE_AXIS, None),
                P(None, LINE_AXIS, None),
                P(), P(), P(), P(), P(), P(),
            ),
            out_specs=(
                P(LINE_AXIS, None, None),
                P(LINE_AXIS, None),
                P(LINE_AXIS, None),
            ),
            check_vma=False,
        )(pan1, pan2, mss_c, pan1_params, pan2_params, coeff_x, coeff_y,
          dxs, dys)
        # outputs stay at the padded length (uneven shardings are not
        # representable); drains trim to the real row counts
        params = (coeff_x, coeff_y, dxs, dys, raw_dx, raw_dy)
        if return_prestt:
            return aligned, stitched, prestt, n_valid, n_stt, params
        return aligned, stitched, n_valid, n_stt, params

    line2 = NamedSharding(mesh, P(LINE_AXIS, None))
    line3 = NamedSharding(mesh, P(None, LINE_AXIS, None))
    rep = NamedSharding(mesh, P())
    out_shardings = (
        NamedSharding(mesh, P(LINE_AXIS, None, None)),  # aligned
        line2,                                          # stitched
    )
    if return_prestt:
        out_shardings = out_shardings + (line2,)
    out_shardings = out_shardings + (rep, rep, (rep,) * 6)
    return jax.jit(
        pipeline,
        in_shardings=(line2, line2, line3, rep, rep, rep),
        out_shardings=out_shardings,
    )


@functools.lru_cache(maxsize=4)
def make_sharded_mss_align_fn(
    mesh: Mesh,
    lines_pan: int,
    width: int,
    slices: int = 10,
    n_sections: int | None = None,
    threshold: float = IBCV_DEF_THRESHOLD,
    chunk_rows: int = 512,
    row_bound: int = 6,
    col_block: int = 128,
    col_halo: int = 16,
    win: tuple[int, int] = (64, 64),
):
    """Sharded counterpart of ``models.device_pipeline.make_mss_align``:
    RRC + fast registration + alignment resample of a second MSS set
    against an already-corrected (line-sharded) PAN raster — the CMOS2
    half of the full sample-task workflow (``scene --mesh --mss2``).

    signature: (pan_c u16 (L_pad, W) line-sharded, mss u16
    (4, L_pad/4, W/4), mss_params) -> (aligned (L_pad/4, W/4, 4)
    line-sharded, n_valid (4,), (cx (4, 2), cy (4, 3)) replicated).
    Same padded-strip contract as :func:`make_sharded_scene_fn`
    (``lines_pan`` = real length).
    """
    n_dev = mesh.shape[LINE_AXIS]
    dot_dtype = backend.band_dot_dtype(
        backend.platform_of(mesh.devices.flat)
    )
    lines_mss = lines_pan // MSS_BANDS
    lines_mss_pad = pad_to(mesh, lines_mss)
    geom = _RegGeom.build(lines_pan, width, slices, n_sections)

    def align(pan_c, mss, mss_params):
        mss_c = jnp.stack(
            [rrc_apply(mss[b], mss_params[b]) for b in range(MSS_BANDS)]
        )
        if lines_mss_pad != lines_mss:
            rows_m = jnp.arange(lines_mss_pad)
            mss_c = jnp.where(
                (rows_m < lines_mss)[None, :, None], mss_c, jnp.uint16(0)
            )
        dx, dy, rs = _correlate_sharded(
            mesh, pan_c, mss_c, geom, dot_dtype, win
        )
        coeff_x, coeff_y, n_valid = _fit_bands(
            geom.centers, dx, dy, rs, threshold
        )
        loc_mss = lines_mss_pad // n_dev

        aligned = jax.shard_map(
            lambda mss_l, cxs, cys: _align_local(
                mss_l, cxs, cys, loc_mss, chunk_rows, row_bound,
                col_block, col_halo,
            ),
            mesh=mesh,
            in_specs=(P(None, LINE_AXIS, None), P(), P()),
            out_specs=P(LINE_AXIS, None, None),
            check_vma=False,
        )(mss_c, coeff_x, coeff_y)
        return aligned, n_valid, (coeff_x, coeff_y)

    line2 = NamedSharding(mesh, P(LINE_AXIS, None))
    line3 = NamedSharding(mesh, P(None, LINE_AXIS, None))
    rep = NamedSharding(mesh, P())
    return jax.jit(
        align,
        in_shardings=(line2, line3, rep),
        out_shardings=(
            NamedSharding(mesh, P(LINE_AXIS, None, None)), rep, (rep, rep)
        ),
    )
