"""Sharded (multi-chip) alignment: sequence parallelism over strip lines.

This is the framework's SPMD execution path.  The push-broom line axis is
sharded over a 1-D device mesh and the reference's serial pipeline
(preproc.h:224-468) maps onto it in three stages:

1. ``RRC + correlate`` — one jitted program over the mesh: elementwise RRC
   on the line-sharded strips, extraction of the reference's sections x
   slices sampling grid (CalcInterBandCorrelation geometry,
   preproc.h:245-259: ``min(lines, 16000)``-line windows evenly gapped
   along the strip), then the batched windowed phase correlations sharded
   over the *tile* axis (shard_map; each device runs the identical
   single-tile math the host path runs).
2. ``fit`` — the tiny (dx, dy, response) statistics return to the host and
   go through the same float64 filter + polynomial fit as the host
   ``PreProcessor`` (ops/polyfit.fit_shift_models_filtered: response
   threshold 0.4 per oipshared.h:35, >=5-valid-samples hard error per
   preproc.h:505-510) — so multi-chip coefficients match single-host
   coefficients exactly.
3. ``remap`` — a second jitted shard_map: the alignment resample with
   ppermute halo exchange between devices (the cross-device analogue of the
   reference's in-process 20000-line sections, preproc.h:374-408).

Sharded-mode semantics note: the resample sees true neighbour rows at shard
boundaries (plus border-0 at the strip ends), i.e. the *unsectioned* result.
The reference's per-section border artifacts (the ~2 cubic-support rows at
each 20000-line section seam that read BORDER_CONSTANT zeros,
preproc.h:428-457) are not reproduced here; the host-side
models/preprocessor.py parity path keeps full sectioned parity.  Everywhere
else the maths is identical (fast-mode remap: within 1 DN of parity).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import (
    CORRELATION_LINES,
    IBCV_DEF_SECTIONS,
    IBCV_DEF_SLICES,
    IBCV_DEF_THRESHOLD,
    IBCV_MIN_SLICES,
    MSS_BANDS,
)
from ..ops.rrc import rrc_apply
from .halo import exchange_halo
from .mesh import LINE_AXIS

# conservative static bound on |floor(G)| for the dynamic remap's vertical
# shifts; real band misregistrations are a few pixels
ROW_OFF_BOUND = 6


def pad_to(mesh: Mesh, rows: int) -> int:
    """Rows rounded up to the mesh size: line-sharded arrays must divide
    the mesh evenly (uneven NamedShardings are rejected), so strips of
    arbitrary length are zero-padded at the bottom on ingest, masked to
    border-0 post-RRC on device, and trimmed on drain."""
    n = mesh.shape[LINE_AXIS]
    return -(-rows // n) * n


def ingest_line_sharded(
    mesh: Mesh,
    view: np.ndarray,
    real_rows: int,
    rows_axis: int,
    pspec: P,
):
    """Shard-by-shard ingest of a host array view onto the line mesh,
    zero-filling the mesh-padding rows beyond ``real_rows``.  The
    callback is invoked once per device with that device's index window,
    so host RSS stays bounded by one shard."""
    shape = list(view.shape)
    shape[rows_axis] = pad_to(mesh, real_rows)

    def take(idx):
        sl = idx[rows_axis]
        a = sl.start or 0
        b = sl.stop if sl.stop is not None else shape[rows_axis]
        if b > real_rows:
            idx_real = list(idx)
            idx_real[rows_axis] = slice(min(a, real_rows), real_rows)
            part = np.ascontiguousarray(view[tuple(idx_real)])
            out_shape = list(part.shape)
            out_shape[rows_axis] = b - a
            out = np.zeros(out_shape, view.dtype)
            sel = [slice(None)] * len(out_shape)
            sel[rows_axis] = slice(0, part.shape[rows_axis])
            out[tuple(sel)] = part
            return out
        return np.ascontiguousarray(view[idx])

    return jax.make_array_from_callback(
        tuple(shape), NamedSharding(mesh, pspec), take
    )


def remap_band_dynamic(
    band_local: jax.Array,
    coeff_x: jax.Array,
    coeff_y: jax.Array,
    y0,
    axis_name: str | None = None,
):
    """Alignment remap of a local line-shard with traced coefficients.

    ``band_local``: (rows_local, W) uint16; ``y0``: absolute row of local
    row 0 (unused: the fast path's vertical offset is per-column).  When
    ``axis_name`` is given, halo rows come from the neighbouring shards via
    ppermute; otherwise zeros (single-shard strip).

    Fast-path maths (ops.resample.remap_band_fast): horizontal cubic as one
    matmul, vertical as per-column shifted MACs; within 1 DN of the
    parity remap.
    """
    del y0  # vertical offset is per-column in the fast path
    from ..ops.resample import (
        _col_interp_apply,
        _col_interp_matrix,
        _fast_row_pass,
    )

    f32 = jnp.float32
    rows, width = band_local.shape
    coeff_x = jnp.asarray(coeff_x, f32)
    coeff_y = jnp.asarray(coeff_y, f32)
    col_matrix = _col_interp_matrix(coeff_x, width)
    x = jnp.arange(width, dtype=f32)
    xx = x * jnp.float32(MSS_BANDS)
    g = (
        coeff_y[2] * xx * xx + coeff_y[1] * xx + coeff_y[0]
    ) / jnp.float32(MSS_BANDS)

    colg = _col_interp_apply(band_local.astype(f32), col_matrix)
    rb = ROW_OFF_BOUND
    halo_top = rb + 1
    halo_bottom = rb + 2
    if axis_name is not None:
        padded = exchange_halo(colg, halo_top, halo_bottom, axis_name)
    else:
        padded = jnp.pad(colg, ((halo_top, halo_bottom), (0, 0)))

    acc = _fast_row_pass(padded, g, rows, width, rb, halo_top)
    return jnp.clip(jnp.rint(acc), 0.0, 65535.0).astype(jnp.uint16)


# ---------------------------------------------------------------------------
# reference sampling geometry (CalcInterBandCorrelation, preproc.h:224-347)
# ---------------------------------------------------------------------------

def section_geometry(lines_pan: int, width: int, slices: int, sections: int):
    """The reference's sections x slices tile grid, verbatim
    (preproc.h:245-259): ``min(lines, 16000)``-line windows spaced by equal
    gaps along the strip, each cut into ``slices`` column slices; the MSS
    window offsets use the same integer-divided-by-4 bookkeeping.

    Returns (r0s, br0s, base_rows, band_rows, cols, band_cols, centers)
    where ``centers[t]`` is the slice-centre x of tile ``t`` (section-major,
    slice-minor ordering, matching the host PreProcessor's sample order).
    """
    if slices < IBCV_MIN_SLICES:
        raise ValueError(
            f"CalcInterBandCorrelation: at lease {IBCV_MIN_SLICES} slice "
            "needed"
        )
    if sections <= 0:
        raise ValueError(
            "CalcInterBandCorrelation: section count should be a positive "
            "integer"
        )
    if sections > 1 and sections * CORRELATION_LINES > lines_pan:
        raise ValueError(
            "CalcInterBandCorrelation: too many sections "
            f"({CORRELATION_LINES} lines per section), not enough total PAN "
            "data lines"
        )
    base_rows = min(lines_pan, CORRELATION_LINES)
    base_gap = (lines_pan - base_rows * sections) // (sections + 1)
    cols = width // slices
    band_rows = base_rows // MSS_BANDS
    band_gap = base_gap // MSS_BANDS
    band_cols = cols // MSS_BANDS
    r0s = [base_gap + sec * (base_rows + base_gap) for sec in range(sections)]
    br0s = [band_gap + sec * (band_rows + band_gap) for sec in range(sections)]
    centers = [
        i * cols + cols // 2 for _ in range(sections) for i in range(slices)
    ]
    return r0s, br0s, base_rows, band_rows, cols, band_cols, centers


def auto_sections(lines_pan: int) -> int:
    """Largest reference-legal section count <= the default 5."""
    return max(1, min(IBCV_DEF_SECTIONS, lines_pan // CORRELATION_LINES))


@functools.lru_cache(maxsize=8)
def _make_correlate_fn(
    mesh: Mesh,
    lines_pan: int,
    width: int,
    lines_mss: int,
    slices: int,
    sections: int,
    return_pan_c: bool = False,
):
    """Jitted over ``mesh``: RRC -> tile grid extraction -> tile-sharded
    batched phase correlation.  Returns (mss_c sharded, dx, dy, rs) with
    dx/dy/rs shaped (T, 4), T = sections*slices, tile-major then band —
    the host _correlate_tiles ordering.  With ``return_pan_c`` the
    line-sharded corrected PAN is appended (the --write-rrcpan drain)."""
    from ..ops.cv_exact import get_optimal_dft_size
    from ..ops.phasecorr import _phase_correlate_padded
    from ..ops.resample import upsample4_f32

    n_dev = mesh.shape[LINE_AXIS]
    r0s, br0s, base_rows, band_rows, cols, band_cols, _ = section_geometry(
        lines_pan, width, slices, sections
    )
    t_total = sections * slices
    t_pad = -(-t_total // n_dev) * n_dev
    pad_to = (get_optimal_dft_size(base_rows), get_optimal_dft_size(cols))

    def correlate(pan, mss, pan_params, mss_params):
        pan_c = rrc_apply(pan, pan_params)
        mss_c = jnp.stack(
            [rrc_apply(mss[b], mss_params[b]) for b in range(MSS_BANDS)]
        )

        pan_tiles = jnp.stack(
            [
                jax.lax.slice(
                    pan_c, (r0, i * cols), (r0 + base_rows, (i + 1) * cols)
                )
                for r0 in r0s
                for i in range(slices)
            ]
        )
        band_tiles = jnp.stack(
            [
                jnp.stack(
                    [
                        jax.lax.slice(
                            mss_c,
                            (b, br0, i * band_cols),
                            (b + 1, br0 + band_rows, (i + 1) * band_cols),
                        )[0]
                        for b in range(MSS_BANDS)
                    ]
                )
                for br0 in br0s
                for i in range(slices)
            ]
        )
        if t_pad != t_total:  # round the tile axis up to the device count
            def pad_tiles(t):
                reps = [t] * (t_pad // t_total) + [t[: t_pad % t_total]]
                return jnp.concatenate([r for r in reps if r.shape[0]])

            pan_tiles = pad_tiles(pan_tiles)
            band_tiles = pad_tiles(band_tiles)
        pan_tiles = jax.lax.with_sharding_constraint(
            pan_tiles, NamedSharding(mesh, P(LINE_AXIS, None, None))
        )
        band_tiles = jax.lax.with_sharding_constraint(
            band_tiles, NamedSharding(mesh, P(LINE_AXIS, None, None, None))
        )

        def corr_local(pt, bt):
            # per-device tile batch; per-tile math identical to the host
            # path (upsample4 + optimal-DFT-padded phase correlation)
            def one(args):
                p, bs = args
                pf = p.astype(jnp.float32)
                outs = [
                    _phase_correlate_padded(
                        pf,
                        upsample4_f32(bs[b].astype(jnp.float32)),
                        pad_to,
                    )
                    for b in range(MSS_BANDS)
                ]
                return tuple(
                    jnp.stack([o[k] for o in outs]) for k in range(3)
                )

            return jax.lax.map(one, (pt, bt))

        dx, dy, rs = jax.shard_map(
            corr_local,
            mesh=mesh,
            in_specs=(P(LINE_AXIS, None, None), P(LINE_AXIS, None, None, None)),
            out_specs=(P(LINE_AXIS, None),) * 3,
            check_vma=False,
        )(pan_tiles, band_tiles)
        outs = (mss_c, dx[:t_total], dy[:t_total], rs[:t_total])
        return outs + (pan_c,) if return_pan_c else outs

    in_shardings = (
        NamedSharding(mesh, P(LINE_AXIS, None)),
        NamedSharding(mesh, P(None, LINE_AXIS, None)),
        NamedSharding(mesh, P()),
        NamedSharding(mesh, P()),
    )
    out_shardings = (
        NamedSharding(mesh, P(None, LINE_AXIS, None)),
        NamedSharding(mesh, P()),
        NamedSharding(mesh, P()),
        NamedSharding(mesh, P()),
    )
    if return_pan_c:
        out_shardings = out_shardings + (
            NamedSharding(mesh, P(LINE_AXIS, None)),
        )
    return jax.jit(
        correlate, in_shardings=in_shardings, out_shardings=out_shardings
    )


@functools.lru_cache(maxsize=8)
def _make_plan_remap_fn(
    mesh: Mesh,
    col_shifts: tuple[int, ...],
    row_offsets: tuple[int, ...],
    halo_top: int,
    quantized: bool,
):
    """Jitted shard_map: 4-band *parity-grade* alignment resample from
    host-built RemapPlans (ops/resample._remap_section_math — the exact
    cv::remap reproduction incl. the float32 map-storage rounding and,
    with ``quantized``, the OpenCV <=4.x 1/32-px grid) with ppermute
    halos.  ``y0`` is the shard's absolute first row, so the float32
    ``y + G`` map value matches a whole-image (unsectioned) map build —
    the mesh route's documented semantics."""
    from ..ops.resample import _remap_section_math

    n_dev = mesh.shape[LINE_AXIS]
    halo_bottom = row_offsets[-1] + 2

    def remap(mss_c, wx, colsel, colvalid, g_hi, g_lo):
        rows = mss_c.shape[1]
        pad = (-rows) % n_dev
        if pad:
            mss_c = jnp.pad(mss_c, ((0, 0), (0, pad), (0, 0)))
        loc = (rows + pad) // n_dev

        def local(mss_l, wxl, csl, cvl, ghl, gll):
            y0 = jax.lax.axis_index(LINE_AXIS) * loc
            outs = []
            for b in range(MSS_BANDS):
                src_halo = exchange_halo(
                    mss_l[b].astype(jnp.float32), halo_top, halo_bottom,
                    LINE_AXIS,
                )
                outs.append(
                    _remap_section_math(
                        src_halo, y0, loc, wxl[b], csl[b], cvl[b],
                        ghl[b], gll[b],
                        col_shifts=col_shifts, row_offsets=row_offsets,
                        halo_top=halo_top, quantized=quantized,
                    )
                )
            return jnp.stack(outs, axis=-1)

        out = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(None, LINE_AXIS, None),) + (P(),) * 5,
            out_specs=P(LINE_AXIS, None, None),
            check_vma=False,
        )(mss_c, wx, colsel, colvalid, g_hi, g_lo)
        return out[:rows] if pad else out

    return jax.jit(remap)


def _plan_remap_sharded(mesh, mss_c, coeff_x, coeff_y, quantized: bool):
    """Run the parity-grade sharded remap: build per-band plans on the
    host (float64, like the host PreProcessor), union their static shift
    sets so one compiled kernel serves all 4 bands, and dispatch."""
    from ..ops import resample as rs

    band_px = mss_c.shape[2]
    plans = [
        rs.plan_for_band_alignment(
            coeff_x[b], coeff_y[b], band_px, quantized
        )
        for b in range(MSS_BANDS)
    ]
    col_shifts = tuple(
        range(
            min(p.col_shifts[0] for p in plans),
            max(p.col_shifts[-1] for p in plans) + 1,
        )
    )
    row_offsets = tuple(
        range(
            min(p.row_offsets[0] for p in plans),
            max(p.row_offsets[-1] for p in plans) + 1,
        )
    )
    halo_top = max(0, -(row_offsets[0] - 1))
    args = [rs._plan_device_args(p, col_shifts) for p in plans]
    stacked = [jnp.stack([a[k] for a in args]) for k in range(5)]
    fn = _make_plan_remap_fn(mesh, col_shifts, row_offsets, halo_top, quantized)
    return fn(mss_c, *stacked)


@functools.lru_cache(maxsize=8)
def _make_remap_fn(mesh: Mesh):
    """Jitted shard_map: 4-band alignment resample with ppermute halos.

    Line counts that don't divide the mesh are zero-padded at the strip
    bottom for the shard_map and trimmed after — the last real row's halo
    then reads zeros, which is exactly the border-0 the resample applies at
    strip ends anyway."""
    n_dev = mesh.shape[LINE_AXIS]

    def remap(mss_c, coeff_x, coeff_y):
        rows = mss_c.shape[1]
        pad = (-rows) % n_dev
        if pad:
            mss_c = jnp.pad(mss_c, ((0, 0), (0, pad), (0, 0)))

        def local(mss_l, cx, cy):
            return jnp.stack(
                [
                    remap_band_dynamic(mss_l[b], cx[b], cy[b], 0, LINE_AXIS)
                    for b in range(MSS_BANDS)
                ],
                axis=-1,
            )

        out = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(None, LINE_AXIS, None), P(), P()),
            out_specs=P(LINE_AXIS, None, None),
            check_vma=False,
        )(mss_c, coeff_x, coeff_y)
        return out[:rows] if pad else out

    return jax.jit(remap)


# ---------------------------------------------------------------------------
# multi-chip prestitch (CalcSttParameters + DoRRC + PreStitch,
# stitcher.h:83-201, SPMD over the line mesh)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _make_stt_correlate_fn(
    mesh: Mesh,
    lines_pan: int,
    width: int,
    sections: int,
    line_per_section: int,
    overlap_cols: int,
    edge_cols: int,
):
    """Jitted over ``mesh``: extract the reference's ``sections`` sampled
    overlap-strip windows (stitcher.h:151-176: PAN1's right ``overlap-edge``
    columns vs PAN2's left) from the line-sharded *uncorrected* strips (the
    reference correlates before RRC, main.cpp:280-284) and phase-correlate
    them sharded over the section axis.  Per-tile math identical to the
    host Stitcher (optimal-DFT padding)."""
    from ..ops.cv_exact import get_optimal_dft_size
    from ..ops.phasecorr import _phase_correlate_padded

    n_dev = mesh.shape[LINE_AXIS]
    gap = (lines_pan - sections * line_per_section) // (sections + 1)
    step_len = gap + line_per_section
    ow = overlap_cols - edge_cols
    pad_to = (get_optimal_dft_size(line_per_section), get_optimal_dft_size(ow))
    t_pad = -(-sections // n_dev) * n_dev

    def correlate(pan1, pan2):
        t1 = jnp.stack(
            [
                jax.lax.slice(
                    pan1,
                    (gap + i * step_len, width - overlap_cols),
                    (gap + i * step_len + line_per_section, width - edge_cols),
                )
                for i in range(sections)
            ]
        )
        t2 = jnp.stack(
            [
                jax.lax.slice(
                    pan2,
                    (gap + i * step_len, edge_cols),
                    (gap + i * step_len + line_per_section, overlap_cols),
                )
                for i in range(sections)
            ]
        )
        if t_pad != sections:
            def pad_tiles(t):
                parts = [t] * (t_pad // sections) + [t[: t_pad % sections]]
                return jnp.concatenate([p for p in parts if p.shape[0]])

            t1 = pad_tiles(t1)
            t2 = pad_tiles(t2)
        t1 = jax.lax.with_sharding_constraint(
            t1, NamedSharding(mesh, P(LINE_AXIS, None, None))
        )
        t2 = jax.lax.with_sharding_constraint(
            t2, NamedSharding(mesh, P(LINE_AXIS, None, None))
        )

        def corr_local(a, b):
            def one(args):
                return _phase_correlate_padded(
                    args[0].astype(jnp.float32),
                    args[1].astype(jnp.float32),
                    pad_to,
                )

            return jax.lax.map(one, (a, b))

        dx, dy, rs = jax.shard_map(
            corr_local,
            mesh=mesh,
            in_specs=(P(LINE_AXIS, None, None),) * 2,
            out_specs=(P(LINE_AXIS),) * 3,
            check_vma=False,
        )(t1, t2)
        return dx[:sections], dy[:sections], rs[:sections]

    in_shardings = (NamedSharding(mesh, P(LINE_AXIS, None)),) * 2
    out_shardings = (NamedSharding(mesh, P()),) * 3
    return jax.jit(
        correlate, in_shardings=in_shardings, out_shardings=out_shardings
    )


@functools.lru_cache(maxsize=8)
def _make_rrc_fn(mesh: Mesh):
    """Jitted sharded elementwise RRC of one strip (sharding-preserving)."""

    def apply(strip, params):
        return rrc_apply(strip, params)

    return jax.jit(
        apply,
        in_shardings=(
            NamedSharding(mesh, P(LINE_AXIS, None)),
            NamedSharding(mesh, P()),
        ),
        out_shardings=NamedSharding(mesh, P(LINE_AXIS, None)),
    )


@functools.lru_cache(maxsize=8)
def _make_prestt_remap_fn(mesh: Mesh, row_bound: int):
    """Jitted shard_map: constant-shift prestitch resample of one strip with
    ppermute halos (the SPMD analogue of SectionaryRemap's 30000-row
    streaming, imageop.h:230-275 — true neighbour rows at shard seams)."""
    n_dev = mesh.shape[LINE_AXIS]

    def remap(pan2_c, coeff_x, coeff_y):
        rows = pan2_c.shape[0]
        pad = (-rows) % n_dev
        if pad:
            pan2_c = jnp.pad(pan2_c, ((0, pad), (0, 0)))

        def local(p_l, cx, cy):
            return _remap_local_const(p_l, cx, cy, row_bound)

        out = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(LINE_AXIS, None), P(), P()),
            out_specs=P(LINE_AXIS, None),
            check_vma=False,
        )(pan2_c, coeff_x, coeff_y)
        return out[:rows] if pad else out

    return jax.jit(remap)


def _remap_local_const(p_l, coeff_x, coeff_y, row_bound: int):
    """Local-shard constant-shift remap (remap_band_dynamic with an explicit
    row bound so |dy| > ROW_OFF_BOUND mounting offsets stay supported)."""
    from ..ops.resample import (
        _col_interp_apply,
        _col_interp_matrix,
        _fast_row_pass,
    )

    f32 = jnp.float32
    rows, width = p_l.shape
    col_matrix = _col_interp_matrix(jnp.asarray(coeff_x, f32), width)
    cy = jnp.asarray(coeff_y, f32)
    x = jnp.arange(width, dtype=f32)
    xx = x * f32(MSS_BANDS)
    g = (cy[2] * xx * xx + cy[1] * xx + cy[0]) / f32(MSS_BANDS)
    colg = _col_interp_apply(p_l.astype(f32), col_matrix)
    halo_top = row_bound + 1
    padded = exchange_halo(colg, halo_top, row_bound + 2, LINE_AXIS)
    acc = _fast_row_pass(padded, g, rows, width, row_bound, halo_top)
    return jnp.clip(jnp.rint(acc), 0.0, 65535.0).astype(jnp.uint16)


def make_prestitch_step(
    mesh: Mesh,
    sections: int,
    line_per_section: int,
    overlap_cols: int,
    edge_cols: int = 0,
):
    """Build the multi-chip prestitch pieces over ``mesh`` (axis 'line').

    Returns (correlate, rrc, remap):
      correlate(pan1 u16, pan2 u16) -> (dx, dy, rs) per section — run on the
        *uncorrected* strips (reference order, main.cpp:280-284), filter on
        the host with models.stitcher.average_valid_deltas;
      rrc(strip, params) -> corrected strip (line-sharded in and out);
      remap(pan2_c, delta_x, delta_y) -> prestitched strip — pass the
        averaged deltas as the constant-shift coefficients
        (cX = [4*dx, 0], cY = [4*dy, 0, 0], the alignment-polynomial
        encoding of mapx = x + dx / mapy = y + dy).
    """
    def correlate(pan1, pan2, real_lines: int | None = None):
        # real_lines: the strip's true length when inputs arrive padded
        # to the mesh size (window geometry must use the real length)
        lines_pan, width = pan1.shape
        fn = _make_stt_correlate_fn(
            mesh, real_lines or lines_pan, width, sections,
            line_per_section, overlap_cols, edge_cols,
        )
        return fn(pan1, pan2)

    rrc_fn = _make_rrc_fn(mesh)

    def remap(pan2_c, delta_x: float, delta_y: float):
        import math

        row_bound = max(
            ROW_OFF_BOUND, int(math.ceil(abs(float(delta_y)))) + 1
        )
        fn = _make_prestt_remap_fn(mesh, row_bound)
        cx = jnp.asarray([4.0 * float(delta_x), 0.0], jnp.float32)
        cy = jnp.asarray(
            [4.0 * float(delta_y), 0.0, 0.0], jnp.float32
        )
        return fn(pan2_c, cx, cy)

    return correlate, rrc_fn, remap


def make_align_step(
    mesh: Mesh,
    slices: int = IBCV_DEF_SLICES,
    sections: int | None = None,
    threshold: float = IBCV_DEF_THRESHOLD,
    quantized: bool = False,
    want_pan_c: bool = False,
):
    """Build the multi-chip align step over ``mesh`` (axis 'line').

    Step signature: (pan u16 (L_pan, W_pan), mss u16 (4, L_mss, W_band),
    rrc_pan params (6, W_pan), rrc_mss params (4, 6, W_band)) ->
    (aligned u16 (L_mss, W_band, 4) line-sharded, coeff_x (4, 2) f64,
    coeff_y (4, 3) f64).

    The step composes two jitted SPMD programs around the host float64 fit
    (the reference's own data flow: only the tiny shift table crosses to
    the host, preproc.h:492-550).  Raises the reference's "Not enough valid
    correlation values" error when a band has <5 samples at response >=
    ``threshold`` (0.4, oipshared.h:35).

    ``line_offset``: first MSS line to align (the CLI's --line-offset;
    correlation always samples the full strip, like the host path).

    ``quantized`` routes the resample through the parity-grade plan-based
    kernel on the OpenCV <=4.x 1/32-px grid (whole-image map semantics);
    ``want_pan_c`` appends the line-sharded corrected PAN to the step
    outputs (the --write-rrcpan drain).
    """
    from ..ops import polyfit

    def step(
        pan, mss, pan_params, mss_params, line_offset: int = 0,
        real_lines_pan: int | None = None,
    ):
        """``real_lines_pan``: the strip's true length when the inputs
        arrive zero-padded to the mesh size (line-sharded arrays must
        divide the mesh evenly); sampling geometry uses the real length
        and the pad rows are masked to border-0 post-RRC."""
        lines_pan, width = pan.shape
        lines_mss = mss.shape[1]
        real_pan = real_lines_pan or lines_pan
        real_mss = real_pan // MSS_BANDS
        nsec = sections if sections is not None else auto_sections(real_pan)
        *_, centers = section_geometry(real_pan, width, slices, nsec)

        correlate = _make_correlate_fn(
            mesh, real_pan, width, lines_mss, slices, nsec, want_pan_c,
        )
        outs = correlate(pan, mss, pan_params, mss_params)
        mss_c, dx, dy, rs = outs[:4]
        pan_c = outs[4] if want_pan_c else None
        if real_mss != lines_mss:
            # mesh-padding rows must read border-0 in the resample's
            # halo (RRC of the zero fill is the bias, not 0)
            rows_m = jnp.arange(lines_mss)
            mss_c = jnp.where(
                (rows_m < real_mss)[None, :, None], mss_c, jnp.uint16(0)
            )

        dx = np.asarray(dx, np.float64)      # (T, 4)
        dy = np.asarray(dy, np.float64)
        rs = np.asarray(rs, np.float64)
        cx = np.asarray(centers, np.float64)
        coeff_x = np.zeros((MSS_BANDS, 2))
        coeff_y = np.zeros((MSS_BANDS, 3))
        for b in range(MSS_BANDS):
            coeff_x[b], coeff_y[b] = polyfit.fit_shift_models_filtered(
                cx, dx[:, b], dy[:, b], rs[:, b], threshold, b + 1
            )

        src = mss_c[:, line_offset:] if line_offset else mss_c
        if quantized:
            aligned = _plan_remap_sharded(mesh, src, coeff_x, coeff_y, True)
        else:
            remap = _make_remap_fn(mesh)
            aligned = remap(
                src,
                jnp.asarray(coeff_x, jnp.float32),
                jnp.asarray(coeff_y, jnp.float32),
            )
        if want_pan_c:
            return aligned, coeff_x, coeff_y, pan_c
        return aligned, coeff_x, coeff_y

    return step
