"""Geometric resampling kernels: cubic upsample and polynomial-shift remap.

Three reference call sites are served here, all INTER_CUBIC (A = -0.75):

* ``upsample4_f32`` — the 4x MSS->PAN-scale upsample before phase
  correlation (``cv::resize``, preproc.h:302-307).  Exact separable
  convolution with the 4 fixed fractional phases of a x4 scale; pure XLA
  (static shifts + weighted adds), no gathers.
* ``remap_polynomial_u16`` — the per-band alignment resample
  (``cv::remap`` with maps built from the fitted shift polynomials,
  preproc.h:440-457): ``mapx(x) = (cX1*xx + cX0 + xx)/4`` (column-only) and
  ``mapy(y,x) = float32(y + G(x))``, ``G(x) = (cY2*xx^2 + cY1*xx + cY0)/4``,
  xx = 4x.
* ``remap_constant_shift_u16`` — the pre-stitch whole-image translation
  (stitcher.h:92-100): the same kernel with degenerate per-column arrays.

Structure: the maps are never materialised as (H, W) float arrays (the
reference's hot loop #2, preproc.h:443-450).  Because mapx depends only on
the column and mapy is y + G(x), the 4x4 cubic gather decomposes into a
small *static* set of column shifts and row shifts, selected per pixel by
comparison masks — elementwise multiply-adds, no gathers, no dynamic
shapes.  The shift ranges are computed on the host
from the fitted polynomials and specialise the compiled kernel.

Parity: the parity path reproduces ops/cv_exact.remap_cubic_u16_exact
(same float32 weight expressions, same interior accumulation order, border
value 0) in either coordinate convention (``quantized_coords=True`` =
OpenCV <= 4.x 1/32-px grid, False = OpenCV 5.x continuous); within 1 DN on
backends whose codegen fuses multiply-adds (XLA:CPU, XLA:GPU).  The fast
path (remap_band_fast*) additionally trades the float32 map-storage
rounding and the elementwise accumulation order for blocked matmuls —
within 1 DN of the parity path on imagery.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import MSS_BANDS

# ---------------------------------------------------------------------------
# 4x cubic upsample (exact cv::resize float path at scale 1/4)
# ---------------------------------------------------------------------------

def _phase_weights_x4() -> np.ndarray:
    """Weights for the 4 output phases of a x4 cubic upsample.

    Output x = 4k + r maps to source coordinate (x+0.5)/4 - 0.5; phases
    r in {0,1} have first tap at k-2 with fractions {0.625, 0.875}, phases
    r in {2,3} first tap k-1 with fractions {0.125, 0.375}.
    """
    from .cv_exact import interpolate_cubic_f32

    fr = np.array([0.625, 0.875, 0.125, 0.375], dtype=np.float32)
    return interpolate_cubic_f32(fr)  # (4 phases, 4 taps)


_X4_W = _phase_weights_x4()
_X4_BASE = (-2, -2, -1, -1)  # first-tap offset per phase


def shifted_clipped(x: jax.Array, axis: int, off: int) -> jax.Array:
    """``x`` indexed at clip(arange(n)+off, 0, n-1) along ``axis`` — i.e. a
    shift with replicate-clamped edges — built from static slices + edge
    repeats (never a gather)."""
    n = x.shape[axis]
    if off == 0:
        return x
    ax = axis % x.ndim

    def take_rng(a, b):
        idx = [slice(None)] * x.ndim
        idx[ax] = slice(a, b)
        return x[tuple(idx)]

    if off > 0:
        off = min(off, n - 1)
        body = take_rng(off, n)
        edge = take_rng(n - 1, n)
        reps = [1] * x.ndim
        reps[ax] = off
        return jnp.concatenate([body, jnp.tile(edge, reps)], axis=ax)
    off = max(off, -(n - 1))
    body = take_rng(0, n + off)
    edge = take_rng(0, 1)
    reps = [1] * x.ndim
    reps[ax] = -off
    return jnp.concatenate([jnp.tile(edge, reps), body], axis=ax)


def _upsample4_axis(x: jax.Array, axis: int) -> jax.Array:
    """Upsample one axis by 4 with exact cv::resize cubic semantics
    (replicate-clamped taps, grouped accumulation order)."""
    n = x.shape[axis]
    w = _X4_W

    def take(idx0: int):
        # source tap index for output phase group: clip(arange(n)+idx0);
        # realised as slices+edge repeats (no gathers)
        return shifted_clipped(x, axis, idx0)

    wr = jnp.asarray(w, x.dtype)
    phases = []
    for r in range(4):
        b0 = _X4_BASE[r]
        g0, g1, g2, g3 = take(b0), take(b0 + 1), take(b0 + 2), take(b0 + 3)
        t = (
            (g0 * wr[r, 0] + g1 * wr[r, 1]) + g2 * wr[r, 2]
        ) + g3 * wr[r, 3]
        phases.append(t)
    ax = axis % x.ndim
    stacked = jnp.stack(phases, axis=ax + 1)  # (..., n, 4, ...)
    newshape = list(x.shape)
    newshape[ax] = n * 4
    return stacked.reshape(newshape)


@jax.jit
def upsample4_f32(x: jax.Array) -> jax.Array:
    """cv::resize(src, 4x, INTER_CUBIC) float32 path, exact.

    Horizontal pass then vertical pass (OpenCV's hresize/vresize order).
    Works on (..., H, W); returns (..., 4H, 4W).
    """
    x = x.astype(jnp.float32)
    x = _upsample4_axis(x, axis=x.ndim - 1)
    x = _upsample4_axis(x, axis=x.ndim - 2)
    return x


def _resize_axis_generic(x: jax.Array, axis: int, dn: int) -> jax.Array:
    """General cv::resize INTER_CUBIC along one axis (float path):
    per-output-index taps/weights precomputed on host, replicate-clamped."""
    from .cv_exact import interpolate_cubic_f32

    sn = x.shape[axis]
    scale = sn / dn
    dxs = np.arange(dn, dtype=np.float64)
    fxx = (dxs + 0.5) * scale - 0.5
    sx = np.floor(fxx).astype(np.int64)
    fx = (fxx - sx).astype(np.float32)
    w = interpolate_cubic_f32(fx)  # (dn, 4)
    taps = np.clip(sx[:, None] + np.arange(-1, 3)[None, :], 0, sn - 1)

    shape = [1] * x.ndim
    shape[axis % x.ndim] = dn

    def take(j):
        return jnp.take(x, jnp.asarray(taps[:, j]), axis=axis)

    def wj(j):
        return jnp.asarray(w[:, j]).reshape(shape)

    return (
        (take(0) * wj(0) + take(1) * wj(1)) + take(2) * wj(2)
    ) + take(3) * wj(3)


@functools.partial(jax.jit, static_argnames=("dst_h", "dst_w"))
def resize_cubic_f32(x: jax.Array, dst_h: int, dst_w: int) -> jax.Array:
    """General cv::resize(src, (dst_w, dst_h), INTER_CUBIC) float path,
    horizontal then vertical (matches ops/cv_exact.resize_cubic_f32_exact)."""
    x = x.astype(jnp.float32)
    x = _resize_axis_generic(x, x.ndim - 1, dst_w)
    x = _resize_axis_generic(x, x.ndim - 2, dst_h)
    return x


# ---------------------------------------------------------------------------
# Polynomial remap — host-side plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RemapPlan:
    """Per-column map data + static shift ranges for the remap kernel.

    Built on the host in float64 exactly as the reference builds its maps
    (preproc.h:443-450); the float32 castings below reproduce the
    reference's float-typed map arrays.
    """

    width: int
    col_tap0: np.ndarray      # (W,) int32 first column tap index (may be <0)
    wx: np.ndarray            # (4, W) float32 column weights
    g_hi: np.ndarray          # (W,) float32 high part of G(x)
    g_lo: np.ndarray          # (W,) float32 residual of G(x)
    col_shifts: tuple[int, ...]   # static range of col_tap0[x] - x
    row_offsets: tuple[int, ...]  # static range of floor(mapy(y,x)) - y
    quantized: bool

    @property
    def halo_top(self) -> int:
        """Rows of context needed above an output row (tap a=0 at offset
        row_offsets[0] - 1)."""
        return max(0, -(self.row_offsets[0] - 1))

    @property
    def halo_bottom(self) -> int:
        return max(0, self.row_offsets[-1] + 2)


def build_remap_plan(
    mapx_cols: np.ndarray,
    g: np.ndarray,
    quantized_coords: bool = False,
) -> RemapPlan:
    """Build a plan from per-column map data.

    ``mapx_cols``: (W,) float64 mapx value per column (row-independent);
    ``g``: (W,) float64 with mapy(y, x) = float32(y + g[x]).
    """
    from .cv_exact import interpolate_cubic_f32

    mapx_cols = np.asarray(mapx_cols, np.float64)
    g = np.asarray(g, np.float64)
    w = mapx_cols.shape[0]
    mx32 = mapx_cols.astype(np.float32)

    if quantized_coords:
        sx = np.rint(mx32 * np.float32(32.0)).astype(np.int64)
        ix = np.clip(sx >> 5, -32768, 32767).astype(np.int32)
        fx = ((sx & 31).astype(np.float32)) * np.float32(1.0 / 32.0)
    else:
        ix = np.floor(mx32).astype(np.int32)
        fx = (mx32 - ix).astype(np.float32)
    wx = interpolate_cubic_f32(fx).T.astype(np.float32)  # (4, W)
    col_tap0 = (ix - 1).astype(np.int32)

    g_hi = g.astype(np.float32)
    g_lo = (g - g_hi.astype(np.float64)).astype(np.float32)

    d = col_tap0 - np.arange(w, dtype=np.int32)
    col_shifts = tuple(range(int(d.min()), int(d.max()) + 1))
    r_lo = int(np.floor(g.min())) - 1
    r_hi = int(np.floor(g.max())) + 1
    if quantized_coords:
        r_hi += 1  # 1/32 rounding can carry across the next integer
    row_offsets = tuple(range(r_lo, r_hi + 1))
    return RemapPlan(
        width=w,
        col_tap0=col_tap0,
        wx=wx,
        g_hi=g_hi,
        g_lo=g_lo,
        col_shifts=col_shifts,
        row_offsets=row_offsets,
        quantized=quantized_coords,
    )


def plan_for_band_alignment(
    coeff_x, coeff_y, width: int, quantized_coords: bool = False
) -> RemapPlan:
    """Alignment maps from the fitted shift polynomials (preproc.h:443-450):
    mapx = (cX1*xx + cX0 + xx)/B, G = (cY2*xx^2 + cY1*xx + cY0)/B, xx = B*x,
    B = MSS_BANDS."""
    x = np.arange(width, dtype=np.float64)
    xx = x * MSS_BANDS
    mapx = (float(coeff_x[1]) * xx + float(coeff_x[0]) + xx) / MSS_BANDS
    g = (
        float(coeff_y[2]) * xx * xx + float(coeff_y[1]) * xx + float(coeff_y[0])
    ) / MSS_BANDS
    return build_remap_plan(mapx, g, quantized_coords)


def plan_for_constant_shift(
    dx: float, dy: float, width: int, quantized_coords: bool = False
) -> RemapPlan:
    """Pre-stitch translation maps (stitcher.h:93-99): mapx = x + dx,
    mapy = y + dy, computed in double and stored as float32 like the
    reference's map fill."""
    x = np.arange(width, dtype=np.float64) + float(dx)
    return build_remap_plan(x, np.full(width, float(dy), np.float64), quantized_coords)


# ---------------------------------------------------------------------------
# Polynomial remap — device math (pure XLA; jit/shard_map friendly)
# ---------------------------------------------------------------------------

def _cubic_weights_f32(t):
    """In-kernel float32 cubic weights, same expression order as the oracle
    (cv_exact.interpolate_cubic_f32) for bit parity."""
    f32 = jnp.float32
    A = f32(-0.75)
    one, two, three, four, five, eight = (f32(c) for c in (1, 2, 3, 4, 5, 8))
    tp1 = t + one
    w0 = ((A * tp1 - five * A) * tp1 + eight * A) * tp1 - four * A
    w1 = ((A + two) * t - (A + three)) * t * t + one
    omt = one - t
    w2 = ((A + two) * omt - (A + three)) * omt * omt + one
    w3 = one - w0 - w1 - w2
    return w0, w1, w2, w3


def _remap_section_math(
    src_halo: jax.Array,     # (TR + halo_top + halo_bottom, W) f32, zero-padded
    y0: jax.Array | int,     # absolute row index of output row 0
    tr: int,                 # output rows
    wx: jax.Array,           # (4, W) f32
    colsel: jax.Array,       # (S_col, W) f32 one-hot of col shift per column
    colvalid: jax.Array,     # (4, S_col, W) f32: tap-in-image masks
    g_hi: jax.Array,         # (W,) f32
    g_lo: jax.Array,         # (W,) f32
    *,
    col_shifts: tuple[int, ...],
    row_offsets: tuple[int, ...],
    halo_top: int,
    quantized: bool,
):
    """Remap ``tr`` output rows.  ``src_halo`` row k holds source row
    ``y0 - halo_top + k`` (zeros outside the section)."""
    f32 = jnp.float32
    width = src_halo.shape[1]
    halo_rows = src_halo.shape[0]

    # --- column gather: colg[b][k, x] = src_halo[k, x + d[x] + b - 1] or 0
    colg = []
    for b in range(4):
        acc = jnp.zeros_like(src_halo)
        for s_idx, s in enumerate(col_shifts):
            shift = s + b          # tap index = x + (col_tap0[x]-x) + b
            rolled = jnp.roll(src_halo, -shift, axis=1)
            sel = colsel[s_idx] * colvalid[b, s_idx]
            acc = acc + rolled * sel[None, :]
        colg.append(acc)

    # --- vertical coordinate v = float32(y + G(x)), double-compensated so it
    # matches the reference's float((double)y + G64) map fill to the last ulp
    y_abs = (
        jnp.arange(tr, dtype=jnp.int32)[:, None]
        + jnp.asarray(y0, jnp.int32)
    )
    a = y_abs.astype(f32)
    bhi = g_hi[None, :]
    s_ = a + bhi
    bb = s_ - a
    err = (a - (s_ - bb)) + (bhi - bb)
    v = s_ + (err + g_lo[None, :])

    if quantized:
        sq = jnp.rint(v * f32(32.0)).astype(jnp.int32)
        iy = jnp.clip(jnp.right_shift(sq, 5), -32768, 32767)
        fy = (sq & 31).astype(f32) * f32(1.0 / 32.0)
    else:
        ivf = jnp.floor(v)
        iy = ivf.astype(jnp.int32)
        fy = v - ivf
    r_off = iy - y_abs
    wys = _cubic_weights_f32(fy)

    wxb = [wx[b][None, :] for b in range(4)]

    # --- row gather + 4x4 accumulation, factored by static row offset t
    acc = jnp.zeros((tr, width), dtype=f32)
    for t in row_offsets:
        inner = jnp.zeros((tr, width), dtype=f32)
        for ai in range(4):
            base = halo_top + t - 1 + ai
            r0 = jax.lax.dynamic_slice_in_dim(colg[0], base, tr, 0) * (
                wys[ai] * wxb[0]
            )
            r1 = jax.lax.dynamic_slice_in_dim(colg[1], base, tr, 0) * (
                wys[ai] * wxb[1]
            )
            r2 = jax.lax.dynamic_slice_in_dim(colg[2], base, tr, 0) * (
                wys[ai] * wxb[2]
            )
            r3 = jax.lax.dynamic_slice_in_dim(colg[3], base, tr, 0) * (
                wys[ai] * wxb[3]
            )
            inner = inner + (((r0 + r1) + r2) + r3)
        acc = acc + inner * (r_off == t).astype(f32)

    out = jnp.clip(jnp.rint(acc), 0.0, 65535.0).astype(jnp.uint16)
    return out


def _plan_device_args(plan: RemapPlan, col_shifts: tuple[int, ...] | None = None):
    """Device-side constant arrays derived from a plan.

    ``col_shifts`` may be a superset of the plan's own shift range (the
    sharded multi-band remap unions the per-band sets so one compiled
    kernel serves all bands); absent shifts select nothing."""
    if col_shifts is None:
        col_shifts = plan.col_shifts
    w = plan.width
    d = plan.col_tap0 - np.arange(w, dtype=np.int32)
    s_arr = np.asarray(col_shifts, np.int32)
    colsel = (d[None, :] == s_arr[:, None]).astype(np.float32)  # (S, W)
    # tap-in-image masks: tap index x + d + b - 1 in [0, W)
    xs = np.arange(w, dtype=np.int64)
    colvalid = np.zeros((4, len(col_shifts), w), np.float32)
    for b in range(4):
        for si, s in enumerate(col_shifts):
            tap = xs + s + b
            colvalid[b, si] = ((tap >= 0) & (tap < w)).astype(np.float32)
    return (
        jnp.asarray(plan.wx),
        jnp.asarray(colsel),
        jnp.asarray(colvalid),
        jnp.asarray(plan.g_hi),
        jnp.asarray(plan.g_lo),
    )


@functools.partial(
    jax.jit,
    static_argnames=("col_shifts", "row_offsets", "halo_top", "quantized"),
)
def _remap_section_jit(
    src, wx, colsel, colvalid, g_hi, g_lo,
    *, col_shifts, row_offsets, halo_top, quantized,
):
    rows = src.shape[0]
    halo_bottom = row_offsets[-1] + 2
    pad_top = max(0, halo_top)
    pad_bot = max(0, halo_bottom)
    srcf = src.astype(jnp.float32)
    src_halo = jnp.pad(srcf, ((pad_top, pad_bot), (0, 0)))
    return _remap_section_math(
        src_halo,
        0,
        rows,
        wx,
        colsel,
        colvalid,
        g_hi,
        g_lo,
        col_shifts=col_shifts,
        row_offsets=row_offsets,
        halo_top=pad_top,
        quantized=quantized,
    )


def remap_section_u16(src: jax.Array, plan: RemapPlan) -> jax.Array:
    """Remap a full section (rows, W) uint16 -> (rows, W) uint16.

    Exactly reproduces cv::remap(src_section, mapx, mapy, INTER_CUBIC,
    BORDER_CONSTANT) with the reference's section-local maps: rows outside
    the section read as the border value 0 (the reference's section overlap
    trimming hides those rows, preproc.h:392-407).
    """
    args = _plan_device_args(plan)
    return _remap_section_jit(
        src,
        *args,
        col_shifts=plan.col_shifts,
        row_offsets=plan.row_offsets,
        halo_top=plan.halo_top,
        quantized=plan.quantized,
    )


# ---------------------------------------------------------------------------
# Fast remap: column cubic as one blocked matmul, rows as shifted MACs
# ---------------------------------------------------------------------------

ROW_OFF_BOUND_FAST = 6   # static |floor(G)| bound for the fast path


COL_BLOCK = 512      # columns per block
COL_HALO = 32        # max |mapx - x| the blocked matmul supports


def _col_interp_matrix(coeff_x, width: int, block: int | None = None,
                       halo: int | None = None):
    """Blocked column-interpolation matrices.

    The horizontal 4-tap cubic at column x reads taps around
    ``mapx(x) = x + dx(x)`` with small |dx|; a dense (W, W) selection matrix
    would waste W/4 of the matmul work, so columns are processed in
    ``block``-wide blocks against (block + 2*halo, block) banded matrices:
    ``out[:, blk] = src[:, blk +- halo] @ M_blk``.

    Returns (n_blocks, block + 2*halo, block) float32; shifts beyond
    ``halo`` fall outside the band and produce border zeros.  Built in-graph
    from traced coefficients.  Defaults (COL_BLOCK/COL_HALO) support
    |dx| <= 32; the device pipeline narrows the band (128/16), which needs
    ~30% fewer multiply-adds.
    """
    f32 = jnp.float32
    if block is None:
        block = COL_BLOCK
    if halo is None:
        halo = COL_HALO
    block = min(block, width)
    if width % block:
        # fall back to the largest divisor of the width (camera widths
        # 12288/3072 divide all standard blocks; test/exotic widths don't)
        block = next(
            b for b in range(block, 0, -1) if width % b == 0
        )
    n_blocks = width // block
    x = jnp.arange(width, dtype=f32)
    xx = x * f32(MSS_BANDS)
    mapx = (coeff_x[1] * xx + coeff_x[0] + xx) / f32(MSS_BANDS)
    ix = jnp.floor(mapx).astype(jnp.int32)
    fx = mapx - ix.astype(f32)
    w0, w1, w2, w3 = _cubic_weights_f32(fx)
    tap0 = ix - 1

    # per block: local tap index = tap0 - (block_start - halo)
    blk_start = (jnp.arange(n_blocks, dtype=jnp.int32) * block)[:, None]
    tap_loc = tap0.reshape(n_blocks, block) - (blk_start - halo)
    # absolute-tap validity (border 0 outside the image)
    tap_abs = tap0.reshape(n_blocks, block)
    j = jnp.arange(block + 2 * halo, dtype=jnp.int32)[None, :, None]
    m = jnp.zeros((n_blocks, block + 2 * halo, block), f32)
    for b, wb in enumerate((w0, w1, w2, w3)):
        ok = ((tap_abs + b) >= 0) & ((tap_abs + b) < width)
        sel = (j == (tap_loc + b)[:, None, :]) & ok[:, None, :]
        m = m + sel.astype(f32) * wb.reshape(n_blocks, 1, block)
    return m


def _col_interp_apply(src_f32: jax.Array, col_matrix: jax.Array) -> jax.Array:
    """Apply blocked column interpolation: (R, W) x (nB, B+2H, B) -> (R, W)."""
    rows, width = src_f32.shape
    n_blocks, bh, block = (
        col_matrix.shape[0], col_matrix.shape[1], col_matrix.shape[2]
    )
    halo = (bh - block) // 2
    padded = jnp.pad(src_f32, ((0, 0), (halo, halo)))
    blocks = jnp.stack(
        [
            jax.lax.dynamic_slice_in_dim(
                padded, i * block, block + 2 * halo, axis=1
            )
            for i in range(n_blocks)
        ]
    )  # (nB, R, B+2H)
    out = jnp.einsum(
        "nrb,nbc->nrc", blocks, col_matrix,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.moveaxis(out, 0, 1).reshape(rows, width)


def remap_band_fast(
    src: jax.Array,
    coeff_x,
    coeff_y,
    row_bound: int = ROW_OFF_BOUND_FAST,
    g_override: jax.Array | None = None,
    col_matrix: jax.Array | None = None,
    col_block: int | None = None,
    col_halo: int | None = None,
) -> jax.Array:
    """Fast alignment remap of a (rows, W) uint16 band.

    Same maps as :func:`remap_polynomial_u16` with two fast-path
    simplifications (each <= 1 DN vs the parity path, see tests):
    the vertical coordinate is the ideal ``y + G(x)`` (per-column constant
    offset/fraction, skipping the reference's float32 map-storage rounding at
    large y), and the horizontal 4-tap sum runs as a matmul
    (highest-precision f32) instead of the oracle's grouped order.
    Works with traced coefficients; ``row_bound`` statically bounds |G|.
    """
    f32 = jnp.float32
    rows, width = src.shape
    coeff_x = jnp.asarray(coeff_x, f32)
    coeff_y = jnp.asarray(coeff_y, f32)

    if col_matrix is None:
        col_matrix = _col_interp_matrix(coeff_x, width, col_block, col_halo)
    if g_override is None:
        x = jnp.arange(width, dtype=f32)
        xx = x * f32(MSS_BANDS)
        g = (coeff_y[2] * xx * xx + coeff_y[1] * xx + coeff_y[0]) / f32(
            MSS_BANDS
        )
    else:
        g = g_override
    colg = _col_interp_apply(src.astype(f32), col_matrix)
    halo_top = row_bound + 1
    padded = jnp.pad(colg, ((halo_top, row_bound + 2), (0, 0)))
    acc = _fast_row_pass(padded, g, rows, width, row_bound, halo_top)
    return jnp.clip(jnp.rint(acc), 0.0, 65535.0).astype(jnp.uint16)


def _fast_row_pass(
    padded: jax.Array,
    g: jax.Array,
    rows: int,
    width: int,
    row_bound: int,
    halo_top: int,
) -> jax.Array:
    """Vertical cubic as per-column shifted MACs on a row-padded column-
    interpolated buffer: out[y, x] = sum_u coeff_u[x] * padded[y + ht + u, x]
    with coeff_u[x] = sum_a wys[a][x] * [floor(G[x]) + a - 1 == u]."""
    f32 = jnp.float32
    iy0 = jnp.floor(g).astype(jnp.int32)       # per-column row offset
    fy = g - iy0.astype(f32)
    wys = _cubic_weights_f32(fy)               # 4 x (W,)
    acc = jnp.zeros((rows, width), f32)
    for u in range(-row_bound - 1, row_bound + 3):
        cu = jnp.zeros((width,), f32)
        for a in range(4):
            cu = cu + jnp.where(iy0 + a - 1 == u, wys[a], f32(0))
        rows_u = jax.lax.dynamic_slice_in_dim(
            padded, halo_top + u, rows, axis=0
        )
        acc = acc + rows_u * cu[None, :]
    return acc


def _band_g(coeff_y, width: int):
    """Per-column vertical offset G(x) from the fitted dy polynomial."""
    f32 = jnp.float32
    x = jnp.arange(width, dtype=f32)
    xx = x * f32(MSS_BANDS)
    cy = jnp.asarray(coeff_y, f32)
    return (cy[2] * xx * xx + cy[1] * xx + cy[0]) / f32(MSS_BANDS)


def _remap_fast_over_padded(
    padded: jax.Array,
    rows: int,
    coeff_x,
    coeff_y,
    chunk_rows: int,
    row_bound: int,
    col_matrix: jax.Array,
    g: jax.Array,
) -> jax.Array:
    """Chunked fast remap over a row-padded source buffer.

    ``padded`` holds ``halo = row_bound + 2`` context rows above the first
    output row and at least ``halo`` below the last (shape
    ``(ceil(rows/chunk)*chunk + 2*halo, W)``; trailing filler rows feed
    only discarded outputs).  Callers choose the context: zeros for the
    strip/section border (single-device path) or true neighbour rows from
    a ppermute halo exchange (the sharded scene pipeline)."""
    width = padded.shape[1]
    chunk_rows = min(chunk_rows, rows)
    n_chunks = -(-rows // chunk_rows)
    halo = row_bound + 2

    def one(i):
        blk = jax.lax.dynamic_slice_in_dim(
            padded, i * chunk_rows, chunk_rows + 2 * halo, 0
        )
        out = remap_band_fast(
            blk, coeff_x, coeff_y, row_bound, g_override=g,
            col_matrix=col_matrix,
        )
        return out[halo : halo + chunk_rows]

    out = jax.lax.map(one, jnp.arange(n_chunks)).reshape(
        n_chunks * chunk_rows, width
    )
    return out[:rows]


def pad_for_fast_remap(
    src: jax.Array, rows: int, chunk_rows: int, row_bound: int
) -> jax.Array:
    """Bottom-fill a halo-carrying buffer to the chunk grid of
    :func:`_remap_fast_over_padded`: ``src`` is (rows + 2*halo, W) with the
    halo context already in place; returns
    (ceil(rows/chunk)*chunk + 2*halo, W)."""
    chunk_rows = min(chunk_rows, rows)
    n_chunks = -(-rows // chunk_rows)
    fill = n_chunks * chunk_rows - rows
    return jnp.pad(src, ((0, fill), (0, 0))) if fill else src


def remap_band_fast_chunked(
    src: jax.Array, coeff_x, coeff_y, chunk_rows: int,
    row_bound: int = ROW_OFF_BOUND_FAST,
    col_block: int | None = None,
    col_halo: int | None = None,
) -> jax.Array:
    """Row-chunk-streamed :func:`remap_band_fast` (lax.map) so HBM holds one
    chunk's working set; the column matrix is built once and reused."""
    rows, width = src.shape
    col_matrix = _col_interp_matrix(
        jnp.asarray(coeff_x, jnp.float32), width, col_block, col_halo
    )
    g = _band_g(coeff_y, width)
    halo = row_bound + 2
    padded = pad_for_fast_remap(
        jnp.pad(src, ((halo, halo), (0, 0))), rows, chunk_rows, row_bound
    )
    return _remap_fast_over_padded(
        padded, rows, coeff_x, coeff_y, chunk_rows, row_bound, col_matrix, g
    )


def remap_const_fast_chunked(
    src: jax.Array,
    dx: jax.Array,
    dy: jax.Array,
    chunk_rows: int,
    row_bound: int = ROW_OFF_BOUND_FAST,
    col_block: int | None = None,
    col_halo: int | None = None,
) -> jax.Array:
    """Constant-translation fast remap (the prestitch case) with *traced*
    scalar ``dx``/``dy``.

    Same maps as :func:`remap_band_fast_chunked` with
    cX = [4*dx, 0] / cY = [4*dy, 0, 0], but the vertical cubic exploits the
    row-constant shift: instead of ``2*row_bound + 4`` masked MAC passes it
    takes the 4 taps directly via traced-start ``dynamic_slice`` — the cost
    no longer grows with the supported |dy| bound.  ``row_bound`` only
    sizes the halo (callers clamp |dy| <= row_bound - 2).
    """
    rows = src.shape[0]
    halo = row_bound + 2
    padded = pad_for_fast_remap(
        jnp.pad(src, ((halo, halo), (0, 0))), rows, chunk_rows, row_bound
    )
    return _remap_const_over_padded(
        padded, rows, dx, dy, chunk_rows, row_bound, col_block, col_halo
    )


def _remap_const_over_padded(
    padded: jax.Array,
    rows: int,
    dx: jax.Array,
    dy: jax.Array,
    chunk_rows: int,
    row_bound: int,
    col_block: int | None = None,
    col_halo: int | None = None,
) -> jax.Array:
    """Chunked constant-shift remap over a row-padded buffer (same halo
    contract as :func:`_remap_fast_over_padded`)."""
    f32 = jnp.float32
    width = padded.shape[1]
    dx = jnp.asarray(dx, f32)
    dy = jnp.asarray(dy, f32)
    chunk_rows = min(chunk_rows, rows)
    n_chunks = -(-rows // chunk_rows)
    col_matrix = _col_interp_matrix(
        jnp.stack([f32(MSS_BANDS) * dx, f32(0.0)]), width,
        col_block, col_halo,
    )
    iy0 = jnp.floor(dy)
    fy = dy - iy0
    iy0 = iy0.astype(jnp.int32)
    w0, w1, w2, w3 = _cubic_weights_f32(fy)
    halo = row_bound + 2

    def one(i):
        blk = jax.lax.dynamic_slice_in_dim(
            padded, i * chunk_rows, chunk_rows + 2 * halo, 0
        )
        colg = _col_interp_apply(blk.astype(f32), col_matrix)
        # output row y reads colg rows y + halo + iy0 + (a - 1), a in 0..3;
        # the clamp contract keeps the traced start in range
        acc = jnp.zeros((chunk_rows, width), f32)
        for a, wa in enumerate((w0, w1, w2, w3)):
            tap = jax.lax.dynamic_slice_in_dim(
                colg, halo + iy0 + a - 1, chunk_rows, 0
            )
            acc = acc + tap * wa
        return jnp.clip(jnp.rint(acc), 0.0, 65535.0).astype(jnp.uint16)

    out = jax.lax.map(one, jnp.arange(n_chunks)).reshape(
        n_chunks * chunk_rows, width
    )
    return out[:rows]


def remap_const_stitch_chunked(
    pan1: jax.Array,
    pan2: jax.Array,
    pan1_params: jax.Array,
    pan2_params: jax.Array,
    dx: jax.Array,
    dy: jax.Array,
    fold: int,
    chunk_rows: int,
    row_bound: int = ROW_OFF_BOUND_FAST,
    col_block: int | None = None,
    col_halo: int | None = None,
    want_prestt: bool = False,
):
    """Fused RRC + constant-shift prestitch remap + seam concat.

    The flagship pipeline's dual-CMOS tail as ONE chunk-streamed pass:
    each row chunk RRCs PAN1 (left stitch half) and PAN2 (+halo), remaps
    PAN2 by the traced (dx, dy) translation, and emits the stitched rows
    directly — the corrected strips and the prestitch intermediate are
    never materialised in HBM (saves ~3 strip-sized round trips vs the
    separate RRC -> remap -> concatenate programs).  Border rows beyond
    the strip read 0 *post*-RRC (reference BORDER_CONSTANT semantics).

    Returns stitched (rows, 2*(W-fold)) u16; with ``want_prestt`` also
    the prestitched PAN2 (rows, W).
    """
    from .rrc import _rrc_math

    f32 = jnp.float32
    rows, width = pan1.shape
    dx = jnp.asarray(dx, f32)
    dy = jnp.asarray(dy, f32)
    chunk_rows = min(chunk_rows, rows)
    n_chunks = -(-rows // chunk_rows)
    fill = n_chunks * chunk_rows - rows
    halo = row_bound + 2
    col_matrix = _col_interp_matrix(
        jnp.stack([f32(MSS_BANDS) * dx, f32(0.0)]), width,
        col_block, col_halo,
    )
    iy0 = jnp.floor(dy)
    fy = dy - iy0
    iy0 = iy0.astype(jnp.int32)
    wys = _cubic_weights_f32(fy)

    if fill:
        pan1 = jnp.pad(pan1, ((0, fill), (0, 0)))
    pan2_padded = jnp.pad(pan2, ((halo, halo + fill), (0, 0)))

    def rrc_block(blk, params):
        return _rrc_math(
            blk.astype(jnp.int32), *[params[i][None, :] for i in range(6)]
        ).astype(jnp.uint16)

    def one(i):
        a = i * chunk_rows
        p1c = rrc_block(
            jax.lax.dynamic_slice(pan1, (a, 0), (chunk_rows, width)),
            pan1_params,
        )
        p2blk = jax.lax.dynamic_slice(
            pan2_padded, (a, 0), (chunk_rows + 2 * halo, width)
        )
        g_rows = a - halo + jnp.arange(chunk_rows + 2 * halo)
        inside = (g_rows >= 0) & (g_rows < rows)
        p2c = jnp.where(
            inside[:, None], rrc_block(p2blk, pan2_params), jnp.uint16(0)
        )
        colg = _col_interp_apply(p2c.astype(f32), col_matrix)
        acc = jnp.zeros((chunk_rows, width), f32)
        for a_i, wa in enumerate(wys):
            tap = jax.lax.dynamic_slice_in_dim(
                colg, halo + iy0 + a_i - 1, chunk_rows, 0
            )
            acc = acc + tap * wa
        prestt = jnp.clip(jnp.rint(acc), 0.0, 65535.0).astype(jnp.uint16)
        stitched = jnp.concatenate(
            [p1c[:, : width - fold], prestt[:, fold:]], axis=1
        )
        if want_prestt:
            return stitched, prestt
        return stitched

    out = jax.lax.map(one, jnp.arange(n_chunks))
    if want_prestt:
        stitched, prestt = out
        return (
            stitched.reshape(n_chunks * chunk_rows, -1)[:rows],
            prestt.reshape(n_chunks * chunk_rows, width)[:rows],
        )
    return out.reshape(n_chunks * chunk_rows, -1)[:rows]


def remap_polynomial_u16(
    src: jax.Array, coeff_x, coeff_y, quantized_coords: bool = False
) -> jax.Array:
    """Band-alignment remap of one section with fitted polynomials."""
    plan = plan_for_band_alignment(
        coeff_x, coeff_y, src.shape[1], quantized_coords
    )
    return remap_section_u16(src, plan)


def remap_constant_shift_u16(
    src: jax.Array, dx: float, dy: float, quantized_coords: bool = False
) -> jax.Array:
    """Pre-stitch constant-translation remap of one section."""
    plan = plan_for_constant_shift(dx, dy, src.shape[1], quantized_coords)
    return remap_section_u16(src, plan)
