"""Relative Radiometric Correction — per-column gain/bias in float32.

Reference semantics (``imageop.h:129-138``)::

    dst[y,x] = (uint16_t)(k[x] * src[y,x] + b[x])     // k, b are C doubles

i.e. double-precision multiply-add, C truncation toward zero, and (on the
x86-64 builds of the reference) wrap-around through the int32 conversion:
negative values wrap two's-complement, values outside int32 become
0x80000000 (cvttsd2si) whose low 16 bits are 0.

The correction reconstructs the double-precision result with *double-word
float32 arithmetic*: ``k`` is pre-split on the host into exact-product
pieces, the pixel value is split into 8-bit halves, the partial products
are all exact in float32, and a 2Sum accumulation keeps a
(hi, lo) pair carrying ~48 significant bits — more than enough to place the
truncation boundary correctly except for values within ~2^-40 of an integer
(where float64's own rounding is being chased; see tests for the measured
zero mismatch rate over full uint16 sweeps).

Everything is elementwise: XLA fuses the uint16 load, correction and
uint16 store into one pass (about half a plain copy's rate on the H100,
PERF.md).  Every product of pixel bits
and the top parameter pieces is exact in float32, so a backend that
contracts multiply-adds into FMAs gets the same bits (the full uint16
sweep is checked on the device).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def split_rrc_params(k: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side split of float64 (k, b) into exact float32 pieces.

    Returns float32 array of shape (6, cols):
      [0] k_ha : top 12 significant bits of float32(k)
      [1] k_hb : float32(k) - k_ha  (remaining <=12 bits)
      [2] k_lo : float64 residue k - float32(k), rounded to float32
      [3] k_l2 : second residue (so k is carried to ~72 bits)
      [4] b_hi : float32(b)
      [5] b_lo : float64 residue b - float32(b), rounded to float32
    Products k_ha*s8 and k_hb*s8 with 8-bit pixel halves are exact in f32.
    """
    k = np.asarray(k, np.float64)
    b = np.asarray(b, np.float64)
    k_hi = k.astype(np.float32)
    # clear the low 12 stored-mantissa bits -> <=12 significant bits
    k_ha = (k_hi.view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32)
    k_hb = (k_hi - k_ha).astype(np.float32)
    k_res = k - k_hi.astype(np.float64)
    k_lo = k_res.astype(np.float32)
    k_l2 = (k_res - k_lo.astype(np.float64)).astype(np.float32)
    b_hi = b.astype(np.float32)
    b_lo = (b - b_hi.astype(np.float64)).astype(np.float32)
    return np.stack([k_ha, k_hb, k_lo, k_l2, b_hi, b_lo]).astype(np.float32)


def _two_sum(a, b):
    """Knuth 2Sum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _rrc_math(s_i32, k_ha, k_hb, k_lo, k_l2, b_hi, b_lo):
    """Double-word evaluation of trunc(k*s + b) with reference cast semantics.

    ``s_i32``: pixel values as int32 in [0, 65535]; param pieces broadcast
    along rows.  Returns int32 in [0, 65535] (the low 16 bits of the C cast).
    """
    f32 = jnp.float32
    sa = (s_i32 & 0xFF00).astype(f32)   # high byte * 256, exact
    sb = (s_i32 & 0x00FF).astype(f32)   # low byte, exact
    s_f = sa + sb                       # exact (disjoint bit ranges)

    # exact partial products of float32(k) * s
    p1 = k_ha * sa
    p2 = k_ha * sb
    p3 = k_hb * sa
    p4 = k_hb * sb

    hi, e1 = _two_sum(p1, p2)
    hi, e2 = _two_sum(hi, p3)
    hi, e3 = _two_sum(hi, p4)
    lo = e1 + e2 + e3                   # exact: confined to a narrow window

    # low-order k residue contributions (rounded, far below 2^-40 relative)
    lo = lo + (k_lo * s_f + k_l2 * s_f)

    # + b (double-word add; cancellation-safe via full 2Sum)
    hi, e4 = _two_sum(hi, b_hi)
    lo = lo + e4
    hi, e5 = _two_sum(hi, b_lo)
    lo = lo + e5
    # renormalise
    hi, e6 = _two_sum(hi, lo)
    lo = e6

    # Truncate toward zero and reduce mod 2^16 without ever collapsing the
    # (hi, lo) pair into one float32 (which would drop low bits for |v|>2^24):
    #   floor(hi+lo) = floor(hi) + floor((hi-floor(hi)) + lo)   exactly,
    # and only floor(hi) mod 2^16 is needed, which is exact in f32.
    t0 = jnp.floor(hi)                  # exact
    rem = (hi - t0) + lo                # exact for integer-valued hi; else ~exact
    fl = jnp.floor(rem)                 # in {-1, 0} typically
    frac_nonzero = (rem - fl) > 0
    is_neg = (t0 + fl) < 0              # sign decided by t0 when |t0| large
    add1 = jnp.where(is_neg & frac_nonzero, jnp.int32(1), jnp.int32(0))

    t0_mod = t0 - jnp.floor(t0 * f32(1.0 / 65536.0)) * f32(65536.0)  # exact
    i = t0_mod.astype(jnp.int32) + fl.astype(jnp.int32) + add1

    # x86-64 cvttsd2si out-of-range behaviour: |v| >= 2^31 (or NaN) yields
    # 0x80000000, whose low 16 bits are 0.
    in_range = jnp.abs(hi) < f32(2147483648.0)
    return jnp.where(in_range, i & 0xFFFF, jnp.int32(0))


@jax.jit
def rrc_apply(src: jax.Array, params: jax.Array):
    """Apply RRC to a uint16 strip.

    ``src``: (rows, cols) uint16;  ``params``: (6, cols) float32 from
    :func:`split_rrc_params`.  Returns (rows, cols) uint16.  Plain
    elementwise math that XLA fuses into one pass (and, on the scene
    pipeline's fused routes, into its consumers).
    """
    return _rrc_math(
        src.astype(jnp.int32),
        params[0][None, :],
        params[1][None, :],
        params[2][None, :],
        params[3][None, :],
        params[4][None, :],
        params[5][None, :],
    ).astype(jnp.uint16)


def rrc_apply_numpy_exact(src: np.ndarray, k: np.ndarray, b: np.ndarray):
    """Host float64 path — bit-exact to the C++ reference (test oracle)."""
    from . import cv_exact

    return cv_exact.rrc_exact(src, k, b)
