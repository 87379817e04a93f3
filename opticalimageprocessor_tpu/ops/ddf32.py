"""Double-word float32 ("double-float") arithmetic for device code.

Where a reference computation is carried in C ``double`` (the NumCpp
polynomial fits, preproc.h:514-550), the device-side equivalent here uses
*pairs* of float32 values (hi, lo) with ``hi + lo`` representing the value
to ~2^-48 relative precision — effectively double precision for the value
ranges involved.  The building blocks are the classical error-free
transformations (Knuth 2Sum, an exact split + 2Prod).

The transformations must stay exact when a backend contracts a multiply
and an add into one FMA (XLA:GPU may).  So every product that feeds an
addition is exact in float32: the split keeps the top 12 significant bits
by masking (not Veltkamp's ``(2^12+1)*a`` trick, whose inexact product an
FMA would absorb), and 2Prod sums the four exact partial products with
2Sum instead of Dekker's ``ah*bh - fl(a*b)``.  Contracting an exact
product into an add rounds the same sum once, so FMAs change nothing.

All helpers are elementwise over arrays and jit/shard_map/vmap friendly.
A dd value is a ``(hi, lo)`` tuple of same-shaped float32 arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI_MASK = 0xFFFFF000  # keeps 1 + 11 stored = 12 significant bits


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b), s + e = a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """a = hi + lo exactly, each part with <= 12 significant bits."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32) & jnp.uint32(_HI_MASK)
    hi = jax.lax.bitcast_convert_type(bits, jnp.float32)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: (p, e) with p + e = a*b (to ~2^-48 relative).

    The four partial products of the 12-bit halves are exact in float32;
    2Sum accumulates them without loss."""
    ah, al = _split(a)
    bh, bl = _split(b)
    s, e1 = two_sum(ah * bh, ah * bl)
    s, e2 = two_sum(s, al * bh)
    s, e3 = two_sum(s, al * bl)
    return fast_two_sum(s, e1 + e2 + e3)


def dd(hi, lo=None):
    """Make a dd value from float32 parts (lo defaults to 0)."""
    hi = jnp.asarray(hi, jnp.float32)
    return (hi, jnp.zeros_like(hi) if lo is None else jnp.asarray(lo, jnp.float32))


def dd_add(a, b):
    """dd + dd (Knuth-style, accurate for any sign combination)."""
    s, e = two_sum(a[0], b[0])
    t, f = two_sum(a[1], b[1])
    e = e + t
    s, e = fast_two_sum(s, e)
    e = e + f
    return fast_two_sum(s, e)


def dd_neg(a):
    return (-a[0], -a[1])


def dd_sub(a, b):
    return dd_add(a, dd_neg(b))


def dd_mul(a, b):
    """dd * dd."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return fast_two_sum(p, e)


def dd_mul_f32(a, b):
    """dd * plain float32 array."""
    p, e = two_prod(a[0], b)
    e = e + a[1] * b
    return fast_two_sum(p, e)


def dd_div(a, b):
    """dd / dd via one Newton correction of the float32 quotient."""
    q1 = a[0] / b[0]
    r = dd_sub(a, dd_mul_f32(b, q1))
    q2 = (r[0] + r[1]) / b[0]
    return fast_two_sum(q1, q2)


def dd_sum(a, axis: int = -1):
    """Reduce one axis of a dd array pair with pairwise dd adds (exact
    transformations at every node, so the result is independent of any
    backend reduction order)."""
    hi, lo = a
    ax = axis % hi.ndim
    hi = jnp.moveaxis(hi, ax, 0)
    lo = jnp.moveaxis(lo, ax, 0)
    n = hi.shape[0]
    # pad to a power of two with zeros (exact additive identity)
    p = 1
    while p < n:
        p *= 2
    if p != n:
        pad = [(0, p - n)] + [(0, 0)] * (hi.ndim - 1)
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    v = (hi, lo)
    while v[0].shape[0] > 1:
        half = v[0].shape[0] // 2
        v = dd_add(
            (v[0][:half], v[1][:half]), (v[0][half:], v[1][half:])
        )
    return (v[0][0], v[1][0])


def dd_to_f32(a):
    return a[0] + a[1]


def solve_spd_dd(A, r, n: int):
    """Solve an ``n x n`` SPD system in dd arithmetic (unrolled Gaussian
    elimination, no pivoting — valid for SPD normal-equation matrices).

    ``A``: dict {(j, k): dd scalar}; ``r``: list of dd scalars.
    Returns a list of dd solutions.
    """
    A = dict(A)
    r = list(r)
    for j in range(n):
        for i in range(j + 1, n):
            f = dd_div(A[(i, j)], A[(j, j)])
            for k in range(j, n):
                A[(i, k)] = dd_sub(A[(i, k)], dd_mul(f, A[(j, k)]))
            r[i] = dd_sub(r[i], dd_mul(f, r[j]))
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = r[i]
        for k in range(i + 1, n):
            acc = dd_sub(acc, dd_mul(A[(i, k)], x[k]))
        x[i] = dd_div(acc, A[(i, i)])
    return x


def fit_poly_weighted_dd(x, y, deg: int, w):
    """Weighted least-squares polynomial fit in dd arithmetic.

    ``x``/``y``/``w``: (T,) float32 arrays (w is a 0/1 validity mask).
    Solves the weighted normal equations with dd moments and a dd SPD
    solve, returning ascending coefficients as a (deg+1,) float32 pair
    list [(hi, lo), ...] — callers usually take ``dd_to_f32``.

    This is the device-side stand-in for the host float64 Vandermonde
    lstsq (ops/polyfit.polyfit_ascending, mirroring NumCpp Poly1d::fit,
    preproc.h:514-550): with |x| normalised to O(1), the ~2^-48 dd
    precision keeps the coefficient error orders of magnitude below the
    fit's own statistical noise (<=1e-6 px over the strip; see
    tests/test_device_pipeline.py::test_fit_poly_matches_float64).
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    w = jnp.asarray(w, jnp.float32)

    # dd powers of x: exact products chained from x
    powers = [dd(jnp.ones_like(x))]
    for _ in range(2 * deg):
        powers.append(dd_mul(powers[-1], (x, jnp.zeros_like(x))))

    # moments m_k = sum w * x^k  (w in {0,1}: scaling is exact)
    def wsum(v):
        return dd_sum((v[0] * w, v[1] * w))

    m = [wsum(p) for p in powers]
    r = [wsum(dd_mul_f32(powers[k], y)) for k in range(deg + 1)]
    A = {(j, k): m[j + k] for j in range(deg + 1) for k in range(deg + 1)}
    return solve_spd_dd(A, r, deg + 1)
