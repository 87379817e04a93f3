"""RRC kernel parity tests: double-word float32 kernel vs the float64 oracle
(which is bit-exact to the C++ reference's InplaceRRC, imageop.h:129-138)."""

import numpy as np
import pytest

from opticalimageprocessor_tpu.ops import cv_exact, rrc


def _run(src, k, b, **kw):
    import jax.numpy as jnp

    params = jnp.asarray(rrc.split_rrc_params(k, b))
    return np.asarray(rrc.rrc_apply(jnp.asarray(src), params, **kw))


def _sweep_case(k, b):
    """All 65536 pixel values in one column pair."""
    src = np.tile(np.arange(65536, dtype=np.uint16)[None, :], (1, 1))
    kk = np.full(65536, k)
    bb = np.full(65536, b)
    want = cv_exact.rrc_exact(src, kk, bb)
    got = _run(src, kk, bb)
    return want, got


@pytest.mark.parametrize(
    "k,b",
    [
        (1.0, 0.0),
        (0.5, 0.5),
        (2.0, -65536.0),
        (0.9987654321, 12.3456789),
        (1.0123456789, -17.25),
        (3.14159265358979, -100000.5),
        (-0.75, 30000.0),        # negative gain -> negative values wrap
        (1e-9, 0.999999999),
        (70000.0, 0.0),          # overflow wrap far beyond uint16
    ],
)
def test_rrc_full_sweep_exact(k, b):
    want, got = _sweep_case(k, b)
    mism = np.nonzero(want != got)
    assert mism[0].size == 0, (
        f"{mism[0].size} mismatches; first at src={mism[1][:5]} "
        f"want={want[mism][:5]} got={got[mism][:5]}"
    )


def test_rrc_random_params_full_sweep(rng):
    # realistic calibration-like params on a full sweep, many columns
    cols = 65536
    src = np.tile(np.arange(cols, dtype=np.uint16)[None, :], (4, 1))
    rng.shuffle(src.T)  # random pixel/column pairing, all values covered
    k = 0.9 + 0.2 * rng.random(cols)
    b = rng.normal(0, 50, cols)
    want = cv_exact.rrc_exact(src, k, b)
    got = _run(src, k, b)
    diff = np.abs(want.astype(np.int32) - got.astype(np.int32))
    # contract: byte-identical (measured 0 mismatches); never beyond 1 DN
    assert diff.max() == 0, f"max diff {diff.max()}, count {(diff > 0).sum()}"


@pytest.mark.parametrize("shape", [(48, 256), (3, 100), (1, 1), (257, 1031)])
def test_rrc_odd_shapes_match_oracle(rng, shape):
    """Shapes off every tile grid: rows below any block height, widths
    that are not powers of two, a single pixel."""
    rows, cols = shape
    src = rng.integers(0, 65536, size=shape, dtype=np.uint16)
    k = 0.95 + 0.1 * rng.random(cols)
    b = rng.normal(0, 20, cols)
    np.testing.assert_array_equal(_run(src, k, b), cv_exact.rrc_exact(src, k, b))


def test_rrc_oversized_tile_shapes(rng):
    # rows smaller than a tile, cols not multiple of tile width: the
    # identity correction returns the input
    src = rng.integers(0, 65536, size=(3, 100), dtype=np.uint16)
    k = np.ones(100)
    b = np.zeros(100)
    got = _run(src, k, b)
    np.testing.assert_array_equal(got, src)
