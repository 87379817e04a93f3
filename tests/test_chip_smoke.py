"""The parts of chip_smoke.py that run without a GPU: scene construction,
the downlink, the gates and the result line."""

import json

import numpy as np
import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def small_scene():
    return cs.make_scene(512, seed=3)


def test_make_scene_geometry(small_scene):
    from opticalimageprocessor_tpu.ops import resample

    sc = small_scene
    scene = sc["scene"]
    assert scene.shape == (128, cs.BAND_PX)
    assert sc["pan1"].shape == sc["pan2"].shape == (512, cs.PPL)
    want = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    )
    np.testing.assert_array_equal(sc["pan1"], want.astype(np.uint16))
    # PAN2's first OVERLAP columns are PAN1's last, offset by (dy=2, dx=3)
    np.testing.assert_array_equal(
        sc["pan2"][2:, : cs.OVERLAP - 3],
        sc["pan1"][:-2, cs.PPL - cs.OVERLAP + 3:],
    )
    for key, truth in (("mss", scene), ("mss2", sc["scene2"])):
        bands = sc[key].reshape(128, 4, cs.BAND_PX)
        for b in range(4):
            back = np.roll(
                bands[:, b], (-cs.BAND_VY[b], -cs.BAND_VX[b]), axis=(0, 1)
            )
            np.testing.assert_array_equal(back, truth)


def test_downlink_separates_byte_exact(tmp_path, rng):
    """The downlink's faults lose nothing but the dropped frame, which the
    separator zero-fills."""
    from opticalimageprocessor_tpu import cli

    pan = rng.integers(0, 65536, (3 * 1024, cs.PPL), dtype=np.uint16)
    mss = rng.integers(0, 65536, (3 * 256, cs.PPL), dtype=np.uint16)
    downlink, want = cs.build_downlink(pan, mss, dropped=2)
    assert not want["pan"][1024:2048].any() and not want["mss"][256:512].any()
    np.testing.assert_array_equal(want["pan"][2048:], pan[2048:])
    path = tmp_path / "KASHI_TJ3-01_20220817_031259_1.dat"
    downlink.tofile(path)
    assert cli.main(["auxsep", str(path), "--out-dir", str(tmp_path)]) == 0
    for key in ("pan", "mss"):
        (out,) = tmp_path.glob(f"*.{key.upper()}.RAW")
        got = np.fromfile(out, "<u2").reshape(-1, cs.PPL)
        np.testing.assert_array_equal(got, want[key])


def test_downlink_rejects_first_or_missing_frame(rng):
    pan = np.zeros((2 * 1024, cs.PPL), np.uint16)
    mss = np.zeros((2 * 256, cs.PPL), np.uint16)
    for dropped in (1, 2, 5):
        with pytest.raises(cs.PhaseFailed):
            cs.build_downlink(pan, mss, dropped=dropped)


@pytest.mark.parametrize(
    "lines,section,overlap,rows",
    [(2048, 1536, 100, 1436), (3000, 1536, 100, 2872), (1499, 1536, 100, 0)],
)
def test_aligned_rows(lines, section, overlap, rows):
    assert cs.aligned_rows(lines, section, overlap) == rows


def test_correlation_gate(small_scene):
    scene = small_scene["scene"]
    aligned = np.stack([scene] * 4, axis=-1)
    assert cs.band_correlations(aligned, scene) == pytest.approx([1.0] * 4)
    cs.check_correlations("perfect", aligned, scene)
    with pytest.raises(cs.PhaseFailed, match="correlation"):
        cs.check_correlations("rolled", np.roll(aligned, 1, axis=0), scene)


def test_envelope_gate():
    a = np.full((8, 8, 4), 1000, np.uint16)
    cs.check_envelope("same", a, a.copy())
    b = a.copy()
    b[0, 0, 0] += 1                    # mean 1/256 DN: inside
    cs.check_envelope("one pixel", a, b)
    with pytest.raises(cs.PhaseFailed, match="mean"):
        cs.check_envelope("all pixels", a, a + 1)
    with pytest.raises(cs.PhaseFailed, match="shapes"):
        cs.check_envelope("shape", a, a[1:])


def test_rrc_expected_matches_oracle(rng):
    from opticalimageprocessor_tpu.ops import cv_exact

    pan = rng.integers(0, 65536, (37, 50), dtype=np.uint16)
    want = cv_exact.rrc_exact(
        pan[:, :40], np.full(40, cs.PAN_RRC[0]), np.full(40, cs.PAN_RRC[1])
    )
    np.testing.assert_array_equal(
        cs.rrc_expected(pan, 40, rows_per_chunk=8), want
    )


def test_union_length():
    assert cs.union_length([]) == 0
    assert cs.union_length([(0, 10), (5, 15), (20, 25)]) == 20
    assert cs.union_length([(20, 25), (0, 30), (2, 3)]) == 30


def test_busy_time_without_trace(tmp_path):
    assert cs.device_busy_seconds(str(tmp_path)) is None


def test_result_line_format():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = cs.result_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": dev}


def test_refuses_without_gpu(capsys):
    """On the CPU the script exits 2 and prints no result."""
    assert cs.main([]) == 2
    out = capsys.readouterr().out
    assert '"ok"' not in out
