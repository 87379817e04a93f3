"""End-to-end pipeline tests on small synthetic scenes (virtual CPU devices).

The reference ships no test data; these scenes are synthesised from the
frame/geometry specs so every stage (auxsep -> RRC -> register -> align ->
prestitch -> stitch) can be exercised and cross-checked.
"""

import os

import numpy as np
import pytest

from opticalimageprocessor_tpu.formats import aos, rrc_csv

PPL = 1024          # test-scale line width (camera default is 12288)
BAND_PX = PPL // 4


def _smooth_field(rng, h, w, scale=40):
    """Smooth random terrain so phase correlation has structure to lock on."""
    small = rng.random((h // scale + 2, w // scale + 2))
    try:
        import cv2

        f = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    except ImportError:
        f = np.kron(small, np.ones((scale, scale)))[:h, :w]
    f = f + 0.05 * rng.random((h, w))
    return (f * 20000 + 3000).astype(np.uint16)


def _write_identity_rrc(tmp_path, name, cols, k=1.0, b=0.0):
    p = str(tmp_path / name)
    rrc_csv.save_rrc_params(p, np.tile([[k, b]], (cols, 1)))
    return p


@pytest.mark.parametrize("chunk", [0, 50_000])
def test_auxsep_roundtrip(tmp_path, rng, chunk):
    """Synthetic AOS downlink -> AuxSeparator -> recover PAN/MSS/AUX.

    chunk=50000 forces the chunked-scan carry-over (not a multiple of the
    1024-byte frame, so every seam splits a frame and the IMTR remainder)."""
    from opticalimageprocessor_tpu.models.auxsep import AuxSeparator

    n_frames = 2
    pan = rng.integers(0, 65536, (1024 * n_frames, 12288), dtype=np.uint16)
    mss = rng.integers(0, 65536, (256 * n_frames, 12288), dtype=np.uint16)
    aux = bytes(rng.integers(0, 256, aos.IMGSIG_AUX_ALLBYTES, dtype=np.uint8))

    imdt = b"".join(
        aos.build_image_frame(
            pan[i * 1024 : (i + 1) * 1024],
            mss[i * 256 : (i + 1) * 256],
            seq=i + 1,
            aux=aux,
        )
        for i in range(n_frames)
    )
    imtr_frames = b"".join(
        aos.build_imtr_frame(pl, i + 1)
        for i, pl in enumerate(aos.split_stream_into_imtr_payload(imdt))
    )
    aos_stream = b"JUNKHEADER" + b"".join(
        aos.build_aos_frame(pl, i)
        for i, pl in enumerate(aos.split_stream_into_aos_payload(imtr_frames))
    ) + aos.build_empty_aos_frame()

    aos_path = str(tmp_path / "KASHI_TJ3-01_20220817_031259_1.dat")
    with open(aos_path, "wb") as f:
        f.write(aos_stream)

    sep = AuxSeparator(aos_path, out_dir=str(tmp_path), chunk_bytes=chunk)
    outs = sep.separate()

    got_pan = np.fromfile(outs["pan"], dtype="<u2").reshape(-1, 12288)
    got_mss = np.fromfile(outs["mss"], dtype="<u2").reshape(-1, 12288)
    got_aux = open(outs["aux"], "rb").read()
    assert os.path.basename(sep.imdt_file) == (
        "KASHI_TJ3-01_CMOS-1_20220817_031259.IMDT"
    )
    np.testing.assert_array_equal(got_pan, pan)
    np.testing.assert_array_equal(got_mss, mss)
    assert got_aux == aux * n_frames


def test_auxsep_jp2_compressed_roundtrip(tmp_path, rng):
    """JPEG2000-compressed downlink frames (z_ratio != 0) decode losslessly
    through the Z-header parse + cv2 decode + byte-swap path."""
    pytest.importorskip("cv2")
    from opticalimageprocessor_tpu.models.auxsep import AuxSeparator

    pan = rng.integers(0, 65536, (1024, 12288), dtype=np.uint16)
    mss = rng.integers(0, 65536, (256, 12288), dtype=np.uint16)
    imdt = aos.build_image_frame(pan, mss, seq=1, compress="jp2")
    p = str(tmp_path / "z.IMDT")
    with open(p, "wb") as f:
        f.write(imdt)
    outs = AuxSeparator(p, out_dir=str(tmp_path)).separate()
    got_pan = np.fromfile(outs["pan"], dtype="<u2").reshape(-1, 12288)
    got_mss = np.fromfile(outs["mss"], dtype="<u2").reshape(-1, 12288)
    np.testing.assert_array_equal(got_pan, pan)
    np.testing.assert_array_equal(got_mss, mss)


def test_auxsep_zero_fill_missing_frames(tmp_path, rng):
    from opticalimageprocessor_tpu.models.auxsep import AuxSeparator

    pan = rng.integers(0, 65536, (1024, 12288), dtype=np.uint16)
    mss = rng.integers(0, 65536, (256, 12288), dtype=np.uint16)
    # frames 1 and 3: frame 2 missing -> zero filled
    imdt = aos.build_image_frame(pan, mss, seq=1) + aos.build_image_frame(
        pan, mss, seq=3
    )
    p = str(tmp_path / "x.IMDT")
    with open(p, "wb") as f:
        f.write(imdt)
    outs = AuxSeparator(p, out_dir=str(tmp_path)).separate()
    got_pan = np.fromfile(outs["pan"], dtype="<u2").reshape(-1, 12288)
    assert got_pan.shape[0] == 3 * 1024
    np.testing.assert_array_equal(got_pan[:1024], pan)
    assert not got_pan[1024:2048].any()
    np.testing.assert_array_equal(got_pan[2048:], pan)


@pytest.fixture(scope="module")
def synthetic_scene(tmp_path_factory):
    """A physically consistent scene: a band-resolution noise field S is the
    'ground truth'; PAN is its 4x cubic upsample and each MSS band sees S
    rolled by a known integer shift.  Because the upsample filter commutes
    with translation, phase correlation of (PAN, upsample4(band)) recovers
    exactly 4x the band shift — no resampling phase offset."""
    rng = np.random.default_rng(42)
    tmp = tmp_path_factory.mktemp("scene")
    lines_mss = 1600
    lines_pan = lines_mss * 4

    s = rng.integers(2000, 42000, (lines_mss, BAND_PX)).astype(np.uint16)

    from opticalimageprocessor_tpu.ops import resample

    pan = np.asarray(resample.upsample4_f32(s.astype(np.float32)))
    pan = np.clip(np.rint(pan), 0, 65535).astype(np.uint16)
    assert pan.shape == (lines_pan, PPL)

    # integer band shifts in *band* pixels -> expected measurement = 4x
    band_vy = [0, -1, 1, 0]
    band_vx = [1, 0, -1, 2]
    bands = [
        np.roll(np.roll(s, band_vy[b], axis=0), band_vx[b], axis=1)
        for b in range(4)
    ]

    mss_interleaved = np.stack(bands, axis=1).reshape(lines_mss, PPL)
    pan_path = str(tmp / "scene.PAN.RAW")
    mss_path = str(tmp / "scene.MSS.RAW")
    pan.astype("<u2").tofile(pan_path)
    mss_interleaved.astype("<u2").tofile(mss_path)
    return {
        "tmp": tmp,
        "pan": pan_path,
        "mss": mss_path,
        "vy": band_vy,
        "vx": band_vx,
        "scene": s,
        "pan_arr": pan,
    }


def test_preprocessor_end_to_end(synthetic_scene, tmp_path):
    from opticalimageprocessor_tpu.io import tiff as tiff_io
    from opticalimageprocessor_tpu.models.preprocessor import PreProcessor

    sc = synthetic_scene
    rrc_pan = _write_identity_rrc(tmp_path, "pan.rrc", PPL)
    rrc_mss = tuple(
        _write_identity_rrc(tmp_path, f"mss{b}.rrc", BAND_PX) for b in range(4)
    )
    pp = PreProcessor(
        sc["pan"], sc["mss"], rrc_pan, rrc_mss, out_dir=str(tmp_path),
        pixels_per_line=PPL,
    )
    pp.load_and_rrc(do_rrc_pan=True, do_rrc_mss=True)
    pp.calc_inter_band_correlation(slices=8, sections=1, threshold=0.1)

    # measured shifts = 4x the constructed band shifts (roll moves content
    # forward; phaseCorrelate(a, roll(a, +v)) returns +v)
    for b in range(4):
        mean_dx = np.mean([s.dx for s in pp.band_shifts[b]])
        mean_dy = np.mean([s.dy for s in pp.band_shifts[b]])
        assert abs(mean_dx - 4 * sc["vx"][b]) < 0.35, (b, mean_dx)
        assert abs(mean_dy - 4 * sc["vy"][b]) < 0.35, (b, mean_dy)

    out = pp.do_inter_band_alignment(
        line_per_section=1600, section_overlap=20, write_tiff=True
    )
    assert os.path.exists(out)
    img = tiff_io.read_tiff(out)
    assert img.shape == (1600 - 20, BAND_PX, 4)

    # alignment must undo the constructed shifts: every output channel should
    # match the shared scene S (interior, away from roll wrap and overlap)
    # channel order on disk is [2,1,0,3] (cv::imwrite BGRA->RGBA parity)
    interior = np.s_[100:1400, 32:-32]
    sref = sc["scene"][20:1600][interior].astype(float)
    for ch, band in zip([2, 1, 0, 3], range(4)):
        got = img[..., ch][interior].astype(float)
        corr = np.corrcoef(got.ravel(), sref.ravel())[0, 1]
        assert corr > 0.9, (band, corr)


def test_preprocessor_row_accessors_match_whole_strip(
    synthetic_scene, tmp_path
):
    """The streamed row accessors (pan_rows/band_rows, the r3 replacement
    for whole-strip LoadPAN/LoadMSS materialisation) are bit-identical to
    RRC applied over the whole strip, on any row range; the chunked
    write_rrc_pan_raw emits the same bytes as a whole-strip RRC."""
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.models.preprocessor import PreProcessor
    from opticalimageprocessor_tpu.ops import rrc

    sc = synthetic_scene
    rng = np.random.default_rng(5)
    rrc_pan = str(tmp_path / "pan.rrc")
    rrc_csv.save_rrc_params(
        rrc_pan,
        np.stack(
            [0.9 + 0.2 * rng.random(PPL), rng.normal(0, 30, PPL)], axis=1
        ),
    )
    rrc_mss = []
    for b in range(4):
        p = str(tmp_path / f"m{b}.rrc")
        rrc_csv.save_rrc_params(
            p,
            np.stack(
                [0.9 + 0.2 * rng.random(BAND_PX),
                 rng.normal(0, 30, BAND_PX)], axis=1,
            ),
        )
        rrc_mss.append(p)

    pp = PreProcessor(
        sc["pan"], sc["mss"], rrc_pan, tuple(rrc_mss),
        out_dir=str(tmp_path), pixels_per_line=PPL,
    )
    pp.load_and_rrc(do_rrc_pan=True, do_rrc_mss=True)

    pan_whole = np.asarray(
        rrc.rrc_apply(jnp.asarray(sc["pan_arr"]), pp._pan_params)
    )
    for a, b_ in ((0, 64), (100, 357), (pp.lines_pan - 3, pp.lines_pan)):
        np.testing.assert_array_equal(pp.pan_rows(a, b_), pan_whole[a:b_])

    mss_whole = np.fromfile(sc["mss"], "<u2").reshape(-1, 4, BAND_PX)
    for band in range(4):
        band_whole = np.asarray(
            rrc.rrc_apply(
                jnp.asarray(np.ascontiguousarray(mss_whole[:, band])),
                pp._mss_params[band],
            )
        )
        for a, b_ in ((0, 32), (77, 400)):
            np.testing.assert_array_equal(
                pp.band_rows(band, a, b_), band_whole[a:b_]
            )

    out = pp.write_rrc_pan_raw()
    np.testing.assert_array_equal(
        np.fromfile(out, "<u2").reshape(-1, PPL), pan_whole
    )


def test_preprocessor_fast_mode_matches_parity(synthetic_scene, tmp_path):
    """--fast (blocked-matmul resample, whole-strip streaming) stays within
    1 DN of the parity path away from the section seams the parity path
    inherits from the reference."""
    from opticalimageprocessor_tpu.models.preprocessor import PreProcessor

    sc = synthetic_scene
    rrc_mss = tuple(
        _write_identity_rrc(tmp_path, f"m{b}.rrc", BAND_PX) for b in range(4)
    )
    outs = {}
    for fast in (False, True):
        pp = PreProcessor(
            sc["pan"], sc["mss"], "", rrc_mss, out_dir=str(tmp_path),
            pixels_per_line=PPL, fast=fast,
        )
        pp.load_and_rrc(do_rrc_pan=False, do_rrc_mss=True)
        pp.calc_inter_band_correlation(slices=8, sections=1, threshold=0.1)
        outs[fast] = pp.do_inter_band_alignment(
            line_per_section=1600, section_overlap=20, write_tiff=False
        )
    diff = np.abs(
        outs[True].astype(np.int32) - outs[False].astype(np.int32)
    )
    assert outs[True].shape == outs[False].shape
    # The parity path reproduces the reference's float32 *map storage*
    # (mapy = float32(y + G): ~1e-4 px rounding at y~1600); the fast path
    # uses the ideal coordinate.  On full-bandwidth synthetic noise
    # (gradients ~30000 DN/px) that coordinate difference alone is worth a
    # couple of DN; on imagery it is sub-DN.
    assert diff.max() <= 3, diff.max()
    assert (diff > 1).mean() < 0.01


def test_cli_mesh_align_matches_fast_single_device(synthetic_scene, tmp_path):
    """The --mesh route (models.sharded_align, fed shard-by-shard from the
    memory maps) writes an ALIGNED.TIFF within 1 DN of the single-device
    fast-mode PreProcessor on the same scene."""
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from opticalimageprocessor_tpu.io import tiff as tiff_io
    from opticalimageprocessor_tpu.models.preprocessor import PreProcessor
    from opticalimageprocessor_tpu.models.sharded_align import (
        run_sharded_align,
    )

    sc = synthetic_scene
    rrc_mss = tuple(
        _write_identity_rrc(tmp_path, f"m{b}.rrc", BAND_PX) for b in range(4)
    )
    pp = PreProcessor(
        sc["pan"], sc["mss"], "", rrc_mss, out_dir=str(tmp_path),
        pixels_per_line=PPL, fast=True,
    )
    pp.load_and_rrc(do_rrc_pan=False, do_rrc_mss=True)
    pp.calc_inter_band_correlation(slices=8, sections=1, threshold=0.1)
    single = pp.do_inter_band_alignment(
        line_per_section=1600, section_overlap=20, write_tiff=False
    )

    out = run_sharded_align(
        sc["pan"], sc["mss"], "", rrc_mss, n_devices=8,
        do_rrc_pan=False, do_rrc_mss=True, slices=8, sections=1,
        threshold=0.1, section_overlap=20, out_dir=str(tmp_path),
        pixels_per_line=PPL,
    )
    img = tiff_io.read_tiff(out)
    # disk channel order [2,1,0,3] -> band order
    multi = img[:, :, [2, 1, 0, 3]]
    assert multi.shape == single.shape
    diff = np.abs(multi.astype(np.int32) - single.astype(np.int32))
    # The sharded FFT partitioning (plus run-to-run XLA:CPU scheduling
    # noise) shifts the fitted dy by ~1e-3 px vs the host fit; on
    # full-gradient synthetic noise (~20000 DN/px) that puts a few percent
    # of pixels past 1 DN — on imagery it is sub-DN.  Gate on the shift
    # envelope's DN statistics, not a tight max (measured wobble across
    # runs: (diff>1) 0.5%-3%, mean < 0.1 DN).
    assert diff.max() <= 8, diff.max()
    assert diff.mean() < 0.5, diff.mean()
    assert (diff > 1).mean() < 0.05
    for b in range(4):
        c = np.corrcoef(
            multi[..., b].ravel().astype(np.float64),
            single[..., b].ravel().astype(np.float64),
        )[0, 1]
        assert c > 0.999, (b, c)


def test_cli_parse_time_validation(tmp_path, rng):
    """CLI11 parse-time parity: ->needs rules and ExistingFile checks fail
    with rc 254 before any work (main.cpp:193-203, :105, :114-119)."""
    from opticalimageprocessor_tpu import cli

    exists = str(tmp_path / "x.RAW")
    rng.integers(0, 65536, (4, 8), dtype=np.uint16).tofile(exists)
    # --rrc-pan without --do-rrc4pan: orphan flag is a usage error
    assert cli.main(["--pan", exists, "--mss", exists, "--rrc-pan", exists]) == 254
    # --write-rrcpan without --do-rrc4pan
    assert (
        cli.main(["--pan", exists, "--mss", exists, "--write-rrcpan"]) == 254
    )
    # missing input files -> 254 at parse time, before any processing
    assert cli.main(["--pan", "/nope.RAW", "--mss", exists]) == 254
    assert cli.main(["auxsep", "/nope.dat"]) == 254
    assert (
        cli.main(["prestitch", "--pan1", exists, "--pan2", "/nope.RAW"]) == 254
    )
    assert (
        cli.main(
            ["prestitch", "--pan1", exists, "--pan2", exists, "--rrc1",
             "/nope.rrc"]
        )
        == 254
    )


def test_prestitch_and_stitch_raw(tmp_path, rng):
    from opticalimageprocessor_tpu.models import stitcher as st

    lines = 1200
    overlap = 64
    # full-spectrum content so the overlap-strip correlation locks crisply
    terrain = rng.integers(2000, 42000, (lines + 16, PPL * 2)).astype(np.uint16)
    # CMOS1 = left part, CMOS2 = overlapping right part shifted by known dx/dy
    pan1 = terrain[4 : 4 + lines, :PPL]
    shift_x, shift_y = 3, 2   # CMOS2 sees the scene shifted
    pan2 = terrain[
        4 + shift_y : 4 + lines + shift_y,
        PPL - overlap + shift_x : 2 * PPL - overlap + shift_x,
    ]
    p1 = str(tmp_path / "cmos1.PAN.RAW")
    p2 = str(tmp_path / "cmos2.PAN.RAW")
    pan1.astype("<u2").tofile(p1)
    pan2.astype("<u2").tofile(p2)

    s = st.Stitcher(
        p1, p2, sections=3, line_per_section=256, overlap_cols=overlap,
        out_dir=str(tmp_path), pixels_per_line=PPL,
    )
    s.calc_stt_parameters(threshold=0.05)
    # dx should reflect the constructed overlap displacement
    assert abs(abs(s.delta_y) - shift_y) < 0.5, s.delta_y

    n_lines = s.pre_stitch()
    assert os.path.exists(s.prestt_file_pan2)

    out = st.stitch(
        p1, s.prestt_file_pan2,
        str(tmp_path / "stitched.RAW"), fold_cols_half=overlap // 2,
        pixels_per_line=PPL,
    )
    got = np.fromfile(out, dtype="<u2").reshape(lines, -1)
    assert got.shape[1] == (PPL - overlap // 2) * 2


def test_prestitch_fast_matches_parity(tmp_path, rng):
    """Fast prestitch (blocked-matmul constant-shift remap) matches the parity
    SectionaryRemap output away from section seams/edges."""
    from opticalimageprocessor_tpu.models import stitcher as st

    lines, overlap = 600, 64
    terrain = rng.integers(2000, 42000, (lines + 16, PPL * 2)).astype(np.uint16)
    pan1 = terrain[4 : 4 + lines, :PPL]
    pan2 = terrain[6 : 6 + lines, PPL - overlap + 3 : 2 * PPL - overlap + 3]
    p1 = str(tmp_path / "c1.PAN.RAW")
    p2 = str(tmp_path / "c2.PAN.RAW")
    pan1.astype("<u2").tofile(p1)
    pan2.astype("<u2").tofile(p2)

    outs = {}
    for fast in (False, True):
        d = tmp_path / ("fast" if fast else "parity")
        d.mkdir()
        s_ = st.Stitcher(
            p1, p2, sections=3, line_per_section=128, overlap_cols=overlap,
            out_dir=str(d), pixels_per_line=PPL, fast=fast,
        )
        s_.calc_stt_parameters(threshold=0.05)
        s_.pre_stitch()
        outs[fast] = np.fromfile(s_.prestt_file_pan2, dtype="<u2").reshape(
            -1, PPL
        )
    a, b = outs[False], outs[True]
    n = min(a.shape[0], b.shape[0])
    # parity mode keeps its per-section border rows; compare the interior
    diff = np.abs(
        a[8 : n - 8].astype(np.int32) - b[8 : n - 8].astype(np.int32)
    )
    interior = diff[:, 8:-8]
    assert interior.max() <= 3, interior.max()
    assert (interior > 1).mean() < 0.01


def test_stitch_tiff_with_band_map(tmp_path, rng):
    from opticalimageprocessor_tpu.io import tiff as tiff_io
    from opticalimageprocessor_tpu.models.stitcher import stitch

    h, w = 96, 128
    left = rng.integers(0, 65536, (h, w, 4), dtype=np.uint16)
    right = rng.integers(0, 65536, (h, w, 4), dtype=np.uint16)
    lp = str(tmp_path / "L.TIFF")
    rp = str(tmp_path / "R.TIFF")
    tiff_io.write_tiff(lp, left)
    tiff_io.write_tiff(rp, right)
    out = stitch(
        lp, rp, str(tmp_path / "S.TIFF"), fold_cols_half=8,
        use_gdal_style=True, band_map=[3, 2, 1, 4],
    )
    got = tiff_io.read_tiff(out)
    assert got.shape == (h, (w - 8) * 2, 4)
    want_left = left[:, : w - 8, [2, 1, 0, 3]]
    np.testing.assert_array_equal(got[:, : w - 8], want_left)
    np.testing.assert_array_equal(got[:, w - 8 :], right[:, 8:, [2, 1, 0, 3]])


def test_cli_stitch_and_exit_codes(tmp_path, rng):
    from opticalimageprocessor_tpu import cli

    h, w = 32, 64
    a = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    b = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    pa = str(tmp_path / "a.RAW")
    pb = str(tmp_path / "b.RAW")
    a.astype("<u2").tofile(pa)
    b.astype("<u2").tofile(pb)
    # fold too small -> usage error 254
    assert cli.main(["stitch", "--image1", pa, "--image2", pb, "-c", "1"]) == 254
    # -m without -g -> usage error
    assert (
        cli.main(
            ["stitch", "--image1", pa, "--image2", pb, "-c", "4", "-m", "1,2,3,4"]
        )
        == 254
    )
    # mixed types -> error 2
    assert (
        cli.main(["stitch", "--image1", pa, "--image2", "x.TIFF", "-c", "4"]) == 2
    )


def test_cli_scene_fused_pipeline(tmp_path, rng, caplog):
    """`oiptpu scene`: the fused whole-scene pipeline (device_pipeline) from
    files to ALIGNED.TIFF + stitched PAN in one run."""
    import jax.numpy as jnp

    from opticalimageprocessor_tpu import cli
    from opticalimageprocessor_tpu.io import tiff as tiff_io
    from opticalimageprocessor_tpu.ops import resample

    band_px = PPL // 4
    lines_mss = 320
    lines_pan = lines_mss * 4
    ov = 64
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan1 = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(jnp.asarray(
            scene, jnp.float32)))),
        0, 65535,
    ).astype(np.uint16)
    pan2 = np.roll(np.roll(pan1, 2, axis=0), ov - 3 - PPL, axis=1)
    mss = np.stack(
        [np.roll(scene, b % 2, axis=1) for b in range(4)], axis=1
    ).reshape(lines_mss, PPL)

    p1 = str(tmp_path / "S1.PAN.RAW")
    p2 = str(tmp_path / "S2.PAN.RAW")
    ms = str(tmp_path / "S1.MSS.RAW")
    pan1.astype("<u2").tofile(p1)
    pan2.astype("<u2").tofile(p2)
    mss.astype("<u2").tofile(ms)
    # CMOS2's MSS sees the ground under PAN2: with the circular-roll pan2
    # construction that is the scene rolled by (ov - PPL)/4 band columns
    scene2 = np.roll(scene, (ov - PPL) // 4, axis=1)
    mss2 = np.stack(
        [np.roll(scene2, b % 2, axis=1) for b in range(4)], axis=1
    ).reshape(lines_mss, PPL)
    ms2 = str(tmp_path / "S2.MSS.RAW")
    mss2.astype("<u2").tofile(ms2)

    from opticalimageprocessor_tpu.models.scene import run_scene

    outs = run_scene(
        p1, p2, ms, mss2_file=ms2, slices=8, fold_cols=ov, stt_sections=2,
        threshold=0.05, stt_threshold=0.05,
        out_dir=str(tmp_path), pixels_per_line=PPL,
    )
    del cli  # CLI dispatch covered by test_cli_scene_usage_errors
    # the fused step's estimated parameters are OLOG'd (reference
    # preproc.h:552-560 / stitcher.h:196-199): 8 registration fits (CMOS1
    # + CMOS2 bands) and the averaged stt deltas
    assert caplog.text.count("deltaX coeff") == 8
    assert "everage value" in caplog.text
    aligned = tiff_io.read_tiff(str(tmp_path / "S1.MSS.ALIGNED.TIFF"))
    assert aligned.shape == (lines_mss, band_px, 4)
    for ch, b in enumerate([2, 1, 0, 3]):  # disk order [2,1,0,3]
        a = aligned[8:-8, 8:-8, ch].astype(np.float64)
        w = scene[8:-8, 8:-8].astype(np.float64)
        c = np.corrcoef(a.ravel(), w.ravel())[0, 1]
        assert c > 0.99, (ch, c)
    stitched = [
        f for f in os.listdir(tmp_path) if f.startswith("stitched_")
    ]
    assert stitched, "stitched output missing"
    st = tiff_io.read_tiff(str(tmp_path / stitched[0]))
    assert st.shape == (lines_pan, 2 * (PPL - ov // 2))
    # left half is PAN1's RRC'd (identity) data verbatim
    np.testing.assert_array_equal(
        st[:, : PPL - ov // 2], pan1[:, : PPL - ov // 2]
    )

    # --- CMOS2 MSS: aligned against the prestitched PAN2 + MSS stitch
    a2 = tiff_io.read_tiff(outs["aligned2"])
    assert a2.shape == (lines_mss, BAND_PX, 4)
    for ch in range(4):
        a = a2[8:-8, 8:-8, ch].astype(np.float64)
        w = scene2[8:-8, 8:-8].astype(np.float64)
        c = np.corrcoef(a.ravel(), w.ravel())[0, 1]
        assert c > 0.98, (ch, c)
    stm = tiff_io.read_tiff(outs["stitched_mss"])
    foldm_half = ov // 4 // 2
    assert stm.shape == (lines_mss, 2 * (BAND_PX - foldm_half), 4)


def test_cli_scene_usage_errors(tmp_path, rng):
    from opticalimageprocessor_tpu import cli

    f = str(tmp_path / "x.RAW")
    rng.integers(0, 65536, (4, 8), dtype=np.uint16).tofile(f)
    assert cli.main(
        ["scene", "--pan1", f, "--pan2", f, "--mss", f, "-c", "1"]
    ) == 254
    assert cli.main(
        ["scene", "--pan1", "/nope.RAW", "--pan2", f, "--mss", f]
    ) == 254
    # --out-mss without --mss2 is a parse-time usage error
    assert cli.main(
        ["scene", "--pan1", f, "--pan2", f, "--mss", f,
         "--out-mss", "x.TIFF"]
    ) == 254
    # non-TIFF stitched-MSS output fails fast (before any compute)
    assert cli.main(
        ["scene", "--pan1", f, "--pan2", f, "--mss", f, "--mss2", f,
         "--out-mss", "x.RAW"]
    ) == 2


def test_cli_mesh_flag_coverage(tmp_path, rng):
    """Round 3 lifted the --mesh restrictions: --write-rrcpan and
    --coord-mode quantized are real mesh features now, so they must pass
    parse-time validation (the bogus geometry then fails as a runtime
    error, rc 2 — NOT the old 254 usage error)."""
    from opticalimageprocessor_tpu import cli

    f = str(tmp_path / "m.RAW")
    rng.integers(0, 65536, (4, 8), dtype=np.uint16).tofile(f)
    base = ["--pan", f, "--mss", f, "--no-rrc4mss", "--mesh", "2"]
    assert cli.main(
        base + ["--do-rrc4pan", "--rrc-pan", f, "--write-rrcpan"]
    ) == 2
    assert cli.main(base + ["--coord-mode", "quantized"]) == 2
    # scene threshold validation parity with the default command
    assert cli.main(
        ["scene", "--pan1", f, "--pan2", f, "--mss", f,
         "--ibc-threshold", "1.5"]
    ) == 254


def test_sharded_align_overlap_validation(synthetic_scene, tmp_path):
    import jax
    import pytest

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from opticalimageprocessor_tpu.models.sharded_align import (
        run_sharded_align,
    )

    sc = synthetic_scene
    with pytest.raises(ValueError, match="exceeds maximum allowed"):
        run_sharded_align(
            sc["pan"], sc["mss"], n_devices=8, do_rrc_mss=False,
            section_overlap=5000, out_dir=str(tmp_path),
            pixels_per_line=PPL,
        )


def test_auxsep_offset_restart(tmp_path, rng):
    """`auxsep -O` parity: restarting the AOS scan at a page-aligned byte
    offset skips the leading frames (the reference's partial-resume knob,
    main.cpp:102 / aux_separator.h:197-201); a non-aligned offset is
    rounded down to the page like the reference."""
    from opticalimageprocessor_tpu.models.auxsep import AuxSeparator

    n_frames = 3
    pan = rng.integers(0, 65536, (1024 * n_frames, 12288), dtype=np.uint16)
    mss = rng.integers(0, 65536, (256 * n_frames, 12288), dtype=np.uint16)
    imdt = b"".join(
        aos.build_image_frame(
            pan[i * 1024 : (i + 1) * 1024],
            mss[i * 256 : (i + 1) * 256],
            seq=i + 1,
        )
        for i in range(n_frames)
    )
    imtr = b"".join(
        aos.build_imtr_frame(pl, i + 1)
        for i, pl in enumerate(aos.split_stream_into_imtr_payload(imdt))
    )
    stream = b"".join(
        aos.build_aos_frame(pl, i)
        for i, pl in enumerate(aos.split_stream_into_aos_payload(imtr))
    )
    p = str(tmp_path / "KASHI_TJ3-01_20220817_031259_1.dat")
    with open(p, "wb") as f:
        f.write(stream)

    # The 882-byte IMTR framing has no resync (reference parity,
    # aux_separator.h:487-509), so a useful -O restart must land where the
    # 880-byte AOS payload stream realigns with the 882-byte frames: every
    # lcm(880, 882)/880 = 441 AOS frames; x4 for page alignment.
    off = 1764 * aos.AOS_FRAME_BYTES + 123   # +123: unaligned on purpose
    assert off < len(stream)
    sep = AuxSeparator(p, offset=off, out_dir=str(tmp_path))
    assert sep.offset % 4096 == 0 and sep.offset <= off
    outs = sep.separate()
    got_pan = np.fromfile(outs["pan"], dtype="<u2").reshape(-1, 12288)
    # later frames survive intact: the final frame's PAN block matches
    assert got_pan.shape[0] >= 1024
    np.testing.assert_array_equal(got_pan[-1024:], pan[-1024:])
