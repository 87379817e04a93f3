"""IO layer + native runtime tests: TIFF roundtrips/interop, RAW strips,
LZW codec, byte swap, signature scan."""

import numpy as np
import pytest

from opticalimageprocessor_tpu.io import raw as raw_io
from opticalimageprocessor_tpu.io import tiff as tiff_io
from opticalimageprocessor_tpu.utils import native


@pytest.fixture
def img1(rng):
    return (
        np.cumsum(rng.integers(-3, 4, (200, 300)), axis=1) + 5000
    ).astype(np.uint16)


@pytest.fixture
def img4(img1):
    return np.stack([img1, img1 + 1, img1 + 2, img1 + 3], -1).astype(np.uint16)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"compression": "lzw"},
        {"compression": "lzw", "predictor": True},
        {"bigtiff": True},
        {"compression": "lzw", "predictor": True, "bigtiff": True},
    ],
)
@pytest.mark.parametrize("nch", [1, 4])
def test_tiff_roundtrip(tmp_path, img1, img4, kw, nch):
    img = img1 if nch == 1 else img4
    p = str(tmp_path / "t.tiff")
    tiff_io.write_tiff(p, img, rows_per_strip=64, **kw)
    np.testing.assert_array_equal(tiff_io.read_tiff(p), img)


def test_tiff_interop_with_libtiff(tmp_path, img1, img4):
    cv2 = pytest.importorskip("cv2")
    # our LZW+predictor output must be readable by libtiff (cv2)
    p = str(tmp_path / "ours.tiff")
    tiff_io.write_tiff(p, img4, compression="lzw", predictor=True)
    got = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got[..., [2, 1, 0, 3]], img4)
    # and we must read libtiff's LZW+predictor output
    p2 = str(tmp_path / "theirs.tiff")
    cv2.imwrite(p2, img1, [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    np.testing.assert_array_equal(tiff_io.read_tiff(p2), img1)


def test_tiff_streaming_writer(tmp_path, img1):
    p = str(tmp_path / "s.tiff")
    w = tiff_io.TiffStripWriter(p, 300, 200, samples=1, rows_per_strip=48)
    for off in range(0, 200, 37):  # uneven chunks vs strip size
        w.write_rows(img1[off : off + 37])
    w.close()
    np.testing.assert_array_equal(tiff_io.read_tiff(p), img1)


@pytest.mark.parametrize("chunk", [17, 48, 64, 200])
def test_tiff_iter_rows_matches_whole_read(tmp_path, img4, chunk):
    """The streaming strip reader re-chunked to any block size reproduces
    the whole-raster read exactly (LZW + predictor, uneven strips)."""
    p = str(tmp_path / "t.tiff")
    tiff_io.write_tiff(
        p, img4, rows_per_strip=48, compression="lzw", predictor=True
    )
    blocks = list(tiff_io.iter_tiff_rows(p, chunk))
    assert all(b.shape[0] == chunk for b in blocks[:-1])
    got = np.concatenate(blocks)
    np.testing.assert_array_equal(got, tiff_io.read_tiff(p))


def test_stitch_tiff_sectioned_equals_whole(tmp_path, rng):
    """Streamed sectioned stitching equals the in-memory concat of the two
    whole rasters (StitchTiffGDAL equivalence, imageop.h:489-558)."""
    from opticalimageprocessor_tpu.models.stitcher import stitch_tiff

    h, w, fold = 300, 128, 16
    left = rng.integers(0, 65536, (h, w, 4), dtype=np.uint16)
    right = rng.integers(0, 65536, (h, w, 4), dtype=np.uint16)
    lp, rp = str(tmp_path / "L.TIFF"), str(tmp_path / "R.TIFF")
    tiff_io.write_tiff(lp, left, rows_per_strip=47)
    tiff_io.write_tiff(rp, right, rows_per_strip=64)  # mismatched strips
    out = stitch_tiff(
        lp, rp, str(tmp_path / "S.TIFF"), fold, use_gdal_style=True
    )
    want = np.concatenate([left[:, : w - fold], right[:, fold:]], axis=1)
    np.testing.assert_array_equal(tiff_io.read_tiff(out), want)


def test_tiff_lzw_expansion_falls_back_uncompressed(tmp_path, rng):
    """Incompressible content would expand under LZW; the writer must
    detect it on the FIRST strip (the compression tag is file-global) and
    emit a valid uncompressed TIFF instead — the guard the round-2 review
    found dead (io/tiff.py)."""
    if not native.native_available():
        pytest.skip("native LZW unavailable")
    img = rng.integers(0, 65536, (96, 257), dtype=np.uint16)  # white noise
    p = str(tmp_path / "noise.tiff")
    tiff_io.write_tiff(
        p, img, rows_per_strip=32, compression="lzw", predictor=True
    )
    info = tiff_io.read_tiff_info(p)
    assert info.compression == tiff_io.COMPRESSION_NONE
    assert info.predictor != 2
    np.testing.assert_array_equal(tiff_io.read_tiff(p), img)
    # and the file is not larger than the raw payload + a small header
    import os

    assert os.path.getsize(p) < img.nbytes + 4096

    # compressible content keeps LZW
    p2 = str(tmp_path / "flat.tiff")
    tiff_io.write_tiff(
        p2, np.full_like(img, 1234), rows_per_strip=32,
        compression="lzw", predictor=True,
    )
    assert tiff_io.read_tiff_info(p2).compression == tiff_io.COMPRESSION_LZW


def test_stitch_tiff_band_interp_tags(tmp_path, rng):
    """band_interp tags the 4-band output like StitchTiffGDAL's
    setBandInterpretion (imageop.h:508-530): PHOTOMETRIC=RGB +
    EXTRASAMPLES=2 (unassociated alpha, GDAL's GCI_AlphaBand encoding)."""
    from opticalimageprocessor_tpu.models.stitcher import stitch_tiff

    h, w, fold = 64, 64, 8
    left = rng.integers(0, 65536, (h, w, 4), dtype=np.uint16)
    right = rng.integers(0, 65536, (h, w, 4), dtype=np.uint16)
    lp, rp = str(tmp_path / "L.TIFF"), str(tmp_path / "R.TIFF")
    tiff_io.write_tiff(lp, left)
    tiff_io.write_tiff(rp, right)
    out = stitch_tiff(
        lp, rp, str(tmp_path / "S.TIFF"), fold, band_interp=True
    )
    info = tiff_io.read_tiff_info(out)
    assert info.extrasamples == (2,)
    # default (reference's setBandInterpretion=false): unspecified
    out2 = stitch_tiff(lp, rp, str(tmp_path / "S2.TIFF"), fold)
    assert tiff_io.read_tiff_info(out2).extrasamples == (0,)
    want = np.concatenate([left[:, : w - fold], right[:, fold:]], axis=1)
    np.testing.assert_array_equal(tiff_io.read_tiff(out), want)


def test_tiff_row_count_mismatch(tmp_path, img1):
    p = str(tmp_path / "bad.tiff")
    w = tiff_io.TiffStripWriter(p, 300, 200)
    w.write_rows(img1[:100])
    with pytest.raises(ValueError):
        w.close()


def test_raw_strip_roundtrip(tmp_path, rng):
    img = rng.integers(0, 65536, (64, 128), dtype=np.uint16)
    p = str(tmp_path / "x.RAW")
    raw_io.write_raw_image(p, img)
    strip = raw_io.RawStrip(p, 128)
    assert strip.lines == 64
    np.testing.assert_array_equal(np.asarray(strip), img)
    np.testing.assert_array_equal(strip.section(10, 20), img[10:30])
    # section beyond EOF clips
    assert strip.section(60, 20).shape[0] == 4
    # negative offsets must hard-error, not wrap to the strip end
    with pytest.raises(ValueError):
        strip.section(-1, 20)
    with pytest.raises(ValueError):
        strip.section(0, -5)
    with pytest.raises(ValueError):
        raw_io.RawStrip(p, 100)  # not a whole number of lines


def test_lzw_roundtrip_sizes(rng):
    if not native.native_available():
        pytest.skip("native library unavailable")
    for n, hi in [(0, 1), (1, 256), (600, 256), (70000, 16)]:
        raw = bytes(rng.integers(0, hi, max(n, 0), dtype=np.uint8)) if n else b""
        enc = native.lzw_encode(raw)
        assert native.lzw_decode(enc, len(raw)) == raw
        # the pure-python decoder agrees
        assert native._lzw_decode_py(enc, len(raw)) == raw


def test_byteswap_and_signatures(rng):
    a = np.array([0x1234, 0xABCD], dtype=np.uint16)
    native.byteswap16(a)
    assert list(a) == [0x3412, 0xCDAB]
    buf = np.frombuffer(b"xxSIGyySIGzzSIG", dtype=np.uint8)
    assert list(native.find_signatures(buf, b"SIG")) == [2, 7, 12]


def test_deinterleave_bands_matches_numpy(rng):
    """Native band split == numpy reshape/transpose on the MSS line layout."""
    lines, bands, seg = 37, 4, 24
    inter = rng.integers(0, 65536, (lines, bands * seg), dtype=np.uint16)
    got = native.deinterleave_bands(inter, bands, seg)
    want = inter.reshape(lines, bands, seg).transpose(1, 0, 2)
    assert got.shape == (bands, lines, seg)
    np.testing.assert_array_equal(got, want)


def test_crc16_native_matches_python(rng):
    base = rng.integers(0, 256, 4096, dtype=np.uint8)
    offs = np.array([0, 100, 2000], dtype=np.int64)
    got = native.crc16_many(base, offs, 890)
    from opticalimageprocessor_tpu.formats.crc16 import crc16_ccitt_false

    for i, o in enumerate(offs):
        assert got[i] == crc16_ccitt_false(base[o : o + 890].tobytes())


def test_stage_report():
    from opticalimageprocessor_tpu.utils import logging as ulog

    ulog.reset_stage_report()
    with ulog.stage("unit_test_stage", 1024):
        pass
    rep = ulog.stage_report()
    assert "unit_test_stage" in rep
    assert rep["unit_test_stage"]["bytes"] == 1024
    assert rep["unit_test_stage"]["calls"] == 1


def test_stage_propagates_body_exception():
    """An exception inside a stage() body must surface as ITSELF.
    trace_annotation's availability guard once spanned the yield, so any
    stage error was caught there and re-yielded -- contextlib then raised
    an opaque 'generator didn't stop after throw()' RuntimeError that
    masked every real pipeline failure."""
    from opticalimageprocessor_tpu.utils import logging as ulog

    with pytest.raises(ValueError, match="the real error"):
        with ulog.stage("unit_test_fail_stage", 1):
            raise ValueError("the real error")
    # and the stage is still accounted (finally path ran)
    assert "unit_test_fail_stage" in ulog.stage_report()


def test_native_scan_aos_matches_numpy(rng):
    """The single-pass native AOS scan (oip_scan_aos) reproduces the
    vectorised numpy state machine exactly — counts, payload stream, and
    resume cursor — including corrupt-CRC, empty, and truncated frames."""
    if not native.native_available():
        pytest.skip("native library unavailable")
    from opticalimageprocessor_tpu.formats import aos

    # synthetic stream: garbage + valid/empty/corrupt frames + a
    # truncated trailing frame
    parts = [rng.integers(0, 256, 57, dtype=np.uint8).tobytes()]
    payloads = []
    for i in range(40):
        data = rng.integers(0, 256, aos.AOS_DATA_BYTES, dtype=np.uint8)
        frame = bytearray(aos.build_aos_frame(bytes(data), vcdu_seq=i))
        kind = i % 5
        if kind == 3:
            frame[aos.AOS_CRC_OFF] ^= 0xFF          # corrupt CRC
        elif kind == 4:
            frame[aos.AOS_VCID_OFF] |= aos.AOS_VCID_EMPTY
            inj = aos.AOS_VCDUINJ_INVAL
            frame[aos.AOS_VCDUINJ_OFF : aos.AOS_VCDUINJ_OFF + 4] = (
                inj.to_bytes(4, "big")
            )                                        # empty frame
        else:
            payloads.append(bytes(data))
        parts.append(bytes(frame))
        if i % 7 == 0:
            parts.append(rng.integers(0, 256, 11, dtype=np.uint8).tobytes())
    parts.append(aos.SYNC_BYTES + b"\x00" * 100)     # truncated at EOF
    buf = np.frombuffer(b"".join(parts), np.uint8)

    res = aos.scan_aos_frames(buf)
    np_payload = aos.extract_aos_payloads(buf, res.valid)
    nat = native.scan_aos(buf)
    assert nat is not None
    payload, nv, ne, ni, cursor = nat
    # the empty-frame mutation can corrupt differently per seed; compare
    # against whatever the numpy oracle says, field by field
    assert nv == res.valid.size
    assert ne == res.empty.size
    assert ni == res.invalid.size
    assert cursor == res.cursor
    np.testing.assert_array_equal(payload, np_payload)


def test_native_library_builds_from_committed_sources(tmp_path):
    """A fresh checkout has no native/build/: the loader builds it there
    from native/build.sh and the committed sources."""
    import os
    import shutil

    for name in ("build.sh", "oipnative.cpp"):
        shutil.copy(os.path.join(native._NATIVE_DIR, name), tmp_path / name)
    path = native.build_library(str(tmp_path))
    assert path == str(tmp_path / "build" / "liboipnative.so")
    assert os.listdir(tmp_path / "build") == ["liboipnative.so"]
