"""Golden-fixture regression lock: a committed AOS downlink + RRC params
with SHA256-locked expected outputs.  Any DN change in the auxsep frame
parsing (format spec: aux_separator.h:29-138), the RRC truncating-cast
math, or the parity remap fails these hashes — locking parity against
artifacts, not only against generated data."""

import gzip
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(GOLDEN, "expected.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def outputs(tmp_path_factory, expected):
    from opticalimageprocessor_tpu.models.auxsep import AuxSeparator

    tmp = tmp_path_factory.mktemp("golden")
    dat = str(tmp / "KASHI_TJ3-01_20220817_031259_1.dat")
    with gzip.open(os.path.join(GOLDEN, "golden.dat.gz")) as f:
        raw = f.read()
    assert len(raw) == expected["aos_bytes"]
    with open(dat, "wb") as g:
        g.write(raw)
    sep = AuxSeparator(dat, out_dir=str(tmp))
    return sep.separate() | {"imdt": sep.imdt_file}


def _sha_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _sha(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def test_golden_auxsep_outputs(outputs, expected):
    assert _sha_file(outputs["pan"]) == expected["pan_sha"]
    assert _sha_file(outputs["mss"]) == expected["mss_sha"]
    assert _sha_file(outputs["aux"]) == expected["aux_sha"]
    assert _sha_file(outputs["imdt"]) == expected["imdt_sha"]


def test_golden_rrc(outputs, expected):
    from opticalimageprocessor_tpu.formats import rrc_csv
    from opticalimageprocessor_tpu.ops import rrc

    pan = np.fromfile(outputs["pan"], dtype="<u2").reshape(-1, 12288)
    kb = rrc_csv.load_rrc_params(os.path.join(GOLDEN, "pan.rrc"), 12288)
    out = np.asarray(
        rrc.rrc_apply(
            jnp.asarray(pan),
            jnp.asarray(rrc.split_rrc_params(kb[:, 0], kb[:, 1])),
        )
    )
    assert _sha(out.astype("<u2")) == expected["pan_rrc_sha"]


def test_golden_parity_remap(outputs, expected):
    from opticalimageprocessor_tpu.ops import resample

    mss = np.fromfile(outputs["mss"], dtype="<u2").reshape(-1, 12288)
    band0 = np.ascontiguousarray(mss[:, 0:3072])
    out = np.asarray(
        resample.remap_polynomial_u16(
            jnp.asarray(band0),
            expected["remap_coeff_x"],
            expected["remap_coeff_y"],
        )
    )
    assert _sha(out.astype("<u2")) == expected["remap_band0_sha"]


@pytest.mark.parametrize("backend", ["cv2", "pil"])
def test_golden_jp2_downlink(tmp_path, expected, backend, monkeypatch):
    """The committed JP2-COMPRESSED downlink (losslessly-coded tiles,
    aux_separator.h:374-393's codec path) must decode to the SAME rasters
    as the raw-tile fixture — under both JP2 backends (the reference's
    own cv2, and the Pillow/OpenJPEG fallback that removes the last hard
    OpenCV dependency)."""
    pytest.importorskip("cv2" if backend == "cv2" else "PIL")
    if backend == "pil":
        from PIL import features

        if not features.check("jpg_2000"):
            pytest.skip("Pillow built without OpenJPEG")
    from opticalimageprocessor_tpu.models.auxsep import AuxSeparator

    monkeypatch.setenv("OIP_JP2_BACKEND", backend)
    dat = str(tmp_path / "KASHI_TJ3-01_20220817_031259_1.dat")
    with gzip.open(os.path.join(GOLDEN, "golden_jp2.dat.gz")) as f:
        raw = f.read()
    assert len(raw) == expected["aos_jp2_bytes"]
    with open(dat, "wb") as g:
        g.write(raw)
    outs = AuxSeparator(dat, out_dir=str(tmp_path)).separate()
    assert _sha_file(outs["pan"]) == expected["pan_sha"]
    assert _sha_file(outs["mss"]) == expected["mss_sha"]
    assert _sha_file(outs["aux"]) == expected["aux_sha"]
