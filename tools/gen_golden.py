"""Generate the committed golden fixture: a tiny deterministic AOS
downlink (1 image frame), its RRC parameter files, and SHA256 hashes of
every expected output (auxsep rasters + RRC + parity remap), so DN parity
is regression-locked against artifacts rather than only against generated
data (format spec: aux_separator.h:29-138).

The image content is low-entropy (smooth ramps + sparse deterministic
speckle) so the gzipped downlink stays small enough to commit.

Run from the repo root:  python tools/gen_golden.py
Outputs to tests/golden/: golden.dat.gz, pan.rrc, expected.json
"""

import gzip
import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden",
)


def sha(arr_or_bytes) -> str:
    data = (
        arr_or_bytes
        if isinstance(arr_or_bytes, (bytes, bytearray))
        else np.ascontiguousarray(arr_or_bytes).tobytes()
    )
    return hashlib.sha256(data).hexdigest()


def main() -> None:
    from opticalimageprocessor_tpu.formats import aos, rrc_csv

    os.makedirs(OUT, exist_ok=True)

    # --- deterministic low-entropy content ------------------------------
    yy, xx = np.mgrid[0:1024, 0:12288]
    pan = ((yy * 7 + xx // 3) % 40000 + 2000).astype(np.uint16)
    my, mx = np.mgrid[0:256, 0:12288]
    mss = ((my * 13 + mx // 5) % 30000 + 1500).astype(np.uint16)
    # sparse deterministic speckle so the data isn't purely linear
    rng = np.random.default_rng(20260816)
    ys, xs = rng.integers(0, 1024, 2000), rng.integers(0, 12288, 2000)
    pan[ys, xs] = rng.integers(0, 65536, 2000).astype(np.uint16)
    mss[ys % 256, xs] = rng.integers(0, 65536, 2000).astype(np.uint16)
    aux = bytes((np.arange(aos.IMGSIG_AUX_ALLBYTES) % 251).astype(np.uint8))

    def wire(imdt_bytes: bytes) -> bytes:
        imtr = b"".join(
            aos.build_imtr_frame(pl, i + 1)
            for i, pl in enumerate(
                aos.split_stream_into_imtr_payload(imdt_bytes)
            )
        )
        return b"".join(
            aos.build_aos_frame(pl, i)
            for i, pl in enumerate(aos.split_stream_into_aos_payload(imtr))
        )

    imdt = aos.build_image_frame(pan, mss, seq=1, aux=aux)
    stream = wire(imdt)
    with gzip.open(os.path.join(OUT, "golden.dat.gz"), "wb", 9) as f:
        f.write(stream)

    # --- JP2-compressed variant: same rasters, losslessly-coded tiles ---
    # (decoding is reversible, so the expected PAN/MSS/AUX hashes are the
    # SAME as the raw fixture's — only the wire bytes differ)
    imdt_jp2 = aos.build_image_frame(pan, mss, seq=1, aux=aux, compress="jp2")
    stream_jp2 = wire(imdt_jp2)
    with gzip.open(os.path.join(OUT, "golden_jp2.dat.gz"), "wb", 9) as f:
        f.write(stream_jp2)

    # --- RRC params + expected RRC'd PAN --------------------------------
    k = 1.0 + ((np.arange(12288) % 64) - 32) / 4096.0
    b = ((np.arange(12288) % 31) - 15).astype(np.float64)
    rrc_csv.save_rrc_params(
        os.path.join(OUT, "pan.rrc"), np.stack([k, b], axis=1)
    )
    from opticalimageprocessor_tpu.ops import rrc as rrc_ops

    pan_rrc = np.asarray(
        rrc_ops.rrc_apply(
            __import__("jax.numpy", fromlist=["asarray"]).asarray(pan),
            __import__("jax.numpy", fromlist=["asarray"]).asarray(
                rrc_ops.split_rrc_params(k, b)
            ),
        )
    )

    # --- expected parity remap (plan-based, bit-exact oracle path) ------
    from opticalimageprocessor_tpu.ops import resample

    band0 = np.ascontiguousarray(mss[:, 0:3072])
    coeff_x = [1.5, 2.5e-4]
    coeff_y = [-0.75, 1.0e-4, 1.0e-8]
    remapped = np.asarray(
        resample.remap_polynomial_u16(
            __import__("jax.numpy", fromlist=["asarray"]).asarray(band0),
            coeff_x, coeff_y,
        )
    )

    expected = {
        "aos_bytes": len(stream),
        "pan_sha": sha(pan.astype("<u2")),
        "mss_sha": sha(mss.astype("<u2")),
        "aux_sha": sha(aux),
        # the .IMDT on disk is whole 866-byte payloads: the tail is
        # zero-padded to the payload boundary
        "imdt_sha": sha(
            imdt + bytes(-len(imdt) % aos.IMTR_IMGDATA_BYTES)
        ),
        "aos_jp2_bytes": len(stream_jp2),
        "pan_rrc_sha": sha(pan_rrc.astype("<u2")),
        "remap_band0_sha": sha(remapped.astype("<u2")),
        "remap_coeff_x": coeff_x,
        "remap_coeff_y": coeff_y,
    }
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
    print("golden.dat.gz:", os.path.getsize(os.path.join(OUT, "golden.dat.gz")), "bytes")
    print(json.dumps(expected, indent=1))


if __name__ == "__main__":
    main()
