"""Run the dual-CMOS scene pipeline once on a CUDA GPU and check its outputs.

    python chip_smoke.py           # every phase, on one card
    python chip_smoke.py --mesh4   # `scene --mesh 4` against the one-card
                                   # scene, on four cards

Everything runs in this one process (a second JAX process could not get
the card's memory); every command goes through ``cli.main``, the entry
point a user calls.  Phases, in order:

1. device report: platform, kind, count, the card's name and power limit,
   the path each stage takes (ops/backend), whether the native host
   library built;
2. numerics: the full uint16 RRC sweep byte-exact against the float64
   oracle; the device polynomial fit within 1e-6 px of the host float64
   fit; the registration's band side, as this backend runs it, within
   2e-3 px of the float32 plain reference at the real tile shape;
3. a synthetic scene at camera geometry: a dual-CMOS pair of
   ``LINES_PAN`` x 12288 PAN strips with a 200-column overlap, the
   matching 4-band MSS of both sensors, and an AOS downlink of CMOS1 (raw
   tiles) with CRC-corrupt frames and a missing image frame;
4. ``auxsep`` on the downlink;
5. ``scene`` resident (cold, warm, then under the profiler for the
   device's busy time);
6. ``scene --stream``;
7. the default align, ``prestitch`` and ``stitch`` commands.

A phase that fails ends the run with exit code 1.  Without a GPU, or
outside the repository, the script exits 2 and prints no result.  The
last line of standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_run")

PPL = 12288                 # PAN pixels per line
BAND_PX = PPL // 4          # MSS pixels per band line
LINES_PAN = 65536           # BASELINE config 5, bench.py's default scene
OVERLAP = 200               # CMOS overlap columns (`-c 200`)
STREAM_SECTION_LINES = 16384
SEED = 0
BAND_VY = (0, -1, 1, 0)     # constructed per-band line shifts (band px)
BAND_VX = (1, 0, -1, 2)     # constructed per-band column shifts (band px)
PAN_RRC = (1.01, -3.0)      # (gain, bias) of every PAN column
BAND_RRC = (1.02, 5.0)      # (gain, bias) of every MSS band column
DROPPED_FRAME = 7           # image-frame sequence number left out
CORR_MIN = 0.99             # per-band correlation gate
ENVELOPE_MEAN_DN = 0.05     # mean |diff| between program structures
PEAK_TOL_PX = 2e-3          # bf16 contraction vs float32 reference
FIT_TOL_PX = 1e-6           # device dd-float32 fit vs host float64


class PhaseFailed(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# --------------------------------------------------------------------------
# scene construction (numpy + the library's own upsample)
# --------------------------------------------------------------------------


def make_scene(lines_pan: int, seed: int = SEED) -> dict:
    """The ground-truth scene and both sensors' strips.

    ``scene`` (lines_pan/4, 3072) is white noise at MSS resolution; PAN1 is
    its x4 cubic upsample; PAN2 sees PAN1's last ``OVERLAP`` columns with a
    (dx=3, dy=2) mounting offset; each MSS band is the scene rolled by
    (BAND_VY, BAND_VX), CMOS2's bands roll ``scene2``, the ground under
    PAN2.  Returns uint16 arrays; MSS strips are band-interleaved lines."""
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.ops import resample

    rng = np.random.default_rng(seed)
    lines_mss = lines_pan // 4
    scene = rng.integers(2000, 42000, (lines_mss, BAND_PX), dtype=np.uint16)
    up = resample.upsample4_f32(jnp.asarray(scene, jnp.float32))
    pan1 = np.asarray(jnp.clip(jnp.rint(up), 0, 65535).astype(jnp.uint16))
    del up
    pan2 = np.roll(np.roll(pan1, 2, axis=0), OVERLAP - 3 - PPL, axis=1)
    scene2 = np.roll(scene, (OVERLAP - PPL) // 4, axis=1)

    def interleave(base):
        bands = [
            np.roll(np.roll(base, BAND_VY[b], axis=0), BAND_VX[b], axis=1)
            for b in range(4)
        ]
        return np.stack(bands, axis=1).reshape(lines_mss, PPL)

    return {
        "scene": scene, "scene2": scene2, "pan1": pan1, "pan2": pan2,
        "mss": interleave(scene), "mss2": interleave(scene2),
    }


def build_downlink(
    pan: np.ndarray, mss: np.ndarray, dropped: int = DROPPED_FRAME
) -> tuple[np.ndarray, dict]:
    """AOS downlink bytes of one sensor's PAN + MSS (raw sub-image tiles).

    Faults that lose no image data: a CRC-corrupt copy of an IMTR frame, an
    IMTR sequence jump, CRC-corrupt AOS frames and an idle frame.  One
    fault that does: image frame ``dropped`` is left out, so the separator
    zero-fills its lines.  Returns the downlink and the expected separated
    PAN and MSS rasters."""
    from opticalimageprocessor_tpu.formats import aos

    n_frames = pan.shape[0] // aos.IMGSIG_PAN_LINES
    check(1 < dropped < n_frames, f"cannot drop frame {dropped} of {n_frames}")
    want_pan, want_mss = pan.copy(), mss.copy()
    frames = []
    for i in range(n_frames):
        pl = slice(i * aos.IMGSIG_PAN_LINES, (i + 1) * aos.IMGSIG_PAN_LINES)
        ml = slice(i * aos.IMGSIG_MSS_LINES, (i + 1) * aos.IMGSIG_MSS_LINES)
        if i + 1 == dropped:
            want_pan[pl] = 0
            want_mss[ml] = 0
            continue
        frames.append(aos.build_image_frame(pan[pl], mss[ml], seq=i + 1))
    imdt = np.frombuffer(b"".join(frames), np.uint8)
    del frames

    def rows(flat, width):
        out = np.zeros((-(-flat.size // width), width), np.uint8)
        out.reshape(-1)[: flat.size] = flat
        return out

    payload = rows(imdt, aos.IMTR_IMGDATA_BYTES)
    half = payload.shape[0] // 2
    imtr_a = aos.build_imtr_stream(payload[:half], start_seq=1)
    imtr_b = aos.build_imtr_stream(payload[half:], start_seq=half + 4)
    bad_imtr = imtr_a[3].copy()
    bad_imtr[aos.IMTR_CRC_OFF] ^= 0xFF
    imtr = np.concatenate([imtr_a[:4], bad_imtr[None], imtr_a[4:], imtr_b])
    del payload, imtr_a, imtr_b

    frames_aos = aos.build_aos_stream(rows(imtr.reshape(-1), aos.AOS_DATA_BYTES))
    del imtr
    bad = frames_aos[[10, len(frames_aos) // 2]].copy()
    bad[:, aos.AOS_CRC_OFF] ^= 0x5A
    idle = np.frombuffer(aos.build_empty_aos_frame(), np.uint8)[None]
    mid = len(frames_aos) // 2
    downlink = np.concatenate([
        frames_aos[:11], bad[:1], frames_aos[11:mid], idle, bad[1:],
        frames_aos[mid:],
    ]).reshape(-1)
    return downlink, {"pan": want_pan, "mss": want_mss}


def write_inputs(sc: dict, out: str, with_downlink: bool) -> dict:
    """Write the strips, RRC tables and (optionally) the downlink."""
    from opticalimageprocessor_tpu.formats.rrc_csv import save_rrc_params

    os.makedirs(out, exist_ok=True)
    paths = {}
    for key, name in (("pan1", "C1.PAN.RAW"), ("pan2", "C2.PAN.RAW"),
                      ("mss", "C1.MSS.RAW"), ("mss2", "C2.MSS.RAW")):
        paths[key] = os.path.join(out, name)
        sc[key].astype("<u2").tofile(paths[key])
    paths["rrc_pan"] = os.path.join(out, "pan.rrc")
    save_rrc_params(paths["rrc_pan"], np.tile([PAN_RRC], (PPL, 1)))
    paths["rrc_b"] = []
    for b in range(4):
        p = os.path.join(out, f"b{b + 1}.rrc")
        save_rrc_params(p, np.tile([BAND_RRC], (BAND_PX, 1)))
        paths["rrc_b"].append(p)
    if with_downlink:
        downlink, want = build_downlink(sc["pan1"], sc["mss"])
        paths["downlink"] = os.path.join(
            out, "KASHI_TJ3-01_20220817_031259_1.dat"
        )
        downlink.tofile(paths["downlink"])
        sc["auxsep_want"] = want
    return paths


# --------------------------------------------------------------------------
# gates
# --------------------------------------------------------------------------


def band_correlations(aligned: np.ndarray, truth: np.ndarray, margin: int = 8):
    """Per-channel correlation of an aligned (rows, 3072, 4) raster with the
    scene it should reproduce, away from the borders."""
    rows = min(aligned.shape[0], truth.shape[0])
    t = truth[margin:rows - margin, margin:-margin].astype(np.float64).ravel()
    return [
        float(np.corrcoef(
            aligned[margin:rows - margin, margin:-margin, ch]
            .astype(np.float64).ravel(), t,
        )[0, 1])
        for ch in range(aligned.shape[2])
    ]


def check_correlations(name: str, aligned, truth, floor: float = CORR_MIN):
    corr = band_correlations(aligned, truth)
    log(f"  {name} per-band correlation: {[round(c, 6) for c in corr]}")
    check(min(corr) > floor, f"{name}: correlation {min(corr)} <= {floor}")


def mean_abs_diff(a: np.ndarray, b: np.ndarray) -> float:
    check(a.shape == b.shape, f"shapes differ: {a.shape} vs {b.shape}")
    return float(np.abs(a.astype(np.int32) - b.astype(np.int32)).mean())


def check_envelope(name: str, a, b) -> None:
    d = mean_abs_diff(a, b)
    log(f"  {name}: mean |diff| {d} DN")
    check(d < ENVELOPE_MEAN_DN, f"{name}: mean |diff| {d} >= {ENVELOPE_MEAN_DN}")


def rrc_expected(pan: np.ndarray, cols: int, rows_per_chunk: int = 4096):
    """The float64 oracle's RRC of ``pan[:, :cols]``, in row chunks."""
    from opticalimageprocessor_tpu.ops import cv_exact

    k = np.full(cols, PAN_RRC[0])
    b = np.full(cols, PAN_RRC[1])
    out = np.empty((pan.shape[0], cols), np.uint16)
    for r in range(0, pan.shape[0], rows_per_chunk):
        out[r:r + rows_per_chunk] = cv_exact.rrc_exact(
            pan[r:r + rows_per_chunk, :cols], k, b
        )
    return out


def aligned_rows(lines_mss: int, section_lines: int, overlap: int) -> int:
    """Rows the sectioned default align writes: sections of
    ``section_lines`` advancing by ``section_lines - overlap`` while at
    least IBPA_MIN_PROCESSLINES lines remain, each minus its overlap."""
    from opticalimageprocessor_tpu.constants import IBPA_MIN_PROCESSLINES

    offset = rows = 0
    while lines_mss - offset >= IBPA_MIN_PROCESSLINES:
        rows += min(lines_mss - offset, section_lines) - overlap
        offset += section_lines - overlap
    return rows


def result_line(device: dict) -> str:
    """The JSON object that ends a successful run."""
    return json.dumps({"ok": True, "device": device})


def device_busy_seconds(trace_dir: str) -> float | None:
    """Union of the kernel intervals on the GPU streams of a profiler trace
    (None when the trace holds no GPU stream)."""
    import jax

    paths = glob.glob(
        os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")
    )
    if not paths:
        return None
    intervals = []
    for plane in jax.profiler.ProfileData.from_file(paths[0]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                intervals += [
                    (e.start_ns, e.start_ns + e.duration_ns)
                    for e in line.events
                ]
    if not intervals:
        return None
    return union_length(intervals) / 1e9


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def nvidia_smi() -> list[str]:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]


def phase_device_report() -> dict:
    import jax

    from opticalimageprocessor_tpu.ops import backend
    from opticalimageprocessor_tpu.utils import native

    devs = jax.devices()
    d = devs[0]
    log("card (nvidia-smi name, power.limit):")
    for card in nvidia_smi():
        log(card)
    log(f"device: platform={d.platform} kind={d.device_kind} count={len(devs)}")
    log(f"stage paths: {backend.stage_paths(d.platform)}")
    log("native host library: " + (
        "built" if native.native_available() else "not built (numpy paths)"
    ))
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


def numerics_rrc() -> None:
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.ops import cv_exact, rrc

    cases = [
        (1.0, 0.0), (0.5, 0.5), (2.0, -65536.0),
        (0.9987654321, 12.3456789), (1.0123456789, -17.25),
        (3.14159265358979, -100000.5), (-0.75, 30000.0),
        (1e-9, 0.999999999), (70000.0, 0.0),
    ]
    src = np.arange(65536, dtype=np.uint16)[None, :]
    for k, b in cases:
        kk, bb = np.full(65536, k), np.full(65536, b)
        got = np.asarray(rrc.rrc_apply(
            jnp.asarray(src), jnp.asarray(rrc.split_rrc_params(kk, bb))
        ))
        bad = int((got != cv_exact.rrc_exact(src, kk, bb)).sum())
        check(bad == 0, f"RRC sweep k={k} b={b}: {bad} mismatches")
    rng = np.random.default_rng(SEED)
    src = np.tile(np.arange(65536, dtype=np.uint16)[None, :], (4, 1))
    rng.shuffle(src.T)
    k = 0.9 + 0.2 * rng.random(65536)
    b = rng.normal(0, 50, 65536)
    got = np.asarray(rrc.rrc_apply(
        jnp.asarray(src), jnp.asarray(rrc.split_rrc_params(k, b))
    ))
    bad = int((got != cv_exact.rrc_exact(src, k, b)).sum())
    check(bad == 0, f"RRC random-parameter sweep: {bad} mismatches")
    log(f"  RRC: {len(cases) + 1} full uint16 sweeps byte-exact")


def numerics_fit() -> None:
    import jax
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.models.device_pipeline import _fit_poly

    rng = np.random.default_rng(SEED)
    cx = np.tile((np.arange(10) * 1228.8 + 614.4).astype(np.float32), 5)
    true = (0.73, 2.1e-4, -3.7e-9)
    x64 = cx.astype(np.float64)
    y = (true[0] + true[1] * x64 + true[2] * x64**2
         + rng.normal(0, 0.03, cx.size)).astype(np.float32)
    w = (rng.random(cx.size) > 0.2).astype(np.float32)
    m = w > 0
    x = np.linspace(0.0, float(PPL), 2049)
    worst = 0.0
    for deg in (1, 2):
        c_dev = np.asarray(
            jax.jit(lambda a, b, c, d=deg: _fit_poly(a, b, d, c))(
                jnp.asarray(cx), jnp.asarray(y), jnp.asarray(w)
            ),
            np.float64,
        )
        v = np.vander(cx[m].astype(np.float64), deg + 1, increasing=True)
        c_host, *_ = np.linalg.lstsq(v, y[m].astype(np.float64), rcond=None)
        err = np.abs(
            sum((c_dev[i] - c_host[i]) * x**i for i in range(deg + 1))
        ).max()
        worst = max(worst, float(err))
        check(err < FIT_TOL_PX, f"degree-{deg} fit off by {err} px")
    log(f"  device fit: max |device - float64| over the strip {worst} px")


def registration_case(rng, tiles: int = 3, rows: int = 4000, cols: int = 307):
    """PAN tiles (tiles, 4*rows, 4*cols) and their 4 band tiles: band b is
    the base noise rolled by a per-tile shift, PAN the upsampled base."""
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.ops import resample

    pans, bands = [], []
    for t in range(tiles):
        base = rng.integers(2000, 42000, (rows, cols)).astype(np.float32)
        up = np.asarray(resample.upsample4_f32(jnp.asarray(base)))
        pans.append(np.roll(up, (3 * t - 2, 5 - 2 * t), axis=(0, 1)))
        bands.append(np.stack([
            np.roll(base, (BAND_VY[b], BAND_VX[b]), axis=(0, 1))
            for b in range(4)
        ]))
    return np.stack(pans), np.stack(bands)


def numerics_registration(tiles: int = 3, rows: int = 4000, cols: int = 307):
    """The registration's band side as this backend runs it (ops/backend)
    against the float32 ``Precision.HIGHEST`` plain reference, per peak,
    at the registration tile shape (16000 x 1228 PAN, 4 x 4000 x 307
    bands, 64 x 64 window)."""
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.ops import backend, phasecorr

    pans, bands = registration_case(np.random.default_rng(SEED), tiles, rows, cols)
    win = phasecorr.clamp_win((64, 64), pans.shape[1:])
    dtype = backend.band_dot_dtype()
    worst = 0.0
    for t in range(tiles):
        pan, bt = jnp.asarray(pans[t]), jnp.asarray(bands[t])
        ref = phasecorr.band_window_peaks(pan, bt, pan.shape, win, jnp.float32)
        got = phasecorr.band_window_peaks(pan, bt, pan.shape, win, dtype)
        for k in (0, 1):
            d = float(np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max())
            worst = max(worst, d)
        check(worst < PEAK_TOL_PX, f"tile {t}: peak off by {worst} px")
    log(f"  registration ({dtype} contraction): max |peak - float32 "
        f"reference| {worst} px over {tiles} tiles x 4 bands")


def run_cli(argv: list[str]) -> float:
    """One command through the user entry point; returns its wall time."""
    from opticalimageprocessor_tpu import cli

    log(f"$ oiptpu {' '.join(os.path.relpath(a, REPO) if a.startswith('/') else a for a in argv)}")
    t0 = time.perf_counter()
    rc = cli.main(argv)
    dt = time.perf_counter() - t0
    check(rc == 0, f"oiptpu {argv[0]} exited {rc}")
    log(f"  rc 0 in {dt} s")
    return dt


def read_tiff(path: str) -> np.ndarray:
    from opticalimageprocessor_tpu.io import tiff as tiff_io

    return tiff_io.read_tiff(path)


def scene_argv(p: dict, out: str, *extra: str) -> list[str]:
    argv = [
        "scene", "--pan1", p["pan1"], "--pan2", p["pan2"], "--mss", p["mss"],
        "--mss2", p["mss2"], "--rrc-pan1", p["rrc_pan"],
        "--rrc-pan2", p["rrc_pan"], "-c", str(OVERLAP),
        "-o", os.path.join(out, "stitched.RAW"), "--out-dir", out,
    ]
    for b in range(4):
        argv += [f"--rrc-msb{b + 1}", p["rrc_b"][b],
                 f"--rrc-m2b{b + 1}", p["rrc_b"][b]]
    return argv + list(extra)


def scene_outputs(out: str, lines_pan: int) -> dict:
    st_w = 2 * (PPL - OVERLAP // 2)
    return {
        "stitched": np.fromfile(
            os.path.join(out, "stitched.RAW"), "<u2"
        ).reshape(lines_pan, st_w),
        "aligned": read_tiff(os.path.join(out, "C1.MSS.ALIGNED.TIFF")),
        "aligned2": read_tiff(os.path.join(out, "C2.MSS.ALIGNED.TIFF")),
        "stitched_mss": read_tiff(os.path.join(out, "stitched-MSS.TIFF")),
    }


def check_scene(name: str, o: dict, sc: dict) -> None:
    # TIFF channel order on disk is [2,1,0,3]; every band reproduces the
    # same scene, so the order does not matter to the gate
    check_correlations(f"{name} CMOS1 aligned", o["aligned"], sc["scene"])
    check_correlations(f"{name} CMOS2 aligned", o["aligned2"], sc["scene2"])


def phase_scene_resident(p, sc, lines_pan) -> dict:
    out = os.path.join(WORK, "resident")
    os.makedirs(out)
    cold = run_cli(scene_argv(p, out))
    o = scene_outputs(out, lines_pan)
    check_scene("resident", o, sc)
    left = PPL - OVERLAP // 2
    want = rrc_expected(sc["pan1"], left)
    check(np.array_equal(o["stitched"][:, :left], want),
          "stitched PAN left half differs from RRC(CMOS1)")
    log("  stitched PAN left half == float64 RRC(CMOS1), byte for byte")
    del want

    warm_out = os.path.join(WORK, "resident_warm")
    os.makedirs(warm_out)
    warm = run_cli(scene_argv(p, warm_out))
    trace = os.path.join(WORK, "trace")
    profiled = run_cli(scene_argv(p, warm_out, "--profile", trace))
    again = np.fromfile(os.path.join(warm_out, "stitched.RAW"), "<u2")
    check(np.array_equal(again, o["stitched"].reshape(-1)),
          "a repeated resident run changed the stitched PAN")
    del again
    busy = device_busy_seconds(trace)
    log(f"  scene wall time: {cold} s cold (compiles included), {warm} s "
        f"warm, {profiled} s warm under the profiler")
    # the profiler slows the host, so the idle share is taken against the
    # warm run's wall time
    log("  scene device busy time (GPU streams, profiled run): "
        + (f"{busy} s, idle share of the warm run {1 - busy / warm}"
           if busy is not None else "not measured"))
    for card in nvidia_smi():
        log(f"  measured on: {card}")
    shutil.rmtree(warm_out)
    shutil.rmtree(trace)
    return o


def phase_scene_stream(p, sc, lines_pan, resident: dict) -> None:
    out = os.path.join(WORK, "stream")
    os.makedirs(out)
    run_cli(scene_argv(p, out, "--stream", "--stream-section-lines",
                       str(STREAM_SECTION_LINES)))
    o = scene_outputs(out, lines_pan)
    check(np.array_equal(o["stitched"], resident["stitched"]),
          "streamed stitched PAN differs from the resident run")
    log("  stitched PAN == resident, byte for byte")
    for key in ("aligned", "aligned2", "stitched_mss"):
        check_envelope(f"{key} vs resident", o[key], resident[key])
    check_scene("streamed", o, sc)
    shutil.rmtree(out)


def phase_auxsep(p, sc) -> None:
    out = os.path.join(WORK, "auxsep")
    os.makedirs(out)
    run_cli(["auxsep", p["downlink"], "--out-dir", out])
    want = sc.pop("auxsep_want")
    for key, pattern in (("mss", "*.MSS.RAW"), ("pan", "*.PAN.RAW")):
        found = glob.glob(os.path.join(out, pattern))
        check(len(found) == 1, f"auxsep wrote {found} for {pattern}")
        got = np.fromfile(found[0], "<u2").reshape(-1, PPL)
        check(np.array_equal(got, want[key]),
              f"auxsep {key.upper()}.RAW differs from the constructed data")
        log(f"  {os.path.basename(found[0])}: byte-identical "
            f"({got.shape[0]} lines, frame {DROPPED_FRAME} zero-filled)")
    shutil.rmtree(out)


def phase_align_prestitch_stitch(p, sc, lines_pan) -> None:
    out = os.path.join(WORK, "commands")
    os.makedirs(out)
    section_lines, overlap_lines = 1536, 100
    argv = ["--pan", p["pan1"], "--mss", p["mss"], "--do-rrc4pan",
            "--rrc-pan", p["rrc_pan"], "--slices", "10",
            "--ibc-sections", "1", "--lines-section", str(section_lines),
            "--overlap-lines", str(overlap_lines), "--out-dir", out]
    for b in range(4):
        argv += [f"--rrc-msb{b + 1}", p["rrc_b"][b]]
    run_cli(argv)
    aligned = read_tiff(os.path.join(out, "C1.MSS.ALIGNED.TIFF"))
    # output row r is scene row r + overlap_lines (top overlap trimmed);
    # rows past the last whole section stay unprocessed (reference parity)
    rows = aligned_rows(lines_pan // 4, section_lines, overlap_lines)
    check_correlations("default align", aligned[:rows],
                       sc["scene"][overlap_lines:])
    run_cli(["prestitch", "--pan1", p["pan1"], "--pan2", p["pan2"],
             "-s", "3", "-l", "400", "--no-rrc", "--out-dir", out])
    prestt = glob.glob(os.path.join(out, "*.PRESTT.RAW"))
    check(len(prestt) == 1, f"prestitch wrote {prestt}")
    stitched = os.path.join(out, "stitched.RAW")
    run_cli(["stitch", "--image1", p["pan1"], "--image2", prestt[0],
             "-o", stitched, "-c", str(OVERLAP)])
    width = 2 * (PPL - OVERLAP // 2)
    st = np.fromfile(stitched, "<u2")
    check(st.size == lines_pan * width, f"stitched size {st.size}")
    st = st.reshape(lines_pan, width)
    check(np.array_equal(st[:, :PPL - OVERLAP // 2],
                         sc["pan1"][:, :PPL - OVERLAP // 2]),
          "stitch left half differs from CMOS1")
    log(f"  stitched {lines_pan} x {width}; left half == CMOS1")
    shutil.rmtree(out)


def phase_mesh4(p, sc, lines_pan) -> None:
    one = os.path.join(WORK, "one_card")
    four = os.path.join(WORK, "mesh4")
    os.makedirs(one)
    os.makedirs(four)
    t1 = run_cli(scene_argv(p, one))
    t4 = run_cli(scene_argv(p, four, "--mesh", "4"))
    a = scene_outputs(one, lines_pan)
    b = scene_outputs(four, lines_pan)
    check(np.array_equal(a["stitched"], b["stitched"]),
          "mesh-4 stitched PAN differs from the one-card run")
    log("  stitched PAN: mesh 4 == one card, byte for byte")
    for key in ("aligned", "aligned2", "stitched_mss"):
        check_envelope(f"{key} mesh 4 vs one card", b[key], a[key])
    check_scene("one card", a, sc)
    check_scene("mesh 4", b, sc)
    log(f"  wall time (compiles included): one card {t1} s, "
        f"mesh 4 {t4} s")


def timed(name: str, fn, *args):
    log(f"== {name}")
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"   {name}: {time.perf_counter() - t0} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="only `scene --mesh 4` and the one-card scene")
    args = ap.parse_args(argv)
    try:
        import jax

        import opticalimageprocessor_tpu
    except ImportError as e:
        print(f"cannot import the program: {e}", file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.abspath(opticalimageprocessor_tpu.__file__))
    if os.path.dirname(pkg) != REPO:
        print(f"the program at {pkg} is not this checkout's", file=sys.stderr)
        return 2
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"no CUDA device (JAX platform {platform!r})", file=sys.stderr)
        return 2
    n_cards = 4 if args.mesh4 else 1
    if len(jax.devices()) < n_cards:
        print(f"needs {n_cards} cards, found {len(jax.devices())}",
              file=sys.stderr)
        return 2

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        device = timed("device report", phase_device_report)
        if not args.mesh4:
            log("== numerics")
            timed("RRC sweep", numerics_rrc)
            timed("device fit", numerics_fit)
            timed("registration", numerics_registration)
        sc = timed("synthesize scene", make_scene, LINES_PAN)
        p = timed("write inputs", write_inputs, sc,
                  os.path.join(WORK, "inputs"), not args.mesh4)
        if args.mesh4:
            timed("scene --mesh 4 vs one card", phase_mesh4, p, sc, LINES_PAN)
        else:
            timed("auxsep", phase_auxsep, p, sc)
            res = timed("scene (resident)", phase_scene_resident,
                        p, sc, LINES_PAN)
            timed("scene --stream", phase_scene_stream, p, sc, LINES_PAN, res)
            del res
            timed("align, prestitch, stitch", phase_align_prestitch_stitch,
                  p, sc, LINES_PAN)
    except PhaseFailed as e:
        print(f"PHASE FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(result_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
