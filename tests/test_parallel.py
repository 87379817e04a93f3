"""Multi-device tests on the virtual 8-device CPU mesh: halo exchange
correctness and sharded-vs-single-device pipeline consistency."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from opticalimageprocessor_tpu.parallel import halo, mesh as mesh_lib, sharded

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_exchange_halo_matches_concat(rng):
    m = mesh_lib.line_mesh(8)
    x = rng.random((64, 16), dtype=np.float32)
    top, bottom = 3, 2

    def local(xl):
        return halo.exchange_halo(xl, top, bottom, "line")

    out = jax.jit(
        jax.shard_map(
            local, mesh=m, in_specs=P("line", None),
            out_specs=P("line", None), check_vma=False,
        )
    )(x)
    out = np.asarray(out)
    # each shard's extended block stacked: verify shard 3's halo rows
    rows_local = 64 // 8
    blk = out.reshape(8, rows_local + top + bottom, 16)
    for d in range(8):
        want_top = (
            x[d * rows_local - top : d * rows_local]
            if d > 0
            else np.zeros((top, 16), np.float32)
        )
        want_bot = (
            x[(d + 1) * rows_local : (d + 1) * rows_local + bottom]
            if d < 7
            else np.zeros((bottom, 16), np.float32)
        )
        np.testing.assert_array_equal(blk[d, :top], want_top)
        np.testing.assert_array_equal(blk[d, top : top + rows_local],
                                      x[d * rows_local : (d + 1) * rows_local])
        np.testing.assert_array_equal(blk[d, top + rows_local :], want_bot)


def test_remap_dynamic_sharded_matches_single(rng):
    """The halo-exchanged sharded remap equals the single-shard whole-strip
    remap (interior and edges: border-0 at strip ends either way)."""
    rows, width = 128, 64
    band = rng.integers(0, 65536, (rows, width), dtype=np.uint16)
    cx = jnp.asarray([1.25, 2e-4], jnp.float32)
    cy = jnp.asarray([-0.5, 1e-4, 2e-8], jnp.float32)

    single = np.asarray(
        jax.jit(
            lambda b: sharded.remap_band_dynamic(b, cx, cy, 0, None)
        )(band)
    )

    m = mesh_lib.line_mesh(8)

    def local(bl):
        idx = jax.lax.axis_index("line")
        y0 = idx.astype(jnp.int32) * (rows // 8)
        return sharded.remap_band_dynamic(bl, cx, cy, y0, "line")

    multi = np.asarray(
        jax.jit(
            jax.shard_map(
                local, mesh=m, in_specs=P("line", None),
                out_specs=P("line", None), check_vma=False,
            )
        )(band)
    )
    np.testing.assert_array_equal(multi, single)


def test_remap_dynamic_matches_static_plan(rng):
    """Dynamic (traced-coefficient) remap agrees with the host-planned
    static remap used by the parity pipeline (same f32 math)."""
    from opticalimageprocessor_tpu.ops import resample

    rows, width = 96, 64
    band = rng.integers(0, 65536, (rows, width), dtype=np.uint16)
    cxv = [0.75, -3e-4]
    cyv = [1.25, -2e-4, 1e-8]
    want = np.asarray(
        resample.remap_polynomial_u16(jnp.asarray(band), cxv, cyv)
    )
    got = np.asarray(
        sharded.remap_band_dynamic(
            jnp.asarray(band),
            jnp.asarray(cxv, jnp.float32),
            jnp.asarray(cyv, jnp.float32),
            0,
            None,
        )
    )
    diff = np.abs(want.astype(int) - got.astype(int))
    # static plan computes maps in float64-then-cast and accumulates in the
    # oracle's grouped order; the fast path is all-f32 with a
    # column matmul -> last-ulp differences flip rounding on a few % of
    # pixels, never beyond 1 DN
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.05


def test_align_step_matches_host_preprocessor(rng, tmp_path):
    """The 8-device align step reproduces the host PreProcessor on the same
    scene: identical float64-fitted coefficients (same samples, same
    filter+fit code path) and an aligned raster within 1 DN of the host
    fast-mode remap."""
    from opticalimageprocessor_tpu.formats import rrc_csv
    from opticalimageprocessor_tpu.models.preprocessor import PreProcessor
    from opticalimageprocessor_tpu.ops import resample, rrc

    width, band_px = 512, 128
    lines_mss = 1504          # >= IBPA_MIN_PROCESSLINES, divisible by 8
    lines_pan = lines_mss * 4
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan_true = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    vy = [0, -1, 1, 0]
    vx = [1, 0, -1, 2]
    bands = np.stack(
        [np.roll(np.roll(scene, vy[b], 0), vx[b], 1) for b in range(4)]
    )

    # inverse-RRC both sensors so the RRC stage does real work
    kp, bp = 1.02, -100.0
    pan_dl = np.clip(
        np.rint((pan_true.astype(np.float64) - bp) / kp), 0, 65535
    ).astype(np.uint16)
    kb, bb = 0.98, 50.0
    bands_dl = np.clip(
        np.rint((bands.astype(np.float64) - bb) / kb), 0, 65535
    ).astype(np.uint16)

    pan_path = tmp_path / "CMOS1.PAN.RAW"
    mss_path = tmp_path / "CMOS1.MSS.RAW"
    pan_dl.astype("<u2").tofile(pan_path)
    np.ascontiguousarray(bands_dl.transpose(1, 0, 2)).astype("<u2").tofile(
        mss_path
    )
    rrc_pan = tmp_path / "pan.rrc"
    rrc_csv.save_rrc_params(str(rrc_pan), np.tile([[kp, bp]], (width, 1)))
    rrc_band = tmp_path / "band.rrc"
    rrc_csv.save_rrc_params(str(rrc_band), np.tile([[kb, bb]], (band_px, 1)))

    # --- host reference path (fast-mode remap, full rows kept)
    pp = PreProcessor(
        str(pan_path), str(mss_path), str(rrc_pan), (str(rrc_band),) * 4,
        pixels_per_line=width, fast=True,
    )
    pp.load_and_rrc(do_rrc_pan=True, do_rrc_mss=True)
    pp.calc_inter_band_correlation(slices=8, sections=1)
    host_aligned = pp.do_inter_band_alignment(
        line_per_section=1504, keep_leading_lines=True, write_tiff=False,
    )

    # --- 8-device sharded path on the same inputs
    m = mesh_lib.line_mesh(8)
    step = sharded.make_align_step(m, slices=8, sections=1)
    pan_params = jnp.asarray(
        rrc.split_rrc_params(np.full(width, kp), np.full(width, bp))
    )
    mss_params = jnp.asarray(
        np.stack(
            [rrc.split_rrc_params(np.full(band_px, kb), np.full(band_px, bb))]
            * 4
        )
    )
    aligned, cx, cy = step(pan_dl, bands_dl, pan_params, mss_params)

    np.testing.assert_allclose(cx, pp.coeff_x, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(cy, pp.coeff_y, rtol=1e-6, atol=1e-7)
    diff = np.abs(
        np.asarray(aligned).astype(int) - host_aligned.astype(int)
    )
    assert diff.max() <= 1, diff.max()


def test_align_step_min_count_error(rng):
    """Flat tiles produce no valid (response >= 0.4) samples; the sharded
    step must fail with the reference's min-count error, not fit garbage."""
    from opticalimageprocessor_tpu.ops import rrc

    width, band_px = 512, 128
    lines_mss, lines_pan = 64, 256
    pan = np.full((lines_pan, width), 9000, np.uint16)
    mss = np.full((4, lines_mss, band_px), 9000, np.uint16)
    pan_params = jnp.asarray(
        rrc.split_rrc_params(np.ones(width), np.zeros(width))
    )
    mss_params = jnp.asarray(
        np.stack(
            [rrc.split_rrc_params(np.ones(band_px), np.zeros(band_px))] * 4
        )
    )
    m = mesh_lib.line_mesh(8)
    step = sharded.make_align_step(m, slices=8, sections=1)
    with pytest.raises(RuntimeError, match="Not enough valid correlation"):
        step(pan, mss, pan_params, mss_params)


def test_two_process_align_matches_single(tmp_path):
    """Multi-process launch path: two spawned processes, 4 virtual CPU
    devices each, join one 8-device 'line' mesh via OIP_DIST_* env +
    jax.distributed and run the sharded align step with per-host shard
    ingest.  The replicated fit coefficients and the reassembled aligned
    raster must match this process's single-process 8-device run."""
    import socket
    import subprocess
    import sys as _sys

    from jax.sharding import PartitionSpec as P

    import dist_worker

    # single-process reference on this process's own 8-device mesh
    pan, mss, pan_params, mss_params = dist_worker.make_inputs()
    m = mesh_lib.line_mesh(8)
    pan_s = sharded.ingest_line_sharded(m, pan, pan.shape[0], 0,
                                        P("line", None))
    mss_s = sharded.ingest_line_sharded(m, mss, mss.shape[1], 1,
                                        P(None, "line", None))
    step = sharded.make_align_step(m, slices=8, sections=1)
    aligned_1, cx_1, cy_1 = step(pan_s, mss_s, pan_params, mss_params)

    with socket.socket() as s:  # free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outdir = str(tmp_path)
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(worker))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [_sys.executable, worker, str(i), "2", str(port), outdir],
            env=env,
        )
        for i in range(2)
    ]
    try:
        for p in procs:
            assert p.wait(timeout=600) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert os.path.exists(os.path.join(tmp_path, "DONE"))

    # XLA:CPU codegen depends on --xla_force_host_platform_device_count
    # (4 per worker vs 8 here — docs/NUMERICS.md "program structures"), so
    # the gate is the documented white-noise envelope, not bit equality.
    # Individual polynomial coefficients are correlated (intercept/slope
    # trade off), so compare the EVALUATED shift curves over the raster
    # extent — the quantity the resample consumes — to the cv2-e2e gate.
    width, rows = pan.shape[1], mss.shape[1]
    xs = np.arange(width, dtype=np.float64)
    ys = np.arange(rows, dtype=np.float64)
    for pid in range(2):
        cx_w = np.load(tmp_path / f"cx_{pid}.npy")
        cy_w = np.load(tmp_path / f"cy_{pid}.npy")
        for b in range(4):
            dx_curve = np.polyval(cx_w[b][::-1], xs) - np.polyval(
                np.asarray(cx_1)[b][::-1], xs
            )
            dy_curve = np.polyval(cy_w[b][::-1], ys) - np.polyval(
                np.asarray(cy_1)[b][::-1], ys
            )
            assert np.abs(dx_curve).max() < 5e-3, (b, np.abs(dx_curve).max())
            assert np.abs(dy_curve).max() < 5e-3, (b, np.abs(dy_curve).max())
    shards = sorted(tmp_path.glob("aligned_r*.npy"))
    assert len(shards) == 8
    got = np.concatenate([np.load(p) for p in shards], axis=0)
    want = np.asarray(aligned_1)
    assert got.shape == want.shape
    # sub-millipixel fit wobble flips rint on many pixels (small DN each)
    # — bound the envelope, not bits
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.mean() < 1.0 and diff.max() <= 8, (diff.mean(), diff.max())

    # the multi-host drain (each process row-offset-writes its own shards
    # into one shared file) must reproduce the ingested strip exactly
    drained = np.fromfile(tmp_path / "pan_drained.RAW", "<u2").reshape(
        pan.shape
    )
    np.testing.assert_array_equal(drained, pan)

    # the multi-host COMPRESSED drain (per-process strip LZW + process-0
    # assembly) moves bytes only, so unlike the registration outputs it
    # must be BYTE-identical to the sequential single-process writer
    from opticalimageprocessor_tpu.io import tiff as tiff_io

    ramp = dist_worker.lzw_fixture()
    seq_path = str(tmp_path / "ramp_lzw_seq.TIFF")
    w = tiff_io.TiffStripWriter(
        seq_path, ramp.shape[1], ramp.shape[0] - 17, 4,
        rows_per_strip=64, compression="lzw", predictor=True,
    )
    w.write_rows(ramp[17:][:, :, [2, 1, 0, 3]])
    w.close()
    with open(tmp_path / "ramp_lzw.TIFF", "rb") as fa, open(
        seq_path, "rb"
    ) as fb:
        assert fa.read() == fb.read()


def test_two_process_align_e2e_tiff_drains(tmp_path):
    """Full multi-host run_sharded_align across two spawned processes:
    file ingest, SPMD step, and the shared-file TIFF drains (each process
    row-offset-writes its own shards).  The RRC'ed PAN TIFF must be
    byte-identical to a single-process run (RRC is fit-independent,
    byte-exact math); the ALIGNED TIFF matches within the documented
    cross-device-count envelope."""
    import socket
    import subprocess
    import sys as _sys

    from opticalimageprocessor_tpu.formats import rrc_csv
    from opticalimageprocessor_tpu.io import tiff as tiff_io
    from opticalimageprocessor_tpu.models.sharded_align import (
        run_sharded_align,
    )
    from opticalimageprocessor_tpu.ops import resample

    rng = np.random.default_rng(31)
    width, band_px = 512, 128
    lines_mss = 1536
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan_true = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    kp, bp = 1.02, -100.0
    pan_dl = np.clip(
        np.rint((pan_true.astype(np.float64) - bp) / kp), 0, 65535
    ).astype(np.uint16)
    bands = [np.roll(scene, b % 2, axis=1) for b in range(4)]
    mss = np.stack(bands, axis=1).reshape(lines_mss, width)
    pan_dl.astype("<u2").tofile(tmp_path / "P.PAN.RAW")
    mss.astype("<u2").tofile(tmp_path / "P.MSS.RAW")
    rrc_csv.save_rrc_params(
        str(tmp_path / "pan.rrc"), np.tile([[kp, bp]], (width, 1))
    )
    for i in range(1, 5):
        rrc_csv.save_rrc_params(
            str(tmp_path / f"b{i}.rrc"), np.tile([[1.0, 0.0]], (band_px, 1))
        )

    kwargs = dict(
        rrc_pan_file=str(tmp_path / "pan.rrc"),
        rrc_mss_files=tuple(
            str(tmp_path / f"b{i}.rrc") for i in range(1, 5)
        ),
        do_rrc_pan=True, slices=8, sections=1, section_overlap=64,
        pixels_per_line=width, write_rrcpan=True,
    )
    os.makedirs(tmp_path / "out_single", exist_ok=True)
    single_path = run_sharded_align(
        str(tmp_path / "P.PAN.RAW"), str(tmp_path / "P.MSS.RAW"),
        out_dir=str(tmp_path / "out_single"), **kwargs,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.makedirs(tmp_path / "out_multi", exist_ok=True)
    worker = os.path.join(os.path.dirname(__file__), "dist_align_worker.py")
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(worker))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [_sys.executable, worker, str(i), "2", str(port),
             str(tmp_path)],
            env=env,
        )
        for i in range(2)
    ]
    try:
        for p in procs:
            assert p.wait(timeout=600) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    # RRC'ed PAN: byte-identical (fit-independent, byte-exact RRC)
    rrc_single = tiff_io.read_tiff(
        str(tmp_path / "out_single" / "P.PAN.RRC.TIFF")
    )
    rrc_multi = tiff_io.read_tiff(
        str(tmp_path / "out_multi" / "P.PAN.RRC.TIFF")
    )
    np.testing.assert_array_equal(rrc_multi, rrc_single)

    # ALIGNED: the cross-device-count fit envelope (see
    # test_two_process_align_matches_single)
    a_single = tiff_io.read_tiff(single_path)
    a_multi = tiff_io.read_tiff(
        str(tmp_path / "out_multi" / os.path.basename(single_path))
    )
    assert a_multi.shape == a_single.shape
    diff = np.abs(a_multi.astype(np.int64) - a_single.astype(np.int64))
    assert diff.mean() < 1.0 and diff.max() <= 8, (diff.mean(), diff.max())

    # write_tiff=False multi-host: the replicate-gather returns the SAME
    # full array on every process (byte-equal across processes), matching
    # this process's run within the cross-device-count envelope
    g0 = np.load(tmp_path / "gathered_0.npy")
    g1 = np.load(tmp_path / "gathered_1.npy")
    np.testing.assert_array_equal(g0, g1)
    arr_single = run_sharded_align(
        str(tmp_path / "P.PAN.RAW"), str(tmp_path / "P.MSS.RAW"),
        write_tiff=False, **{**kwargs, "write_rrcpan": False},
    )
    assert g0.shape == arr_single.shape
    diff = np.abs(g0.astype(np.int64) - arr_single.astype(np.int64))
    assert diff.mean() < 1.0 and diff.max() <= 8, (diff.mean(), diff.max())


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (512, 3072) and out.dtype == jnp.uint16


def test_sharded_prestitch_matches_host(tmp_path, rng):
    """The --mesh prestitch route: stt deltas match the host Stitcher's
    exactly (same tile math) and the sharded constant-shift remap matches
    the host fast remap within 1 DN."""
    from opticalimageprocessor_tpu.models import stitcher as st
    from opticalimageprocessor_tpu.models.sharded_prestitch import (
        run_sharded_prestitch,
    )

    ppl, lines, overlap = 1024, 640, 64
    terrain = rng.integers(2000, 42000, (lines + 16, ppl * 2)).astype(
        np.uint16
    )
    pan1 = terrain[4 : 4 + lines, :ppl]
    pan2 = terrain[6 : 6 + lines, ppl - overlap + 3 : 2 * ppl - overlap + 3]
    p1 = str(tmp_path / "c1.PAN.RAW")
    p2 = str(tmp_path / "c2.PAN.RAW")
    pan1.astype("<u2").tofile(p1)
    pan2.astype("<u2").tofile(p2)

    host_dir = tmp_path / "host"
    host_dir.mkdir()
    s = st.Stitcher(
        p1, p2, sections=3, line_per_section=128, overlap_cols=overlap,
        out_dir=str(host_dir), pixels_per_line=ppl, fast=True,
    )
    s.calc_stt_parameters(threshold=0.05)
    s.pre_stitch()
    host_out = np.fromfile(s.prestt_file_pan2, dtype="<u2").reshape(-1, ppl)

    mesh_dir = tmp_path / "mesh"
    mesh_dir.mkdir()
    dx, dy, prestt_path = run_sharded_prestitch(
        p1, p2, n_devices=8, sections=3, line_per_section=128,
        overlap_cols=overlap, threshold=0.05, do_rrc=False,
        out_dir=str(mesh_dir), pixels_per_line=ppl,
    )
    assert abs(dx - s.delta_x) < 1e-4
    assert abs(dy - s.delta_y) < 1e-4
    got = np.fromfile(prestt_path, dtype="<u2").reshape(-1, ppl)
    n = min(got.shape[0], host_out.shape[0])
    d = np.abs(
        got[:n].astype(np.int32) - host_out[:n].astype(np.int32)
    )
    assert d.max() <= 1, d.max()


def test_sharded_prestitch_no_valid_delta(tmp_path):
    """Flat strips produce no valid correlation -> the reference's error."""
    from opticalimageprocessor_tpu.models.sharded_prestitch import (
        run_sharded_prestitch,
    )

    ppl, lines = 1024, 512
    flat = np.full((lines, ppl), 9000, np.uint16)
    p1 = str(tmp_path / "f1.PAN.RAW")
    p2 = str(tmp_path / "f2.PAN.RAW")
    flat.astype("<u2").tofile(p1)
    flat.astype("<u2").tofile(p2)
    with pytest.raises(RuntimeError, match="No valid delta value found"):
        run_sharded_prestitch(
            p1, p2, n_devices=8, sections=3, line_per_section=128,
            overlap_cols=64, threshold=0.9, do_rrc=False,
            out_dir=str(tmp_path), pixels_per_line=ppl,
        )


def test_sharded_scene_matches_single_device(rng):
    """The SPMD fused scene pipeline (parallel/sharded_scene, the CLI's
    ``scene --mesh N``) reproduces the single-chip flagship
    (models/device_pipeline.make_device_pipeline): stitched PAN
    byte-identical, aligned raster within 1 DN (fit rounding at chunk/shard
    seams), validity counts equal."""
    from opticalimageprocessor_tpu.models.device_pipeline import (
        check_registration_valid,
        check_stt_valid,
        make_device_pipeline,
    )
    from opticalimageprocessor_tpu.ops import resample, rrc
    from opticalimageprocessor_tpu.parallel.sharded_scene import (
        make_sharded_scene_fn,
    )

    lines_pan, width, ov = 1024, 640, 32
    lines_mss, band_px = lines_pan // 4, width // 4
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan1 = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    pan2 = np.roll(np.roll(pan1, 2, axis=0), ov - 3 - width, axis=1)
    mss = np.stack(
        [np.roll(np.roll(scene, b % 2, 0), b - 1, 1) for b in range(4)]
    )
    pp = jnp.asarray(rrc.split_rrc_params(np.ones(width), np.zeros(width)))
    mp = jnp.asarray(
        np.stack([rrc.split_rrc_params(np.ones(band_px), np.zeros(band_px))] * 4)
    )

    kw = dict(slices=8, fold=ov // 2, stt_sections=2, overlap_cols=ov)
    a1, s1, nv1, ns1, prm1 = make_device_pipeline(**kw)(
        jnp.asarray(pan1), jnp.asarray(pan2), jnp.asarray(mss), pp, pp, mp
    )
    check_registration_valid(np.asarray(nv1))
    check_stt_valid(np.asarray(ns1))

    m = mesh_lib.line_mesh(8)
    fn = make_sharded_scene_fn(m, lines_pan, width, **kw)
    l2 = NamedSharding(m, P("line", None))
    l3 = NamedSharding(m, P(None, "line", None))
    a2, s2, nv2, ns2, prm2 = fn(
        jax.device_put(pan1, l2), jax.device_put(pan2, l2),
        jax.device_put(mss, l3), pp, pp, mp,
    )
    assert np.array_equal(np.asarray(nv1), np.asarray(nv2))
    assert int(ns1) == int(ns2)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    d = np.abs(
        np.asarray(a1).astype(np.int32) - np.asarray(a2).astype(np.int32)
    )
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def test_scene_cli_mesh_matches_single(tmp_path, rng):
    """End-to-end ``scene --mesh 8`` through run_scene (sharded ingest +
    shard-by-shard drain): output files equal the single-device scene run
    within the fast-mode envelope (stitched byte-identical, aligned <=1 DN).
    1200 lines does NOT divide the 8-device mesh at MSS scale, covering the
    zero-pad/mask/trim strip-length contract end to end."""
    from opticalimageprocessor_tpu.formats.rrc_csv import save_rrc_params
    from opticalimageprocessor_tpu.io import tiff as tiff_io
    from opticalimageprocessor_tpu.models.scene import run_scene
    from opticalimageprocessor_tpu.ops import resample

    lines_pan, width, ov = 1200, 640, 32
    lines_mss, band_px = lines_pan // 4, width // 4
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan1 = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    pan2 = np.roll(np.roll(pan1, 2, axis=0), ov - 3 - width, axis=1)
    mss = np.stack(
        [np.roll(scene, b - 1, 1) for b in range(4)], axis=1
    ).reshape(lines_mss, width)

    p1 = str(tmp_path / "C1.PAN.RAW")
    p2 = str(tmp_path / "C2.PAN.RAW")
    ms = str(tmp_path / "C1.MSS.RAW")
    ms2 = str(tmp_path / "C2.MSS.RAW")
    pan1.astype("<u2").tofile(p1)
    pan2.astype("<u2").tofile(p2)
    mss.astype("<u2").tofile(ms)
    # CMOS2 MSS (exercises the sharded mss2 align + MSS-pair stitch)
    mss2 = np.stack(
        [np.roll(scene, b, 1) for b in range(4)], axis=1
    ).reshape(lines_mss, width)
    mss2.astype("<u2").tofile(ms2)
    rrc_pan = str(tmp_path / "pan.rrc")
    save_rrc_params(rrc_pan, np.tile([[1.01, -3.0]], (width, 1)))

    out_a = tmp_path / "single"
    out_b = tmp_path / "meshed"
    out_a.mkdir()
    out_b.mkdir()
    kw = dict(
        rrc_pan1=rrc_pan, rrc_pan2=rrc_pan, slices=8, fold_cols=ov,
        stt_sections=2, pixels_per_line=width, mss2_file=ms2,
    )
    o1 = run_scene(p1, p2, ms, out_dir=str(out_a), **kw)
    o2 = run_scene(p1, p2, ms, out_dir=str(out_b), mesh=8, **kw)
    st1 = tiff_io.read_tiff(o1["stitched"])
    st2 = tiff_io.read_tiff(o2["stitched"])
    np.testing.assert_array_equal(st1, st2)
    for key in ("aligned", "aligned2", "stitched_mss"):
        a1 = tiff_io.read_tiff(o1[key]).astype(np.int32)
        a2 = tiff_io.read_tiff(o2[key]).astype(np.int32)
        d = np.abs(a1 - a2)
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (
            key, d.max(), (d > 0).mean(),
        )


def test_two_process_scene_e2e_drains(tmp_path, rng):
    """Full multi-host flagship ``scene --mesh`` across two spawned
    processes: shard ingest, the fused SPMD scene step, the CMOS2 MSS
    align, and ALL multi-host output drains (ALIGNED + stitched-MSS TIFFs
    via offset writes, stitched PAN via the RAW drain) into shared files.

    The stitched LEFT half is pure RRC of PAN1 (registration-free,
    byte-exact math) so it must be byte-identical to the single-process
    run; registration-dependent pixels (stitch right half, the ALIGNED
    rasters) carry the documented cross-device-count envelope — on this
    rig byte-identity there is impossible by construction: the 2-process
    run reduces shift statistics through cross-process Gloo collectives
    whose summation order differs from the in-process 8-device build
    (docs/NUMERICS.md "program structures")."""
    import socket
    import subprocess
    import sys as _sys

    from opticalimageprocessor_tpu.formats.rrc_csv import save_rrc_params
    from opticalimageprocessor_tpu.io import tiff as tiff_io
    from opticalimageprocessor_tpu.models.scene import run_scene
    from opticalimageprocessor_tpu.ops import resample

    # same construction/geometry as test_scene_cli_mesh_matches_single
    # (shapes shared with it -> in-process jit cache reuse when the module
    # runs whole)
    lines_pan, width, ov = 1200, 640, 32
    lines_mss = lines_pan // 4
    scene = rng.integers(2000, 42000, (lines_mss, width // 4)).astype(
        np.uint16
    )
    pan1 = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    pan2 = np.roll(np.roll(pan1, 2, axis=0), ov - 3 - width, axis=1)
    mss = np.stack(
        [np.roll(scene, b - 1, 1) for b in range(4)], axis=1
    ).reshape(lines_mss, width)
    mss2 = np.stack(
        [np.roll(scene, b, 1) for b in range(4)], axis=1
    ).reshape(lines_mss, width)
    pan1.astype("<u2").tofile(tmp_path / "C1.PAN.RAW")
    pan2.astype("<u2").tofile(tmp_path / "C2.PAN.RAW")
    mss.astype("<u2").tofile(tmp_path / "C1.MSS.RAW")
    mss2.astype("<u2").tofile(tmp_path / "C2.MSS.RAW")
    save_rrc_params(
        str(tmp_path / "pan.rrc"), np.tile([[1.01, -3.0]], (width, 1))
    )

    kw = dict(
        rrc_pan1=str(tmp_path / "pan.rrc"),
        rrc_pan2=str(tmp_path / "pan.rrc"),
        mss2_file=str(tmp_path / "C2.MSS.RAW"),
        slices=8, fold_cols=ov, stt_sections=2, pixels_per_line=width,
    )
    os.makedirs(tmp_path / "out_single")
    o1 = run_scene(
        str(tmp_path / "C1.PAN.RAW"), str(tmp_path / "C2.PAN.RAW"),
        str(tmp_path / "C1.MSS.RAW"), out_dir=str(tmp_path / "out_single"),
        out_stitched=str(tmp_path / "out_single" / "stitched.RAW"),
        mesh=8, **kw,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.makedirs(tmp_path / "out_multi")
    worker = os.path.join(os.path.dirname(__file__), "dist_scene_worker.py")
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(worker))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [_sys.executable, worker, str(i), "2", str(port),
             str(tmp_path)],
            env=env,
        )
        for i in range(2)
    ]
    try:
        for p in procs:
            assert p.wait(timeout=600) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    half = width - ov // 2
    st1 = np.fromfile(o1["stitched"], "<u2").reshape(lines_pan, 2 * half)
    st2 = np.fromfile(
        tmp_path / "out_multi" / "stitched.RAW", "<u2"
    ).reshape(lines_pan, 2 * half)
    np.testing.assert_array_equal(st2[:, :half], st1[:, :half])
    d = np.abs(st2.astype(np.int64) - st1.astype(np.int64))
    assert d.mean() < 1.0 and d.max() <= 8, (d.mean(), d.max())
    for key in ("aligned", "aligned2", "stitched_mss"):
        a1 = tiff_io.read_tiff(o1[key]).astype(np.int64)
        a2 = tiff_io.read_tiff(
            str(tmp_path / "out_multi" / os.path.basename(o1[key]))
        ).astype(np.int64)
        assert a1.shape == a2.shape, key
        d = np.abs(a1 - a2)
        assert d.mean() < 1.0 and d.max() <= 8, (key, d.mean(), d.max())


def test_mesh_quantized_and_rrcpan_match_host(rng, tmp_path):
    """The lifted --mesh restrictions: --coord-mode quantized routes the
    sharded resample through the parity-grade plan kernel (OpenCV <=4.x
    1/32-px grid, whole-image maps), and --write-rrcpan drains the
    line-sharded corrected PAN to the reference's RRC TIFF — both match
    the host PreProcessor on the same scene."""
    from opticalimageprocessor_tpu.formats import rrc_csv
    from opticalimageprocessor_tpu.io import tiff as tiff_io
    from opticalimageprocessor_tpu.models.preprocessor import PreProcessor
    from opticalimageprocessor_tpu.models.sharded_align import (
        run_sharded_align,
    )
    from opticalimageprocessor_tpu.ops import resample

    width, band_px = 512, 128
    lines_mss = 1504
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan_true = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    bands = np.stack([np.roll(scene, b - 1, 1) for b in range(4)])
    kp, bp = 1.02, -100.0
    pan_dl = np.clip(
        np.rint((pan_true.astype(np.float64) - bp) / kp), 0, 65535
    ).astype(np.uint16)

    pan_path = tmp_path / "C1.PAN.RAW"
    mss_path = tmp_path / "C1.MSS.RAW"
    pan_dl.astype("<u2").tofile(pan_path)
    np.ascontiguousarray(bands.transpose(1, 0, 2)).astype("<u2").tofile(
        mss_path
    )
    rrc_pan = tmp_path / "pan.rrc"
    rrc_csv.save_rrc_params(str(rrc_pan), np.tile([[kp, bp]], (width, 1)))
    rrc_band = tmp_path / "band.rrc"
    rrc_csv.save_rrc_params(
        str(rrc_band), np.tile([[1.0, 0.0]], (band_px, 1))
    )

    pp = PreProcessor(
        str(pan_path), str(mss_path), str(rrc_pan), (str(rrc_band),) * 4,
        pixels_per_line=width, fast=False, quantized_coords=True,
        out_dir=str(tmp_path),
    )
    pp.load_and_rrc(do_rrc_pan=True, do_rrc_mss=True)
    host_rrc_tiff = pp.write_rrc_pan_tiff(0)
    pp.calc_inter_band_correlation(slices=8, sections=1)
    host_aligned = pp.do_inter_band_alignment(
        line_per_section=1504, keep_leading_lines=True, write_tiff=False,
    )

    out2 = tmp_path / "mesh"
    out2.mkdir()
    mesh_aligned = run_sharded_align(
        str(pan_path), str(mss_path), str(rrc_pan), (str(rrc_band),) * 4,
        n_devices=8, do_rrc_pan=True, slices=8, sections=1,
        keep_leading_lines=True, out_dir=str(out2),
        pixels_per_line=width, write_tiff=False,
        quantized_coords=True, write_rrcpan=True,
    )
    # same quantized-grid maps, same whole-image y (single host section
    # starts at y=0 == the mesh's global y0): within 1 DN (XLA:CPU
    # codegen fuse noise)
    d = np.abs(
        mesh_aligned.astype(np.int64) - host_aligned.astype(np.int64)
    )
    assert d.max() <= 1, d.max()
    # the drained RRC PAN TIFF is byte-identical to the host's
    got = tiff_io.read_tiff(str(out2 / os.path.basename(host_rrc_tiff)))
    want = tiff_io.read_tiff(host_rrc_tiff)
    np.testing.assert_array_equal(got, want)


def test_mesh_routes_handle_uneven_strip_lengths(rng, tmp_path):
    """Arbitrary strip lengths on the mesh: line-sharded arrays must
    divide the mesh, so the drivers zero-pad at ingest, mask the pad rows
    to border-0 post-RRC, and trim on drain — outputs match the host
    paths exactly as in the divisible case.  1500 MSS lines / 8 devices
    pads both the PAN (6000 -> 6008... rounded per axis) and MSS axes."""
    from opticalimageprocessor_tpu.formats import rrc_csv
    from opticalimageprocessor_tpu.io import tiff as tiff_io
    from opticalimageprocessor_tpu.models.preprocessor import PreProcessor
    from opticalimageprocessor_tpu.models.sharded_align import (
        run_sharded_align,
    )
    from opticalimageprocessor_tpu.models.sharded_prestitch import (
        run_sharded_prestitch,
    )
    from opticalimageprocessor_tpu.ops import resample

    width, band_px = 512, 128
    lines_mss = 1500               # not divisible by 8
    lines_pan = lines_mss * 4      # 6000: not divisible by 8 either
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan_true = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    bands = np.stack([np.roll(scene, b - 1, 1) for b in range(4)])
    kp, bp = 1.02, -100.0
    pan_dl = np.clip(
        np.rint((pan_true.astype(np.float64) - bp) / kp), 0, 65535
    ).astype(np.uint16)

    pan_path = tmp_path / "C1.PAN.RAW"
    mss_path = tmp_path / "C1.MSS.RAW"
    pan_dl.astype("<u2").tofile(pan_path)
    np.ascontiguousarray(bands.transpose(1, 0, 2)).astype("<u2").tofile(
        mss_path
    )
    rrc_pan = tmp_path / "pan.rrc"
    rrc_csv.save_rrc_params(str(rrc_pan), np.tile([[kp, bp]], (width, 1)))
    rrc_band = tmp_path / "band.rrc"
    # non-identity band RRC: the pad-row masking must keep border-0
    rrc_csv.save_rrc_params(
        str(rrc_band), np.tile([[1.02, 5.0]], (band_px, 1))
    )

    pp = PreProcessor(
        str(pan_path), str(mss_path), str(rrc_pan), (str(rrc_band),) * 4,
        pixels_per_line=width, fast=True, out_dir=str(tmp_path),
    )
    pp.load_and_rrc(do_rrc_pan=True, do_rrc_mss=True)
    pp.calc_inter_band_correlation(slices=8, sections=1)
    host_aligned = pp.do_inter_band_alignment(
        line_per_section=lines_mss, keep_leading_lines=True,
        write_tiff=False,
    )

    out2 = tmp_path / "mesh"
    out2.mkdir()
    mesh_aligned = run_sharded_align(
        str(pan_path), str(mss_path), str(rrc_pan), (str(rrc_band),) * 4,
        n_devices=8, do_rrc_pan=True, slices=8, sections=1,
        keep_leading_lines=True, out_dir=str(out2),
        pixels_per_line=width, write_tiff=False,
    )
    assert mesh_aligned.shape == host_aligned.shape == (
        lines_mss, band_px, 4,
    )
    # the padded shapes partition the tile FFTs differently, moving the
    # float64 fit by the known ~1e-3 px XLA:CPU scheduling envelope; on
    # white noise that amplifies to isolated ~DN diffs, so gate on
    # statistics, never a tight DN max (docs/NUMERICS.md)
    d = np.abs(
        mesh_aligned.astype(np.int64) - host_aligned.astype(np.int64)
    )
    assert d.mean() < 1.0, d.mean()
    assert (d > 10).mean() < 1e-3, (d > 10).mean()
    for b in range(4):
        c = np.corrcoef(
            mesh_aligned[4:-4, 4:-4, b].astype(np.float64).ravel(),
            host_aligned[4:-4, 4:-4, b].astype(np.float64).ravel(),
        )[0, 1]
        assert c > 0.999, (b, c)
    # the last real rows must NOT leak RRC'd-zero bias from the pad halo:
    # the bottom rows' diff stats match the interior's
    assert d[-8:].mean() < max(1.0, 3 * d.mean() + 0.5), (
        d[-8:].mean(), d.mean(),
    )

    # --- sharded prestitch on the same uneven length
    ov = 64
    wide = rng.integers(
        2000, 42000, (lines_pan + 8, 2 * width)
    ).astype(np.uint16)
    p1 = str(tmp_path / "S1.PAN.RAW")
    p2 = str(tmp_path / "S2.PAN.RAW")
    np.ascontiguousarray(wide[4 : 4 + lines_pan, :width]).astype(
        "<u2"
    ).tofile(p1)
    np.ascontiguousarray(
        wide[2 : 2 + lines_pan, width - ov + 3 : 2 * width - ov + 3]
    ).astype("<u2").tofile(p2)
    dx, dy, prestt_path = run_sharded_prestitch(
        p1, p2, str(rrc_pan), str(rrc_pan), n_devices=8, sections=3,
        line_per_section=1024, overlap_cols=ov, threshold=0.05,
        out_dir=str(out2), pixels_per_line=width,
    )
    assert abs(dx + 3.0) < 0.3 and abs(dy - 2.0) < 0.3, (dx, dy)
    import os as _os

    assert (
        _os.path.getsize(prestt_path) == lines_pan * width * 2
    )


def test_cli_fails_loudly_on_misconfigured_distributed_env():
    """A partial OIP_DIST_* env must abort the CLI before any work runs.

    Regression: maybe_initialize_distributed() used to be called inside
    _enable_compile_cache's best-effort except, so a misconfigured
    multi-host launch silently fell back to N independent single-process
    runs racing on the same output files (cli.py)."""
    import subprocess
    import sys as _sys

    env = dict(os.environ)
    env["OIP_DIST_COORD"] = "127.0.0.1:1"
    env.pop("OIP_DIST_NPROCS", None)
    env.pop("OIP_DIST_PROCID", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    res = subprocess.run(
        [
            _sys.executable,
            "-c",
            "import sys\n"
            "from opticalimageprocessor_tpu.cli import main\n"
            "sys.exit(main(['--help']))",
        ],
        env=env,
        capture_output=True,
        text=True,
        timeout=180,
    )
    assert res.returncode != 0
    assert "OIP_DIST_NPROCS" in (res.stderr + res.stdout)
