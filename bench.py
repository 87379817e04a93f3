"""End-to-end device benchmark: RRC + register + resample + stitch.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Gpix/s/chip", "vs_baseline": N/2.0}

Baseline (BASELINE.json north star): >= 2 Gpix/s/chip.  Runs the library's
fused device pipeline (models/device_pipeline.make_device_pipeline) on a
synthetic HBM-resident scene: RRC both sensors, sections x slices
registration sampling, 4-band alignment resample, prestitch resample,
seam concat.  OIP_BENCH_LINES scales the scene (default 65536 lines on
the GPU — the multi-GB BASELINE config 5; 2048 in the CPU smoke mode,
which checks the control flow and times nothing real).  The JSON line
names the device it ran on.

Pixels counted = every input pixel, exactly once: PAN1 (RRC + registration
+ stitch left half) + PAN2 (its own RRC + on-device stt-parameter
estimation + prestitch resample + stitch right half) + MSS (RRC +
registration + 4-band alignment resample).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _emit(value, error: str | None = None, **extra) -> None:
    """The ONE JSON line the driver parses.  ``extra`` records run-mode
    qualifiers (e.g. lines, timing) so differently-configured runs are
    not read as directly comparable numbers."""
    out = {
        "metric": "e2e RRC+register+resample+stitch throughput",
        "value": value,
        "unit": "Gpix/s/chip",
        "vs_baseline": round(value / 2.0, 3) if value is not None else None,
    }
    if error:
        out["error"] = error
    out.update(extra)
    print(json.dumps(out), flush=True)


def main() -> None:
    """Run the bench in this process; on failure still print the ONE
    parseable JSON line (with the error) and exit non-zero."""
    try:
        run_bench()
    except Exception as exc:  # parseable output even on a real bug
        import traceback

        traceback.print_exc()
        _emit(None, error=f"{type(exc).__name__}: {exc}"[:300])
        raise SystemExit(1)


def _device() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _scene_inputs(lines_pan: int):
    """The synthetic scene on the device: (pan1, pan2, mss, pan1_params,
    pan2_params, mss_params) at real camera geometry."""
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.constants import (
        MSS_BANDS,
        PIXELS_PER_LINE,
        PIXELS_PER_MSSBAND,
    )
    from opticalimageprocessor_tpu.ops import rrc

    lines_mss = lines_pan // MSS_BANDS
    rng = np.random.default_rng(0)
    # real camera geometry: the PAN sensor sees the MSS-resolution scene at
    # 4x; the MSS bands are small per-band translations of it; PAN2 (the
    # second CMOS) overlaps PAN1's right edge with a small mounting offset.
    # Content only affects whether the registration/stt samples pass the
    # 0.4 response filter — the FLOPs are content-independent.
    from opticalimageprocessor_tpu.ops import resample

    scene = rng.integers(
        2000, 42000, (lines_mss, PIXELS_PER_MSSBAND), dtype=np.uint16
    )

    def derive_inputs(scene_d):
        pan1 = jnp.clip(
            jnp.rint(resample.upsample4_f32(scene_d.astype(jnp.float32))),
            0, 65535,
        ).astype(jnp.uint16)
        # PAN2's left 200 columns see PAN1's right-edge ground (dual-CMOS
        # overlap) with a small (dx=-3, dy=+2) mounting offset
        pan2 = jnp.roll(
            jnp.roll(pan1, 2, axis=0), 200 - 3 - PIXELS_PER_LINE, axis=1
        )
        mss = jnp.stack(
            [
                jnp.roll(jnp.roll(scene_d, b % 2, axis=0), b - 1, axis=1)
                for b in range(MSS_BANDS)
            ]
        )
        return pan1, pan2, mss

    # inputs are derived ON DEVICE once, untimed (the upsample/roll
    # synthesis is cheap; pushing GBs from the host is not)
    pan1, pan2, mss = derive_inputs(jnp.asarray(scene))
    del scene

    def rand_params(n):
        return jnp.asarray(
            rrc.split_rrc_params(
                0.98 + 0.04 * rng.random(n), rng.normal(0, 20, n)
            )
        )

    pan1_params = rand_params(PIXELS_PER_LINE)
    pan2_params = rand_params(PIXELS_PER_LINE)
    mss_params = jnp.asarray(
        np.stack(
            [
                rrc.split_rrc_params(
                    0.98 + 0.04 * rng.random(PIXELS_PER_MSSBAND),
                    rng.normal(0, 20, PIXELS_PER_MSSBAND),
                )
                for _ in range(MSS_BANDS)
            ]
        )
    )

    return pan1, pan2, mss, pan1_params, pan2_params, mss_params


def run_bench() -> None:
    import jax

    from opticalimageprocessor_tpu.constants import (
        MSS_BANDS,
        PIXELS_PER_LINE,
        PIXELS_PER_MSSBAND,
    )
    from opticalimageprocessor_tpu.models.device_pipeline import (
        make_device_pipeline,
    )
    from opticalimageprocessor_tpu.ops import backend

    platform = jax.default_backend()
    print("stage paths:", backend.stage_paths(platform), file=sys.stderr)
    if platform == "gpu":
        # default = the multi-GB BASELINE config 5 (65536 lines, ~1.6 GB
        # PAN strips)
        lines_pan = int(os.environ.get("OIP_BENCH_LINES", 65536))
        slices, n_iters = 10, 8
    else:  # CPU smoke mode: checks the control flow, times nothing real
        lines_pan = int(os.environ.get("OIP_BENCH_LINES", 2048))
        slices, n_iters = 8, 2
    lines_mss = lines_pan // MSS_BANDS
    pan1, pan2, mss, pan1_params, pan2_params, mss_params = _scene_inputs(
        lines_pan
    )

    px = (
        lines_pan * PIXELS_PER_LINE                   # PAN1
        + lines_pan * PIXELS_PER_LINE                 # PAN2
        + MSS_BANDS * lines_mss * PIXELS_PER_MSSBAND  # MSS
    )

    if os.environ.get("OIP_BENCH_MODE") == "stream":
        # hand the strips over in a container and drop our own names, so
        # the callee's post-padding `del` actually frees the unpadded
        # pan2/mss device buffers (~2 GB) instead of leaving this frame's
        # references pinning them for the whole measurement
        strips = [pan1, pan2, mss]
        del pan1, pan2, mss
        _run_streamed_sections(
            strips, pan1_params, pan2_params, mss_params,
            n_iters, px, lines_pan,
        )
        return

    pipeline = make_device_pipeline(slices=slices)
    args = (pan1, pan2, mss, pan1_params, pan2_params, mss_params)
    # depth-2 pipelining keeps two fused working sets in flight; where
    # that does not fit the device's memory, the run software-pipelines
    # at STAGE granularity instead (scene i's transform overlaps scene
    # i+1's estimate), same per-scene math
    compiled = pipeline.lower(*args).compile()
    threshold = os.environ.get("OIP_BENCH_STAGED_THRESHOLD")
    if threshold is not None:
        staged = lines_pan > int(threshold)
    else:
        staged = not _depth2_fits(compiled)

    if staged:
        del compiled
        if os.environ.get("OIP_BENCH_MODE") == "staged":
            # the two-execution schedule, kept as an A/B reference
            _run_staged_large(
                pan1, pan2, mss, pan1_params, pan2_params, mss_params,
                slices, n_iters, px, lines_pan,
            )
        else:
            strips = [pan1, pan2, mss]
            del pan1, pan2, mss
            _run_staged_sectioned(
                strips, pan1_params, pan2_params, mss_params,
                slices, n_iters, px, lines_pan,
            )
        return

    pipeline = compiled
    out = pipeline(*args)
    jax.block_until_ready(out)
    _ = np.asarray(out[0][0, 0])

    # serialized per-iteration latency (diagnostic): each iteration pays
    # the dispatch and readback round trip before the next can start
    times = []
    for it in range(n_iters):
        t0 = time.perf_counter()
        out = pipeline(*args)
        jax.block_until_ready(out)
        _ = np.asarray(out[0][it % 7, it % 5])
        times.append(time.perf_counter() - t0)

    # sustained throughput (THE metric): keep exactly one extra iteration
    # in flight (depth-2 pipelining, bounding device memory to two working
    # sets) so device compute overlaps the host drain — how a production
    # pipeline runs back-to-back scenes.  Every iteration's result is
    # still fully materialised and read back.  (Scenes whose two working
    # sets would not fit took the staged path above.)
    from collections import deque

    depth = 2

    def one_window():
        t0 = time.perf_counter()
        inflight = deque()
        done = 0
        for it in range(n_iters):
            inflight.append(pipeline(*args))
            if len(inflight) > depth:
                out_i = inflight.popleft()
                jax.block_until_ready(out_i)
                _ = np.asarray(out_i[0][done % 7, done % 5])
                done += 1
        while inflight:
            out_i = inflight.popleft()
            jax.block_until_ready(out_i)
            _ = np.asarray(out_i[0][done % 7, done % 5])
            done += 1
        return time.perf_counter() - t0

    dt, window_dts = _adaptive_windows(one_window, n_iters)
    mode = "pipelined"

    print("serialized times:", [round(t, 4) for t in times], file=sys.stderr)
    print(
        f"{mode}: {dt * 1e3:.1f} ms/iter "
        f"(serialized median {np.median(times) * 1e3:.1f}; windows "
        f"{[round(w * 1e3, 1) for w in window_dts]})",
        file=sys.stderr,
    )
    print(
        "valid: register", np.asarray(out[2]).tolist(),
        "stt", int(out[3]), file=sys.stderr,
    )

    gpix = px / dt / 1e9
    _emit(
        round(gpix, 3), lines=lines_pan, timing=mode, device=_device(),
        windows_ms=[round(w * 1e3, 1) for w in window_dts],
    )


def _depth2_fits(compiled, headroom: float = 0.9) -> bool:
    """Whether two in-flight executions of ``compiled`` (its temps and
    outputs twice, its arguments once) fit the device's memory limit, as
    ``memory_stats()`` reports it.  True where the backend reports no
    limit (the CPU smoke mode)."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return True
    ma = compiled.memory_analysis()
    need = (
        2 * (ma.temp_size_in_bytes + ma.output_size_in_bytes)
        + ma.argument_size_in_bytes
    )
    print(
        f"depth-2 working set {need / 2**30:.2f} GiB of "
        f"{limit / 2**30:.2f} GiB", file=sys.stderr,
    )
    return need <= headroom * limit


def _adaptive_windows(one_window, n_iters, max_windows=6, tol=0.02):
    """Best (min) per-iteration time over adaptive timing windows.

    The host can slow for stretches (it is shared); a fixed best-of-3 can land entirely inside a slow phase and charge
    host scheduling to the device.  Keep taking windows (at least 3, at
    most ``max_windows``) until a second window lands within ``tol`` of
    the best — a stable minimum two windows agree on.
    """
    dts = []
    for _ in range(max_windows):
        dts.append(one_window() / n_iters)
        if len(dts) >= 3 and sorted(dts)[1] <= min(dts) * (1 + tol):
            break
    return min(dts), dts


def _run_staged_sectioned(
    strips, pan1_params, pan2_params, mss_params,
    slices, n_iters, px, lines_pan,
):
    """Multi-GB default: per-scene estimation + SECTIONED transform.

    The two-execution schedule (estimate | whole-scene transform,
    ``OIP_BENCH_MODE=staged``) has only two execution boundaries per
    scene: too few places to overlap the blocking readback with queued
    device work.
    Splitting the transform into halo'd sections (the scene_stream
    production math, bit-identical rows) gives 2-4 boundaries per scene,
    so a depth-``OIP_BENCH_SECTIONED_DEPTH`` deque keeps the device queue
    full across scene boundaries: while section k of scene i is blocked
    on, section k+1, scene i+1's estimate and its first sections are
    already enqueued.  Every scene still runs its OWN full estimation
    (register_fast over the sampled tiles + stt windows — the same
    per-scene work the staged mode times).

    HBM budget: persistent inputs are kept once (PAN1 full; PAN2 only as
    halo-padded + its 200 stt overlap columns — make_scene_estimate needs
    nothing more; MSS raw + halo-padded), and at most ``depth + 1``
    sections' outputs are in flight.
    """
    import jax
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.constants import MSS_BANDS
    from opticalimageprocessor_tpu.models.device_pipeline import (
        make_scene_estimate,
    )
    from opticalimageprocessor_tpu.models.scene_stream import _section_math

    pan1, pan2, mss = strips
    strips.clear()

    section_rows = int(
        os.environ.get("OIP_BENCH_SECTION_ROWS", min(32768, lines_pan))
    )
    depth = int(os.environ.get("OIP_BENCH_SECTIONED_DEPTH", 2))
    assert lines_pan % section_rows == 0, (lines_pan, section_rows)
    n_secs = lines_pan // section_rows
    sec_b = section_rows // MSS_BANDS
    row_bound, prestt_row_bound = 3, 8
    halo_b, halo_p = row_bound + 2, prestt_row_bound + 2
    overlap_cols = 200
    static = dict(
        fold=overlap_cols, chunk_rows=512, row_bound=row_bound,
        prestt_row_bound=prestt_row_bound, col_block=128, col_halo=16,
    )
    lines_mss = lines_pan // MSS_BANDS

    # persistent device inputs: pad PAN2/MSS once with the halo rows the
    # per-section slices read (the production streamer reads true
    # neighbour rows from the file); keep PAN2 additionally ONLY as its
    # left stt-overlap columns — the sole part estimation reads
    @jax.jit
    def prep(pan2, mss):
        p2p = jnp.concatenate(
            [
                jnp.zeros((halo_p, pan2.shape[1]), pan2.dtype),
                pan2,
                jnp.zeros((halo_p, pan2.shape[1]), pan2.dtype),
            ]
        )
        msp = jnp.concatenate(
            [
                jnp.zeros((MSS_BANDS, halo_b, mss.shape[2]), mss.dtype),
                mss,
                jnp.zeros((MSS_BANDS, halo_b, mss.shape[2]), mss.dtype),
            ],
            axis=1,
        )
        return p2p, msp, pan2[:, :overlap_cols]

    pan2_pad, mss_pad, pan2_left = prep(pan2, mss)
    jax.block_until_ready(pan2_pad)
    del pan2

    est = make_scene_estimate(slices=slices)

    col_halo = static["col_halo"]

    @jax.jit
    def section_prog(pan1, pan2_pad, mss_pad, a,
                     cx, cy, raw_dx, raw_dy,
                     pan1_params, pan2_params, mss_params):
        ab = a // MSS_BANDS
        p1_sec = jax.lax.dynamic_slice(
            pan1, (a, 0), (section_rows, pan1.shape[1])
        )
        p2_sec = jax.lax.dynamic_slice(
            pan2_pad, (a, 0),
            (section_rows + 2 * halo_p, pan2_pad.shape[1]),
        )
        mss_sec = jax.lax.dynamic_slice(
            mss_pad, (0, ab, 0),
            (MSS_BANDS, sec_b + 2 * halo_b, mss_pad.shape[2]),
        )
        p2m = jnp.arange(-halo_p, section_rows + halo_p) + a
        p2m = (p2m >= 0) & (p2m < lines_pan)
        msm = jnp.arange(-halo_b, sec_b + halo_b) + ab
        msm = (msm >= 0) & (msm < lines_mss)
        # the staged transform's clamp of the raw stt deltas to the
        # supported resample band (device_pipeline._transform)
        dxs = jnp.clip(raw_dx, -(col_halo - 2.0), col_halo - 2.0)
        dys = jnp.clip(
            raw_dy, -(prestt_row_bound - 2.0), prestt_row_bound - 2.0
        )
        aligned, stitched, _prestt = _section_math(
            p1_sec, p2_sec, mss_sec, p2m, msm,
            pan1_params, pan2_params, mss_params, cx, cy,
            dxs, dys, **static,
        )
        return aligned, stitched

    def run_est():
        return est(pan1, pan2_left, mss, pan1_params, mss_params)

    def run_section(k, params):
        cx, cy, _nv, rdx, rdy, _ns = params
        return section_prog(
            pan1, pan2_pad, mss_pad, jnp.int32(k * section_rows),
            cx, cy, rdx, rdy, pan1_params, pan2_params, mss_params,
        )

    def probe(out, i):
        _ = np.asarray(out[1][i % 7, i % 5])

    # warmup: one full scene, fully drained (compiles est + section)
    from collections import deque

    params = run_est()
    outs = [run_section(k, params) for k in range(n_secs)]
    jax.block_until_ready(outs[-1])
    for o in outs:
        probe(o, 0)
    print(
        "valid: register", np.asarray(params[2]).tolist(),
        "stt", int(params[5]), file=sys.stderr,
    )
    del outs

    def one_window():
        t0 = time.perf_counter()
        inflight = deque()
        done = 0
        params = run_est()
        for it in range(n_iters):
            for k in range(n_secs):
                inflight.append(run_section(k, params))
                while len(inflight) > depth:
                    out = inflight.popleft()
                    jax.block_until_ready(out[1])
                    probe(out, done)
                    done += 1
            if it + 1 < n_iters:
                params = run_est()
        while inflight:
            out = inflight.popleft()
            jax.block_until_ready(out[1])
            probe(out, done)
            done += 1
        return time.perf_counter() - t0

    dt, window_dts = _adaptive_windows(one_window, n_iters)

    print(
        f"pipelined-sectioned: {dt * 1e3:.1f} ms/scene ({n_secs} x "
        f"{section_rows}-line sections, depth {depth}; windows "
        f"{[round(w * 1e3, 1) for w in window_dts]})",
        file=sys.stderr,
    )
    _emit(
        round(px / dt / 1e9, 3), lines=lines_pan,
        timing="pipelined-sectioned", sections=n_secs, depth=depth,
        device=_device(),
        windows_ms=[round(w * 1e3, 1) for w in window_dts],
    )


def _run_streamed_sections(
    strips, pan1_params, pan2_params, mss_params,
    n_iters, px, lines_pan,
    section_rows: int = 4096,
):
    """OIP_BENCH_MODE=stream: throughput of the *streamed* section pipeline
    (models/scene_stream's per-section transform step — the bounded-memory
    route for scenes beyond HBM), fed at device rate.

    The host->HBM feed is replaced by on-device section slicing from
    device-resident strips (the same trick the resident bench uses for its
    inputs), so the host feed is not inside the timing (the real
    streamer's double-buffered feed, io/streaming.py, is measured by the
    CLI's ``scene --stream`` instead).  What IS measured: the
    production per-section jit program (RRC + banded alignment resample +
    constant-shift prestitch remap + seam concat at col_block=128/
    col_halo=16), section-to-section pipelining at depth 2, and the HBM
    high-water of the bounded working set.  Registration/stt estimation
    (sampled windows, negligible work) uses fixed fitted constants.
    """
    import jax
    import jax.numpy as jnp

    from opticalimageprocessor_tpu.constants import MSS_BANDS

    pan1, pan2, mss = strips
    strips.clear()  # no references left behind the upcoming `del`

    section_rows = int(
        os.environ.get("OIP_BENCH_STREAM_SECTION_ROWS", section_rows)
    )
    depth = int(os.environ.get("OIP_BENCH_STREAM_DEPTH", 2))
    section_rows = min(section_rows, lines_pan)
    assert lines_pan % section_rows == 0, (lines_pan, section_rows)
    n_secs = lines_pan // section_rows
    sec_b = section_rows // MSS_BANDS
    row_bound, prestt_row_bound = 3, 8
    halo_b, halo_p = row_bound + 2, prestt_row_bound + 2
    static = dict(
        fold=100, chunk_rows=512, row_bound=row_bound,
        prestt_row_bound=prestt_row_bound, col_block=128, col_halo=16,
    )
    lines_mss = lines_pan // MSS_BANDS

    # pre-pad pan2/mss with the halo rows once, so per-section slices are
    # always in bounds (the real streamer reads true neighbour rows from
    # the file; the masks below reproduce its beyond-strip flags)
    @jax.jit
    def pad_inputs(pan2, mss):
        p2p = jnp.concatenate(
            [
                jnp.zeros((halo_p, pan2.shape[1]), pan2.dtype),
                pan2,
                jnp.zeros((halo_p, pan2.shape[1]), pan2.dtype),
            ]
        )
        msp = jnp.concatenate(
            [
                jnp.zeros((MSS_BANDS, halo_b, mss.shape[2]), mss.dtype),
                mss,
                jnp.zeros((MSS_BANDS, halo_b, mss.shape[2]), mss.dtype),
            ],
            axis=1,
        )
        return p2p, msp

    pan2_pad, mss_pad = pad_inputs(pan2, mss)
    del pan2, mss

    from opticalimageprocessor_tpu.models.scene_stream import _section_math

    coeff_x = jnp.asarray(
        np.tile([[1.5, 2.5e-4]], (MSS_BANDS, 1)), jnp.float32
    )
    coeff_y = jnp.asarray(
        np.tile([[-0.75, 1.0e-4, 1.0e-8]], (MSS_BANDS, 1)), jnp.float32
    )
    dxs, dys = jnp.float32(-2.3), jnp.float32(1.4)

    # feed + section step in ONE jitted program per section (the section
    # offset is a traced scalar, so every section runs the same
    # executable): one host dispatch per section instead of two, as the
    # production streamer does (one step call per section)
    @jax.jit
    def section_prog(pan1, pan2_pad, mss_pad, a,
                     pan1_params, pan2_params, mss_params):
        ab = a // MSS_BANDS
        p1_sec = jax.lax.dynamic_slice(
            pan1, (a, 0), (section_rows, pan1.shape[1])
        )
        p2_sec = jax.lax.dynamic_slice(
            pan2_pad, (a, 0),
            (section_rows + 2 * halo_p, pan2_pad.shape[1]),
        )
        mss_sec = jax.lax.dynamic_slice(
            mss_pad, (0, ab, 0),
            (MSS_BANDS, sec_b + 2 * halo_b, mss_pad.shape[2]),
        )
        p2m = jnp.arange(-halo_p, section_rows + halo_p) + a
        p2m = (p2m >= 0) & (p2m < lines_pan)
        msm = jnp.arange(-halo_b, sec_b + halo_b) + ab
        msm = (msm >= 0) & (msm < lines_mss)
        return _section_math(
            p1_sec, p2_sec, mss_sec, p2m, msm,
            pan1_params, pan2_params, mss_params, coeff_x, coeff_y,
            dxs, dys, **static,
        )

    def one_section(a):
        return section_prog(
            pan1, pan2_pad, mss_pad, jnp.int32(a),
            pan1_params, pan2_params, mss_params,
        )

    def one_scene(probe):
        """All sections of one scene, ``depth`` in flight; every section's
        outputs are materialised in HBM and probed back to the host."""
        from collections import deque

        inflight = deque()
        done = 0
        for k in range(n_secs):
            inflight.append(one_section(k * section_rows))
            if len(inflight) >= depth:
                al, st, pr = inflight.popleft()
                jax.block_until_ready(st)
                probe(st, done)
                done += 1
        while inflight:
            al, st, pr = inflight.popleft()
            jax.block_until_ready(st)
            probe(st, done)
            done += 1

    def probe(st, i):
        _ = np.asarray(st[i % 7, i % 5])

    one_scene(probe)  # warmup (compile feed + step)

    times = []
    for it in range(n_iters):
        t0 = time.perf_counter()
        one_scene(probe)
        times.append(time.perf_counter() - t0)

    def one_window():
        t0 = time.perf_counter()
        for _ in range(n_iters):
            one_scene(probe)
        return time.perf_counter() - t0

    dt, window_dts = _adaptive_windows(one_window, n_iters)

    stats = jax.local_devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use") or stats.get("bytes_in_use")
    hbm_peak = peak / 2**30 if peak else None
    print("serialized scene times:", [round(t, 4) for t in times],
          file=sys.stderr)
    print(
        f"streamed-sections: {dt * 1e3:.1f} ms/scene ({n_secs} x "
        f"{section_rows}-line sections; windows "
        f"{[round(w * 1e3, 1) for w in window_dts]}; HBM peak "
        f"{hbm_peak} GiB)",
        file=sys.stderr,
    )
    _emit(
        round(px / dt / 1e9, 3), lines=lines_pan,
        timing="streamed-sections", sections=n_secs, depth=depth,
        device=_device(),
        windows_ms=[round(w * 1e3, 1) for w in window_dts],
        hbm_peak_gib=hbm_peak,
    )


def _run_staged_large(
    pan1, pan2, mss, pan1_params, pan2_params, mss_params,
    slices, n_iters, px, lines_pan,
):
    """Multi-GB configs: stage-granular software pipelining.

    Where two whole fused iterations in flight do not fit the device's
    memory, each scene runs as two executions
    (models/device_pipeline.make_device_pipeline_staged): the transform
    of scene i overlaps the estimate of scene i+1 — persistent inputs +
    one transform working set + one estimate working set in flight —
    which still hides the host round trip.
    The per-scene math is identical to the fused pipeline
    (test_staged_pipeline_matches_fused).
    """
    import jax

    from opticalimageprocessor_tpu.models.device_pipeline import (
        make_device_pipeline_staged,
    )

    est, tra = make_device_pipeline_staged(slices=slices)

    def estimate():
        return est(pan1, pan2, mss, pan1_params, mss_params)

    def transform(params):
        cx, cy, n_valid, rdx, rdy, n_stt = params
        outs = tra(
            pan1, pan2, mss, pan1_params, pan2_params, mss_params,
            cx, cy, rdx, rdy,
        )
        return outs, (n_valid, n_stt)

    # warmup + readback
    (aligned, stitched), valid = transform(estimate())
    jax.block_until_ready(stitched)
    _ = np.asarray(stitched[0, 0])
    print(
        "valid: register", np.asarray(valid[0]).tolist(),
        "stt", int(valid[1]), file=sys.stderr,
    )
    del aligned, stitched

    # serialized per-scene latency (diagnostic)
    times = []
    for it in range(n_iters):
        t0 = time.perf_counter()
        (aligned, stitched), _v = transform(estimate())
        jax.block_until_ready(stitched)
        _ = np.asarray(stitched[it % 7, it % 5])
        times.append(time.perf_counter() - t0)
        del aligned, stitched

    # sustained throughput (THE metric): scene i's transform in flight
    # while scene i+1's estimate is already enqueued; adaptive windows
    # (the host sporadically slows for stretches — see _adaptive_windows)
    def one_window():
        t0 = time.perf_counter()
        nxt = estimate()
        for i in range(n_iters):
            (aligned, stitched), _v = transform(nxt)
            if i + 1 < n_iters:
                nxt = estimate()
            jax.block_until_ready(stitched)
            _ = np.asarray(stitched[i % 7, i % 5])
            del aligned, stitched
        return time.perf_counter() - t0

    dt, window_dts = _adaptive_windows(one_window, n_iters)

    print("serialized times:", [round(t, 4) for t in times], file=sys.stderr)
    print(
        f"pipelined-staged: {dt * 1e3:.1f} ms/scene "
        f"(serialized median {np.median(times) * 1e3:.1f}; windows "
        f"{[round(w * 1e3, 1) for w in window_dts]})",
        file=sys.stderr,
    )
    _emit(
        round(px / dt / 1e9, 3), lines=lines_pan, timing="pipelined-staged",
        device=_device(),
        windows_ms=[round(w * 1e3, 1) for w in window_dts],
    )


if __name__ == "__main__":
    main()
