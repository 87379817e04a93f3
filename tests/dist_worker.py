"""Worker process for the 2-process launch test (not a test module).

Spawned by ``test_parallel.py::test_two_process_align_matches_single``.
Each process owns 4 virtual CPU devices; together they form the same
8-device 'line' mesh the single-process tests use.  Runs the sharded
align step end-to-end (per-host shard ingest -> SPMD correlate over
Gloo collectives -> replicated host fit -> halo'd resample) and writes
its replicated coefficients + its LOCAL aligned shards for the parent
to reassemble and compare.

Usage: dist_worker.py <procid> <nprocs> <port> <outdir>
"""

import os
import sys


def main() -> None:
    procid, nprocs, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["OIP_DIST_COORD"] = f"127.0.0.1:{port}"
    os.environ["OIP_DIST_NPROCS"] = str(nprocs)
    os.environ["OIP_DIST_PROCID"] = str(procid)

    import jax

    jax.config.update("jax_platforms", "cpu")

    from opticalimageprocessor_tpu.parallel.distributed import (
        barrier,
        is_primary,
        maybe_initialize_distributed,
    )

    assert maybe_initialize_distributed()
    assert jax.process_index() == procid
    assert len(jax.devices()) == 4 * nprocs

    import numpy as np
    from jax.sharding import PartitionSpec as P

    from opticalimageprocessor_tpu.parallel import mesh as mesh_lib
    from opticalimageprocessor_tpu.parallel import sharded

    pan, mss, pan_params, mss_params = make_inputs()
    mesh = mesh_lib.line_mesh(4 * nprocs)
    # per-host shard ingest: the callback runs only for THIS process's
    # addressable shards (the production multi-host IO path)
    pan_s = sharded.ingest_line_sharded(
        mesh, pan, pan.shape[0], 0, P("line", None)
    )
    mss_s = sharded.ingest_line_sharded(
        mesh, mss, mss.shape[1], 1, P(None, "line", None)
    )
    step = sharded.make_align_step(mesh, slices=8, sections=1)
    aligned, cx, cy = step(pan_s, mss_s, pan_params, mss_params)
    jax.block_until_ready(aligned)

    np.save(os.path.join(outdir, f"cx_{procid}.npy"), np.asarray(cx))
    np.save(os.path.join(outdir, f"cy_{procid}.npy"), np.asarray(cy))
    for shard in aligned.addressable_shards:
        r0 = shard.index[0].start or 0
        np.save(
            os.path.join(outdir, f"aligned_r{r0:06d}.npy"),
            np.asarray(shard.data),
        )
    # multi-host file drain: every process writes its own shards' rows
    # at their global offsets into ONE shared RAW file
    from opticalimageprocessor_tpu.parallel.distributed import (
        drain_line_sharded_to_raw,
    )

    drain_line_sharded_to_raw(
        pan_s, os.path.join(outdir, "pan_drained.RAW"), pan.shape[1],
        total=pan.shape[0],
    )

    # multi-host COMPRESSED drain: each process LZW-encodes the strips
    # whose first row it holds (+ spill rows for straddles), process 0
    # assembles the final file — byte-moving only, so the parent can
    # require byte-identity with the sequential single-process writer
    from jax.sharding import NamedSharding

    from opticalimageprocessor_tpu.parallel.distributed import (
        drain_line_sharded_to_tiff_lzw,
    )

    ramp = lzw_fixture()
    total = ramp.shape[0]
    pad = -(-total // (4 * nprocs)) * (4 * nprocs)
    padded = np.zeros((pad,) + ramp.shape[1:], np.uint16)
    padded[:total] = ramp
    ramp_s = jax.make_array_from_callback(
        padded.shape,
        NamedSharding(mesh, P("line", None, None)),
        lambda idx: padded[idx],
    )
    drain_line_sharded_to_tiff_lzw(
        ramp_s, os.path.join(outdir, "ramp_lzw.TIFF"), total=total,
        order=[2, 1, 0, 3], rows_per_strip=64, row0=17,
    )

    barrier("dist-worker-done")
    if is_primary():
        with open(os.path.join(outdir, "DONE"), "w") as f:
            f.write("ok")
    print(f"worker {procid} done", flush=True)


def lzw_fixture():
    """Deterministic compressible raster for the LZW-drain byte-identity
    gate; 411 rows so neither the mesh shards nor the 64-row strips align
    with the 17-row trim (straddle + spill paths all exercised)."""
    import numpy as np

    yy, xx = np.mgrid[0:411, 0:96]
    return (
        ((yy * 5 + xx // 3) % 7000 + 200).astype(np.uint16)[:, :, None]
        + np.arange(4, dtype=np.uint16)
    )


def make_inputs():
    """Deterministic inputs shared by workers and the single-process
    reference (same construction as the dryrun's align block)."""
    import numpy as np

    from opticalimageprocessor_tpu.ops import resample, rrc

    rng = np.random.default_rng(42)
    band_px, n_bands = 128, 4
    width = band_px * n_bands
    lines_mss = 512
    scene = rng.integers(2000, 42000, (lines_mss, band_px)).astype(np.uint16)
    pan = np.clip(
        np.rint(np.asarray(resample.upsample4_f32(scene.astype(np.float32)))),
        0, 65535,
    ).astype(np.uint16)
    mss = np.stack(
        [np.roll(scene, b % 2, axis=1) for b in range(n_bands)]
    )
    pan_params = np.asarray(
        rrc.split_rrc_params(np.ones(width), np.zeros(width)), np.float32
    )
    mss_params = np.asarray(
        np.stack(
            [rrc.split_rrc_params(np.ones(band_px), np.zeros(band_px))]
            * n_bands
        ),
        np.float32,
    )
    return pan, mss, pan_params, mss_params


if __name__ == "__main__":
    main()
