"""Multi-chip inter-band registration + alignment (the CLI's ``--mesh N``
route for the default command).

Same user contract as :class:`models.preprocessor.PreProcessor` in fast
mode — identical float64-fitted coefficients (shared filter+fit code) and
an aligned raster within 1 DN — but executed SPMD over an ``n_devices``
line mesh (parallel/sharded.make_align_step):

* inputs are fed shard-by-shard straight from the memory-mapped RAW strips
  (``jax.make_array_from_callback``), so host RSS stays bounded by one
  shard instead of the whole scene (the behaviour replacing the
  reference's whole-strip LoadRawImage, imageop.h:110-127);
* the ALIGNED.TIFF is drained shard-by-shard in line order, never
  materialising the full output on the host.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..constants import (
    IBPA_MAX_LINEOVERLAP,
    IBPA_MIN_PROCESSLINES,
    IBPA_STEM_EXT,
    MSS_BANDS,
    PIXELS_PER_LINE,
    TIFF_FILE_EXT,
)
from ..formats.naming import build_output_file_path
from ..formats.rrc_csv import load_split_params
from ..io import raw as raw_io
from ..parallel.mesh import LINE_AXIS, line_mesh
from ..parallel.sharded import make_align_step
from ..utils.logging import olog, stage


def run_sharded_align(
    pan_file: str,
    mss_file: str,
    rrc_pan_file: str = "",
    rrc_mss_files: tuple[str, str, str, str] | None = None,
    n_devices: int | None = None,
    do_rrc_pan: bool = False,
    do_rrc_mss: bool = True,
    slices: int = 10,
    sections: int | None = None,
    threshold: float = 0.4,
    line_offset: int = 0,
    section_overlap: int = 520,
    keep_leading_lines: bool = False,
    out_dir: str | None = None,
    bgr_tiff_order: bool = True,
    pixels_per_line: int = PIXELS_PER_LINE,
    write_tiff: bool = True,
    quantized_coords: bool = False,
    write_rrcpan: bool = False,
):
    """Run the sharded align pipeline; returns the ALIGNED.TIFF path (or
    the aligned array when ``write_tiff=False``).

    RRC flags follow the CLI: identity parameters are substituted when a
    correction is disabled (bit-exact no-op through the RRC math).
    """
    multi_host = jax.process_count() > 1
    band_px = pixels_per_line // MSS_BANDS
    pan = raw_io.RawStrip(pan_file, pixels_per_line)
    mss = raw_io.RawStrip(mss_file, pixels_per_line)
    # geometry invariants (CheckFilesAttributes, preproc.h:552-572)
    raw_io.check_pan_mss_sizes(pan, mss)
    if mss.lines - line_offset < IBPA_MIN_PROCESSLINES:
        raise ValueError("Too few image lines left to process")
    # same bounds the host path enforces (do_inter_band_alignment /
    # oipshared.h IBPA_MAX_LINEOVERLAP) — an oversized overlap would
    # otherwise trim into a negative output row count after the SPMD run
    if section_overlap > IBPA_MAX_LINEOVERLAP:
        raise ValueError(
            f"Overlap value {section_overlap} exceeds maximum allowed "
            f"value({IBPA_MAX_LINEOVERLAP})"
        )
    if (
        not keep_leading_lines
        and mss.lines - line_offset - section_overlap <= 0
    ):
        raise ValueError("Too few image lines left to process")
    olog("PAN: %d lines, MSS: %d lines.", pan.lines, mss.lines)

    if do_rrc_pan and not rrc_pan_file:
        raise ValueError("RRC parameter file of PAN needed")
    pan_params = load_split_params(
        rrc_pan_file if do_rrc_pan else "", pixels_per_line
    )
    if do_rrc_mss and (
        not rrc_mss_files or any(not f for f in rrc_mss_files)
    ):
        raise ValueError("RRC parameter file of all MSS Bands needed")
    mss_params = np.stack(
        [
            load_split_params(
                rrc_mss_files[b] if do_rrc_mss else "", band_px
            )
            for b in range(MSS_BANDS)
        ]
    )

    if n_devices and len(jax.devices()) < n_devices:
        raise RuntimeError(
            f"--mesh {n_devices} needs {n_devices} devices, only "
            f"{len(jax.devices())} available"
        )
    mesh = line_mesh(n_devices)
    n_dev = mesh.shape[LINE_AXIS]
    olog("Sharded align over %d-device '%s' mesh.", n_dev, LINE_AXIS)

    # shard-by-shard ingest straight from the memory maps (zero-padded to
    # the mesh size — arbitrary strip lengths shard evenly; the step masks
    # the pad rows post-RRC and the drains trim them): the callback is
    # invoked once per device with that device's index window, so host RSS
    # is bounded by one shard
    from ..parallel.sharded import ingest_line_sharded

    with stage("shard_ingest", pan.nbytes + mss.nbytes):
        pan_arr = ingest_line_sharded(
            mesh, pan._mm, pan.lines, 0, P(LINE_AXIS, None)
        )
        mss_view = mss._mm.reshape(mss.lines, MSS_BANDS, band_px).transpose(
            1, 0, 2
        )
        mss_arr = ingest_line_sharded(
            mesh, mss_view, mss.lines, 1, P(None, LINE_AXIS, None)
        )

    step = make_align_step(
        mesh, slices, sections, threshold,
        quantized=quantized_coords, want_pan_c=write_rrcpan,
    )
    with stage("sharded_align", pan.nbytes + mss.nbytes):
        outs = step(
            pan_arr, mss_arr, pan_params, mss_params, line_offset,
            real_lines_pan=pan.lines,
        )
        aligned, coeff_x, coeff_y = outs[:3]
        aligned.block_until_ready()
    if write_rrcpan:
        # WriteRRCedPAN_TIFF(lineOffset) parity (preproc.h:107,
        # main.cpp:310): drain the line-sharded corrected PAN shard by
        # shard from line_offset on
        from ..constants import RRC_STEM_EXT

        pan_c = outs[3]
        rrc_path = build_output_file_path(
            pan_file, RRC_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir
        )
        with stage("write_rrcpan", (pan.lines - line_offset) * pixels_per_line * 2):
            # one drain for both launch modes: single-process callers get
            # the same offset-write flow without barriers, byte-identical
            # to the sequential TiffStripWriter (test_tiff_foreign.py
            # shell byte-equality test)
            from ..parallel.distributed import drain_line_sharded_to_tiff

            drain_line_sharded_to_tiff(
                pan_c, rrc_path, total=pan.lines, row0=line_offset
            )
        olog("RRC'ed PAN written to %s", rrc_path)
    for b in range(MSS_BANDS):
        olog(
            "\tdeltaX coeff: [1] %.15f, [0] %.9f",
            coeff_x[b, 1], coeff_x[b, 0],
        )
        olog(
            "\tdeltaY coeff: [2] %.15f, [1] %.15f, [0] %.9f",
            coeff_y[b, 2], coeff_y[b, 1], coeff_y[b, 0],
        )

    # real output rows: the step returns mesh-padded rows at the bottom
    total_rows = mss.lines - line_offset
    start = 0 if keep_leading_lines else section_overlap
    out_rows = total_rows - start
    if not write_tiff:
        if multi_host:
            # the caller asked for a host array: replicate the raster over
            # the mesh (an all-gather across processes) so EVERY process
            # returns the identical full array.  Costs one full-raster
            # copy per device — the file drains below stay the scalable
            # route for large scenes.
            aligned = jax.jit(
                lambda x: x, out_shardings=NamedSharding(mesh, P())
            )(aligned)
        return np.asarray(aligned)[start:total_rows]

    path = build_output_file_path(
        mss_file, IBPA_STEM_EXT, TIFF_FILE_EXT, out_dir=out_dir
    )
    order = [2, 1, 0, 3] if bgr_tiff_order else [0, 1, 2, 3]
    with stage("write_aligned", out_rows * band_px * MSS_BANDS * 2):
        # single drain for both launch modes (see write_rrcpan above)
        from ..parallel.distributed import drain_line_sharded_to_tiff

        drain_line_sharded_to_tiff(
            aligned, path, total=total_rows, row0=start, order=order
        )
    olog("Aligned MSS written to %s", path)
    return path
