"""Multi-chip dual-CMOS prestitch (the CLI's ``prestitch --mesh N`` route).

Same user contract as :class:`models.stitcher.Stitcher` in fast mode —
identical stt-parameter estimation semantics (uncorrected-strip overlap
correlation per main.cpp:280-284 / stitcher.h:148-201, threshold +
max-Δy validity filter, "No valid delta value found" error) and a
``.PRESTT.RAW`` within the fast-path envelope — executed SPMD over an
``n_devices`` line mesh (parallel/sharded.make_prestitch_step):

* the PAN strips are fed shard-by-shard from the memory-mapped RAW files
  (``jax.make_array_from_callback``), host RSS bounded by one shard;
* RRC runs sharded on device; the ``.RRC.RAW`` intermediates are drained
  shard-by-shard in line order (reference DoRRC file contract,
  stitcher.h:141-146);
* the constant-shift prestitch resample runs as a shard_map with ppermute
  halo exchange between devices, then drains to ``.PRESTT.RAW`` with the
  reference's line-count bookkeeping.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..constants import (
    PIXELS_PER_LINE,
    PRESTT_STEM_EXT,
    RRC_STEM_EXT,
    STT_DEF_EDGECOLS,
    STT_DEF_MAXDELTAY,
    STT_DEF_PHCTHRHLD,
)
from ..formats.naming import build_output_file_path
from ..formats.rrc_csv import load_split_params
from ..io import raw as raw_io
from ..parallel.mesh import LINE_AXIS, line_mesh
from ..parallel.sharded import make_prestitch_step
from ..utils.logging import olog, stage
from .stitcher import Stitcher, average_valid_deltas


def _drain_to_raw(
    arr, path: str, pixels_per_line: int, stage_name: str,
    total: int | None = None,
):
    """Write a line-sharded device array to a RAW file shard-by-shard
    (host RSS bounded by one shard).  ``total`` trims the mesh-padding
    rows at the strip bottom.  Works single-process (sequential writes)
    and multi-host (per-process row-offset writes into a shared file —
    see :func:`parallel.distributed.drain_line_sharded_to_raw`)."""
    from ..parallel.distributed import drain_line_sharded_to_raw

    if total is None:
        total = arr.shape[0]
    with stage(stage_name, total * pixels_per_line * 2):
        drain_line_sharded_to_raw(arr, path, pixels_per_line, total)
    return path


def run_sharded_prestitch(
    pan1: str,
    pan2: str,
    rrc1: str = "",
    rrc2: str = "",
    n_devices: int | None = None,
    sections: int = 10,
    line_per_section: int = 16000,
    overlap_cols: int = 200,
    threshold: float = STT_DEF_PHCTHRHLD,
    max_delta_y: float = STT_DEF_MAXDELTAY,
    edge_cols: int = STT_DEF_EDGECOLS,
    do_rrc: bool = True,
    only_calculate: bool = False,
    out_dir: str | None = None,
    pixels_per_line: int = PIXELS_PER_LINE,
):
    """Run the sharded prestitch; returns (delta_x, delta_y, prestt_path or
    None when ``only_calculate``)."""
    # geometry/size validation identical to the host Stitcher ctor
    st = Stitcher(
        pan1, pan2, rrc1, rrc2, sections, line_per_section, overlap_cols,
        out_dir=out_dir, pixels_per_line=pixels_per_line,
    )
    if n_devices and len(jax.devices()) < n_devices:
        raise RuntimeError(
            f"--mesh {n_devices} needs {n_devices} devices, only "
            f"{len(jax.devices())} available"
        )
    mesh = line_mesh(n_devices)
    olog(
        "Sharded prestitch over %d-device '%s' mesh.",
        mesh.shape[LINE_AXIS], LINE_AXIS,
    )

    p1 = raw_io.RawStrip(pan1, pixels_per_line)
    p2 = raw_io.RawStrip(pan2, pixels_per_line)
    from ..parallel.sharded import ingest_line_sharded

    # zero-padded to the mesh size: arbitrary strip lengths shard evenly
    # (pad rows masked post-RRC below, trimmed on drain)
    with stage("shard_ingest", p1.nbytes + p2.nbytes):
        pan1_arr = ingest_line_sharded(
            mesh, p1._mm, p1.lines, 0, P(LINE_AXIS, None)
        )
        pan2_arr = ingest_line_sharded(
            mesh, p2._mm, p2.lines, 0, P(LINE_AXIS, None)
        )

    correlate, rrc_fn, remap = make_prestitch_step(
        mesh, sections, line_per_section, overlap_cols, edge_cols
    )

    # CalcSttParameters on the uncorrected strips (reference order)
    gap = (st.lines_pan - sections * line_per_section) // (sections + 1)
    offs = [gap + i * (gap + line_per_section) for i in range(sections)]
    with stage("stt_correlate_sharded"):
        dxs, dys, rss = correlate(pan1_arr, pan2_arr, real_lines=p1.lines)
    delta_x, delta_y, _resp = average_valid_deltas(
        np.asarray(dxs), np.asarray(dys), np.asarray(rss), offs,
        threshold, max_delta_y,
    )
    if only_calculate:
        return delta_x, delta_y, None

    # DoRRC (sharded) + drain the .RRC.RAW intermediates
    prestt_src = pan2_arr
    prestt_src_path = pan2
    if do_rrc:
        for src_path, par, arr, out_attr in (
            (pan1, rrc1, pan1_arr, "rrc_file_pan1"),
            (pan2, rrc2, pan2_arr, "rrc_file_pan2"),
        ):
            if not par:
                raise ValueError("RRC parameter file needed")
            params = np.asarray(load_split_params(par, pixels_per_line))
            corrected = rrc_fn(arr, params)
            if corrected.shape[0] != p2.lines:
                # mesh-padding rows: RRC of the zero fill is the bias —
                # mask back to border-0 (they feed the remap's halo)
                import jax.numpy as jnp

                rows = jnp.arange(corrected.shape[0])
                corrected = jnp.where(
                    (rows < p2.lines)[:, None], corrected, jnp.uint16(0)
                )
            dst = build_output_file_path(
                src_path, RRC_STEM_EXT, out_dir=out_dir
            )
            _drain_to_raw(
                corrected, dst, pixels_per_line,
                f"rrc_sharded:{out_attr}", total=p2.lines,
            )
            setattr(st, out_attr, dst)
            if src_path == pan2:
                prestt_src = corrected
                prestt_src_path = dst

    # PreStitch (sharded constant-shift resample) + drain
    out_path = build_output_file_path(
        prestt_src_path, PRESTT_STEM_EXT, out_dir=out_dir
    )
    with stage("prestitch_sharded", p2.nbytes):
        prestt = remap(prestt_src, delta_x, delta_y)
        prestt.block_until_ready()
    _drain_to_raw(
        prestt, out_path, pixels_per_line, "write_prestt", total=p2.lines
    )
    olog("Pre-stitched PAN2 (sharded) written to file '%s'.", out_path)
    return delta_x, delta_y, out_path
