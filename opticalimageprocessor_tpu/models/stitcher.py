"""Dual-CMOS stitching pipelines (reference ``Stitcher``, stitcher.h:18-223,
and the stitch writers, imageop.h:277-567).

* :class:`Stitcher` — ``prestitch``: estimate the CMOS1<->CMOS2 overlap
  translation by phase correlation over sampled sections
  (CalcSttParameters), optionally RRC both PANs (DoRRC), then apply the
  whole-image constant-shift resample to PAN2 (PreStitch), streaming in the
  reference's 30000-row sections with the same upper/bottom cut bookkeeping
  (SectionaryRemap, imageop.h:230-275).
* :func:`stitch` — concatenate the two CMOS halves: RAW streaming path
  (StitchBigRaw) or TIFF path with optional band remapping + LZW BigTIFF
  (StitchTiff / StitchTiffGDAL equivalents via io/tiff.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..constants import (
    BYTES_PER_PIXEL,
    IBPA_DEFAULT_BATCHLINES,
    PIXELS_PER_LINE,
    PRESTT_STEM_EXT,
    RAW_FILE_EXT,
    REMAP_SECTION_ROWS,
    RRC_STEM_EXT,
    STT_DEF_EDGECOLS,
    STT_DEF_MAXDELTAY,
    STT_DEF_OVERLAPPX,
    STT_DEF_PHCTHRHLD,
    STT_DEF_SECLINES,
    STT_DEF_SECTIONS,
    TIFF_FILE_EXT,
)
from ..formats.naming import build_output_file_path
from ..formats.rrc_csv import load_split_params
from ..io import raw as raw_io
from ..io import tiff as tiff_io
from ..ops import phasecorr, resample, rrc
from ..utils.logging import olog, rlog, stage


def average_valid_deltas(
    dxs, dys, rss, offs, threshold: float, max_delta_y: float
) -> tuple[float, float, float]:
    """Filter + average the per-section deltas (stitcher.h:163-200): valid =
    response >= ``threshold`` and, when ``max_delta_y`` > 0,
    |dy| <= ``max_delta_y``; logs the reference's QA table; raises the
    reference's "No valid delta value found" error when none survive.
    Shared by the host :class:`Stitcher` and the multi-chip prestitch."""
    olog("Calculating stitching delta values ...")
    rlog("| offset |  delta x |  delta y | response | r |")
    # one batched device->host transfer per array (not one per element —
    # each scalar readback pays a full host<->device round trip)
    dxs, dys, rss = np.asarray(dxs), np.asarray(dys), np.asarray(rss)
    sx = sy = sr = 0.0
    valid = 0
    for i in range(len(offs)):
        dx, dy, r = float(dxs[i]), float(dys[i]), float(rss[i])
        ok = r >= threshold and (max_delta_y <= 0.0 or abs(dy) <= max_delta_y)
        if ok:
            sx += dx
            sy += dy
            sr += r
            valid += 1
        rlog(
            "|%7d |%10.4f|%10.4f|%10.4f|%s|",
            offs[i], dx, dy, r, " ok " if ok else " x ",
        )
    if valid == 0:
        raise RuntimeError(
            "No valid delta value found for stitching parameter calculating"
        )
    olog(
        "Total %d valid delta value pairs found, everage value: "
        "dx: %.5f, dy: %.5f, r: %.5f",
        valid, sx / valid, sy / valid, sr / valid,
    )
    return sx / valid, sy / valid, sr / valid


@dataclass
class Stitcher:
    pan1: str
    pan2: str
    rrc1: str = ""
    rrc2: str = ""
    sections: int = STT_DEF_SECTIONS
    line_per_section: int = STT_DEF_SECLINES
    overlap_cols: int = STT_DEF_OVERLAPPX
    out_dir: str | None = None
    quantized_coords: bool = False
    pixels_per_line: int = PIXELS_PER_LINE   # test hook; camera default 12288
    # fast=True: fast constant-shift resample (blocked matmuls,
    # whole-strip chunked streaming instead of the reference's 30000-row
    # bordered sections); within 1 DN of the parity path
    fast: bool = False

    def __post_init__(self):
        s1 = raw_io.file_size(self.pan1)
        s2 = raw_io.file_size(self.pan2)
        if self.sections * self.line_per_section * BYTES_PER_PIXEL > s1:
            raise ValueError(
                "PAN1 size too small for SECTION & LINE_PER_SECTION argument"
            )
        if self.sections * self.line_per_section * BYTES_PER_PIXEL > s2:
            raise ValueError(
                "PAN2 size too small for SECTION & LINE_PER_SECTION argument"
            )
        if s1 != s2:
            raise ValueError("PAN1 size doesn't match PAN2 size")
        self.size_pan = s1
        self.lines_pan = s1 // (self.pixels_per_line * BYTES_PER_PIXEL)
        if self.lines_pan < self.sections * self.line_per_section:
            raise ValueError(
                "PAN line count less than sections times line-per-section, "
                "use smaller -s and/or -l value(s)"
            )
        olog("PAN: %d lines total.", self.lines_pan)
        # like the reference (stitcher.h:79-80): when RRC is skipped the
        # "RRC'd" path is the input path
        self.rrc_file_pan1 = self.pan1
        self.rrc_file_pan2 = self.pan2
        self.delta_x = 0.0
        self.delta_y = 0.0
        self.response = 0.0

    # -- CalcSttParameters (stitcher.h:148-201) -----------------------------
    def calc_stt_parameters(
        self,
        threshold: float = STT_DEF_PHCTHRHLD,
        max_delta_y: float = STT_DEF_MAXDELTAY,
        edge_cols: int = STT_DEF_EDGECOLS,
    ):
        gap = (self.lines_pan - self.sections * self.line_per_section) // (
            self.sections + 1
        )
        step = gap + self.line_per_section
        p1 = raw_io.RawStrip(self.rrc_file_pan1, self.pixels_per_line)
        p2 = raw_io.RawStrip(self.rrc_file_pan2, self.pixels_per_line)

        s1_tiles = []
        s2_tiles = []
        offs = []
        for i in range(self.sections):
            off = gap + i * step
            w1 = p1.section(off, self.line_per_section)
            w2 = p2.section(off, self.line_per_section)
            s1_tiles.append(
                w1[:, self.pixels_per_line - self.overlap_cols : self.pixels_per_line - edge_cols]
            )
            s2_tiles.append(w2[:, edge_cols : self.overlap_cols])
            offs.append(off)

        with stage("stt_correlate"):
            dxs, dys, rss = phasecorr.phase_correlate_batch(
                np.stack(s1_tiles).astype(np.float32),
                np.stack(s2_tiles).astype(np.float32),
            )

        self.delta_x, self.delta_y, self.response = average_valid_deltas(
            dxs, dys, rss, offs, threshold, max_delta_y
        )

    def _pre_stitch_fast(self, src, writer, out_path: str) -> int:
        """Fast-mode constant-shift resample: the translation expressed in
        the alignment-polynomial form (mapx = x + dx <=> cX = [4dx, 0];
        G = dy <=> cY = [4dy, 0, 0]) runs through the blocked-matmul remap over
        the whole strip (true neighbour rows between chunks).  The
        reference's ucut/bcut edge bookkeeping is preserved so output line
        count and placement match SectionaryRemap's."""
        import jax.numpy as jnp
        import math

        cx = np.asarray([4.0 * self.delta_x, 0.0], np.float32)
        cy = np.asarray([4.0 * self.delta_y, 0.0, 0.0], np.float32)
        row_bound = max(3, int(math.ceil(abs(self.delta_y))) + 1)
        ucut = 0 if self.delta_y >= 0.0 else int(-self.delta_y) + 1
        bcut = int(self.delta_y) + 1 if self.delta_y >= 0.0 else 0

        with stage("prestitch_fast", self.size_pan):
            chunk = 8192
            pad = (-self.lines_pan) % chunk
            data = np.asarray(src)
            if pad:
                data = np.concatenate(
                    [data, np.zeros((pad, data.shape[1]), np.uint16)]
                )
            mapped = np.asarray(
                resample.remap_band_fast_chunked(
                    jnp.asarray(data), cx, cy, chunk_rows=chunk,
                    row_bound=row_bound,
                )
            )[: self.lines_pan]
            # SectionaryRemap writes ucut leading rows, then the body, then
            # bcut trailing rows — with whole-strip context the body is just
            # the full remap; keep the same total line count
            writer.write_lines(mapped)
        writer.close()
        self.prestt_file_pan2 = out_path
        olog("Pre-stitched PAN2 (fast) written to file '%s'.", out_path)
        return self.lines_pan - ucut - bcut

    # -- DoRRC (stitcher.h:141-146) -----------------------------------------
    def do_rrc(self):
        self.rrc_file_pan1 = build_output_file_path(
            self.pan1, RRC_STEM_EXT, out_dir=self.out_dir
        )
        self.rrc_file_pan2 = build_output_file_path(
            self.pan2, RRC_STEM_EXT, out_dir=self.out_dir
        )
        from ..io.streaming import stream_process

        for src, par, dst in (
            (self.pan1, self.rrc1, self.rrc_file_pan1),
            (self.pan2, self.rrc2, self.rrc_file_pan2),
        ):
            if not par:
                # the reference fails loudly here (LoadRRCParamFile fopen
                # throws); never silently write uncorrected .RRC.RAW
                raise ValueError("RRC parameter file needed")
            params = jnp.asarray(
                load_split_params(par, self.pixels_per_line)
            )
            strip = raw_io.RawStrip(src, self.pixels_per_line)
            writer = raw_io.RawStripWriter(dst, self.pixels_per_line)
            with stage(f"rrc:{os.path.basename(src)}", strip.nbytes):
                # double-buffered host->HBM sections: the next section's
                # read + H2D overlaps this section's RRC, and the previous
                # result's D2H is deferred one step (io/streaming)
                stream_process(
                    strip,
                    lambda sec: rrc.rrc_apply(sec.data, params),
                    writer.write_lines,
                    REMAP_SECTION_ROWS,
                )
            writer.close()

    # -- PreStitch (stitcher.h:83-139 + SectionaryRemap) --------------------
    def pre_stitch(self) -> int:
        """Constant-shift resample of PAN2, streaming the reference's
        30000-row sections with identical cut bookkeeping; returns output
        line count (SectionaryRemap's return)."""
        out_path = build_output_file_path(
            self.rrc_file_pan2, PRESTT_STEM_EXT, out_dir=self.out_dir
        )
        src = raw_io.RawStrip(self.rrc_file_pan2, self.pixels_per_line)
        writer = raw_io.RawStripWriter(out_path, self.pixels_per_line)
        if self.fast:
            return self._pre_stitch_fast(src, writer, out_path)
        plan = resample.plan_for_constant_shift(
            self.delta_x, self.delta_y, self.pixels_per_line,
            self.quantized_coords,
        )
        ucut = 0 if self.delta_y >= 0.0 else int(-self.delta_y) + 1
        bcut = int(self.delta_y) + 1 if self.delta_y >= 0.0 else 0
        total_cut = ucut + bcut

        row_offset = 0
        last = None
        prev_offset = final_offset = 0
        with stage("prestitch", self.size_pan):
            s = 0
            while True:
                rows = min(REMAP_SECTION_ROWS, self.lines_pan - row_offset)
                if rows <= total_cut:
                    break
                sec = src.section(row_offset, rows)
                mapped = np.asarray(
                    resample.remap_section_u16(jnp.asarray(sec), plan)
                )
                if s == 0 and ucut > 0:
                    writer.write_lines(mapped[:ucut])
                writer.write_lines(mapped[ucut : rows - bcut])
                last = mapped
                prev_offset, final_offset = final_offset, row_offset
                row_offset += rows - total_cut
                s += 1
            if bcut > 0 and last is not None:
                if s >= 2:
                    # Compiled-reference parity (verified byte-exact vs a
                    # harness-built stitcher.h:83-139 binary): the
                    # reference's bottom cut takes dst rows [R-bcut, R) of
                    # the ROLLING 30000-row buffer, whose rows beyond the
                    # final section's fresh read still hold the PREVIOUS
                    # section's data (PreStitch reuses `buff` without
                    # clearing; SectionaryRemap remaps the full buffer).
                    # Reconstruct that buffer window and remap it at the
                    # same phase; rows >= R read border-0, like the Mat
                    # edge.  Single-section strips (< 2 sections) keep the
                    # fresh-tail semantics: the reference rejects them
                    # outright (REMAP_ROW_GUARD), so this is our defined
                    # extension territory.
                    R = REMAP_SECTION_ROWS
                    rows_final = self.lines_pan - final_offset
                    w0 = max(0, R - 2 * bcut - 8)
                    window = np.empty(
                        (R - w0, self.pixels_per_line), np.uint16
                    )
                    fresh_hi = min(rows_final, R)
                    if fresh_hi > w0:
                        window[: fresh_hi - w0] = src.section(
                            final_offset + w0, fresh_hi - w0
                        )
                    if R > fresh_hi:
                        j0 = max(w0, fresh_hi)
                        window[j0 - w0 :] = src.section(
                            prev_offset + j0, R - j0
                        )
                    mapped_w = np.asarray(
                        resample.remap_section_u16(jnp.asarray(window), plan)
                    )
                    writer.write_lines(mapped_w[R - bcut - w0 :])
                else:
                    writer.write_lines(last[last.shape[0] - bcut :])
        writer.close()
        self.prestt_file_pan2 = out_path
        olog("Pre-stitched PAN2 written to file '%s'.", out_path)
        return row_offset


# ---------------------------------------------------------------------------
# stitch writers (imageop.h:277-567)
# ---------------------------------------------------------------------------

def stitch(
    image1: str,
    image2: str,
    output: str = "",
    fold_cols_half: int = 0,
    use_gdal_style: bool = False,
    band_map: list[int] | None = None,
    out_dir: str | None = None,
    pixels_per_line: int = PIXELS_PER_LINE,
    band_interp: bool = False,
) -> str:
    """Static dispatch (Stitcher::Stitch, stitcher.h:21-46): RAW or TIFF."""
    e1 = os.path.splitext(image1)[1].lower()
    e2 = os.path.splitext(image2)[1].lower()
    if e1 != e2:
        raise ValueError("Stitch(): two images should be same type")
    if e1 not in (RAW_FILE_EXT.lower(), TIFF_FILE_EXT.lower(), ".tif"):
        raise ValueError("Stitch(): only RAW and TIFF image supported")
    if e1 == RAW_FILE_EXT.lower():
        return stitch_big_raw(
            image1, image2, output, pixels_per_line, fold_cols_half, out_dir
        )
    return stitch_tiff(
        image1, image2, output, fold_cols_half, use_gdal_style, band_map,
        out_dir, band_interp,
    )


def stitch_big_raw(
    left_path: str,
    right_path: str,
    out_path: str,
    pixels_per_line: int,
    fold_col_pixels: int,
    out_dir: str | None = None,
    block_lines: int = 4096,
) -> str:
    """StitchBigRaw (imageop.h:277-363): per-line ``left[:W-fold]`` then
    ``right[fold:]``; RAW output, or single-band TIFF when the output name
    ends .TIFF.  Streams in multi-line blocks instead of per-line fread."""
    left = raw_io.RawStrip(left_path, pixels_per_line)
    right = raw_io.RawStrip(right_path, pixels_per_line)
    if left.nbytes != right.nbytes:
        raise ValueError(
            f"RAW image sizes not match: left = {left.nbytes} bytes, right = "
            f"{right.nbytes} bytes"
        )
    half = pixels_per_line - fold_col_pixels
    out_px = half * 2
    output_is_tiff = True
    if not out_path:
        out_path = os.path.join(
            out_dir or os.getcwd(),
            f"stitched_{out_px}n{BYTES_PER_PIXEL * 8}b{TIFF_FILE_EXT}",
        )
    else:
        output_is_tiff = os.path.splitext(out_path)[1].lower() in (
            ".tiff", ".tif",
        )

    writer = (
        tiff_io.TiffStripWriter(out_path, out_px, left.lines, samples=1)
        if output_is_tiff
        else raw_io.RawStripWriter(out_path, out_px)
    )
    with stage("stitch_raw", left.nbytes * 2):
        for off in range(0, left.lines, block_lines):
            lb = left.section(off, block_lines)
            rb = right.section(off, block_lines)
            block = np.concatenate(
                [lb[:, :half], rb[:, fold_col_pixels:]], axis=1
            )
            if output_is_tiff:
                writer.write_rows(block)
            else:
                writer.write_lines(block)
    writer.close()
    return out_path


def stitch_tiff(
    left_path: str,
    right_path: str,
    out_path: str,
    fold_col_pixels: int,
    use_gdal_style: bool = False,
    band_map: list[int] | None = None,
    out_dir: str | None = None,
    band_interp: bool = False,
) -> str:
    """StitchTiff / StitchTiffGDAL (imageop.h:365-567): concatenate two
    multi-band TIFFs minus the fold columns; the GDAL-style path streams
    20000-line sections and writes LZW + predictor-2 (BigTIFF when large),
    with the optional 1-based band remap ('-m 3,2,1,4').

    ``band_interp`` tags the 4-band output's color interpretation the way
    StitchTiffGDAL's ``setBandInterpretion`` does (R/G/B/Alpha,
    imageop.h:508-530): PHOTOMETRIC=RGB plus EXTRASAMPLES=2 (unassociated
    alpha) — the tag GDAL emits for a GCI_AlphaBand fourth band."""
    if not out_path:
        out_path = os.path.join(out_dir or os.getcwd(), f"stitched{TIFF_FILE_EXT}")
    elif os.path.splitext(out_path)[1].lower() not in (".tiff", ".tif"):
        raise ValueError("Output file should be a tiff image")

    li = tiff_io.read_tiff_info(left_path)
    ri = tiff_io.read_tiff_info(right_path)
    if (li.height, li.width) != (ri.height, ri.width):
        raise RuntimeError("images have different sizes")
    if li.samples != ri.samples:
        raise RuntimeError("images have different sizes")
    half = li.width - fold_col_pixels
    out_px = half * 2
    samples = li.samples
    big_input = li.height * out_px * samples * 2 >= 4_000_000_000

    use_gdal_style = use_gdal_style or big_input
    writer = tiff_io.TiffStripWriter(
        out_path,
        out_px,
        li.height,
        samples=samples,
        compression="lzw" if use_gdal_style else "none",
        predictor=use_gdal_style,
        rows_per_strip=512,
        extrasamples=2 if (band_interp and samples == 4) else None,
    )
    # stream both inputs section-by-section (never materialising either,
    # like StitchTiffGDAL's per-band RasterIO loop, imageop.h:489-558);
    # memory is bounded by one section regardless of raster size
    section = min(IBPA_DEFAULT_BATCHLINES, 2048)
    with stage("stitch_tiff", li.height * out_px * samples * 2):
        for bl, br in zip(
            tiff_io.iter_tiff_rows(left_path, section),
            tiff_io.iter_tiff_rows(right_path, section),
        ):
            block = np.concatenate(
                [bl[:, :half], br[:, fold_col_pixels:]], axis=1
            )
            if band_map is not None:
                block = block[:, :, [m - 1 for m in band_map]]
            writer.write_rows(block)
    writer.close()
    return out_path
