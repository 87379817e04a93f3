"""Command-line interface, argument-compatible with the reference binary
(``main.cpp:92-268``): subcommands ``auxsep`` / ``prestitch`` / ``stitch``
plus the default inter-band registration+alignment action, with the same
flag names, defaults, dependency rules, and exit codes (254 usage error /
2 runtime error / 1 unknown; main.cpp:320-343), so ``DOC/sample-task.sh``
workflows port directly.
"""

from __future__ import annotations

import argparse
import sys

from . import constants as C


def _build_default_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oiptpu",
        description=(
            "Optical Satellite Image Pre-Processing/Processing Utility "
            "on JAX.  Without a subcommand, runs the inter-band "
            "registration + alignment action."
        ),
        epilog=(
            "subcommands (run 'oiptpu <subcommand> --help' for options): "
            "auxsep (downlink AUX/image separation), prestitch (dual-CMOS "
            "stitch parameters + PAN2 correction), stitch (concatenate the "
            "CMOS halves), scene (the whole scene as fused device programs)"
        ),
    )
    p.add_argument("-v", "--version", action="version", version="1.1")
    p.add_argument("--pan", default="", help="PAN raw image file path")
    p.add_argument(
        "--do-rrc4pan", action="store_true",
        help="Whether or not do Relative Radiometric Correction for PAN",
    )
    p.add_argument(
        "--rrc-pan", default="",
        help="Relative Radiometric Correction parameter file path for PAN image",
    )
    p.add_argument(
        "--write-rrcpan", dest="write_rrcpan", action="store_true",
        help="Whether or not write RRC PAN data as tiff image file",
    )
    p.add_argument("--no-rrcpan", dest="write_rrcpan", action="store_false")
    p.add_argument("--mss", default="", help="MSS raw image file path")
    p.add_argument(
        "--no-rrc4mss", dest="do_rrc4mss", action="store_false", default=True,
        help="Skip Relative Radiometric Correction for MSS",
    )
    for b in range(1, 5):
        p.add_argument(
            f"--rrc-msb{b}", default="",
            help=(
                "Relative Radiometric Correction parameter file path for "
                f"MSS band #{b} (1-based band NO.)"
            ),
        )
    p.add_argument("--slices", type=int, default=C.IBCV_DEF_SLICES)
    p.add_argument("--ibc-sections", type=int, default=C.IBCV_DEF_SECTIONS)
    p.add_argument("--ibc-threshold", type=float, default=C.IBCV_DEF_THRESHOLD)
    p.add_argument("--line-offset", type=int, default=C.IBPA_DEFAULT_LINEOFFSET)
    p.add_argument("--lines-section", type=int, default=C.IBPA_DEFAULT_BATCHLINES)
    p.add_argument("--overlap-lines", type=int, default=C.IBPA_DEFAULT_LINEOVERLAP)
    p.add_argument("-k", "--keep-leading", action="store_true", default=False)
    p.add_argument("--out-dir", default=None, help="output directory (default cwd)")
    p.add_argument(
        "--coord-mode", choices=["continuous", "quantized"], default="continuous",
        help="resample coordinate convention (OpenCV 5.x / <=4.x parity)",
    )
    p.add_argument(
        "--fast", action="store_true", default=False,
        help=(
            "fast resample mode (blocked matmuls, whole-strip "
            "streaming; within 1 DN of the parity path)"
        ),
    )
    p.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help=(
            "run the align pipeline SPMD over an N-device line mesh "
            "(0 = single device; fast-mode remap semantics)"
        ),
    )
    p.add_argument(
        "--profile", default="", metavar="DIR",
        help=(
            "write a JAX device profile (TensorBoard trace) of the run to "
            "DIR"
        ),
    )
    return p


class UsageError(ValueError):
    pass


def _require_file(path: str, opt: str) -> None:
    """Parse-time ExistingFile check (CLI11 ->check(CLI::ExistingFile),
    main.cpp:105/114-119/193-223): fail with a usage error (rc 254) before
    any work starts."""
    import os

    if path and not os.path.isfile(path):
        raise UsageError(f"{opt}: File does not exist: {path}")


def _default_action(a) -> int:
    if not (0.0 <= a.ibc_threshold < 1.0):
        raise UsageError("invalid threshold value")
    # CLI11 ->needs(rrc4pan) parity (main.cpp:198-203): the orphan flags
    # are usage errors at parse time, not silently ignored
    if a.rrc_pan and not a.do_rrc4pan:
        raise UsageError("--rrc-pan needs --do-rrc4pan")
    if a.write_rrcpan and not a.do_rrc4pan:
        raise UsageError("--write-rrcpan needs --do-rrc4pan")
    if a.do_rrc4pan and not a.rrc_pan:
        raise UsageError("RRC parameter file of PAN needed")
    rrc_mss = (a.rrc_msb1, a.rrc_msb2, a.rrc_msb3, a.rrc_msb4)
    if a.do_rrc4mss and any(not f for f in rrc_mss):
        raise UsageError("RRC parameter file of all MSS Bands needed")
    _require_file(a.pan, "--pan")
    _require_file(a.mss, "--mss")
    _require_file(a.rrc_pan, "--rrc-pan")
    for i, f in enumerate(rrc_mss, 1):
        _require_file(f, f"--rrc-msb{i}")

    from .utils.logging import device_profile

    with device_profile(a.profile):
        if a.mesh:
            from .models.sharded_align import run_sharded_align

            run_sharded_align(
                a.pan, a.mss, a.rrc_pan, rrc_mss, n_devices=a.mesh,
                do_rrc_pan=a.do_rrc4pan, do_rrc_mss=a.do_rrc4mss,
                slices=a.slices, sections=a.ibc_sections,
                threshold=a.ibc_threshold, line_offset=a.line_offset,
                section_overlap=a.overlap_lines,
                keep_leading_lines=a.keep_leading, out_dir=a.out_dir,
                quantized_coords=a.coord_mode == "quantized",
                write_rrcpan=a.do_rrc4pan and a.write_rrcpan,
            )
            return 0

        from .models.preprocessor import PreProcessor

        pp = PreProcessor(
            a.pan, a.mss, a.rrc_pan, rrc_mss, out_dir=a.out_dir,
            quantized_coords=a.coord_mode == "quantized",
            fast=a.fast,
        )
        pp.load_and_rrc(do_rrc_pan=a.do_rrc4pan, do_rrc_mss=a.do_rrc4mss)
        if a.do_rrc4pan and a.write_rrcpan:
            pp.write_rrc_pan_tiff(a.line_offset)
        pp.calc_inter_band_correlation(
            a.slices, a.ibc_sections, a.ibc_threshold
        )
        pp.do_inter_band_alignment(
            a.lines_section, a.line_offset, a.overlap_lines, a.keep_leading
        )
        return 0


def _auxsep(argv) -> int:
    p = argparse.ArgumentParser(prog="oiptpu auxsep",
                                description="Do aux & image data separation")
    p.add_argument("-O", "--offset", type=int, default=0,
                   help="Parse AOS file from specified byte offset")
    p.add_argument("file", help="AOS or IMDT file path")
    p.add_argument("--out-dir", default=None)
    a = p.parse_args(argv)
    _require_file(a.file, "file")

    from .models.auxsep import AuxSeparator

    AuxSeparator(a.file, a.offset, out_dir=a.out_dir).separate()
    return 0


def _prestitch(argv) -> int:
    p = argparse.ArgumentParser(
        prog="oiptpu prestitch",
        description=(
            "Do preparation parameters calculating & PAN2 pixel correction "
            "for CMOS stitching"
        ),
    )
    p.add_argument("--pan1", required=True)
    p.add_argument("--pan2", required=True)
    p.add_argument("--rrc1", default="")
    p.add_argument("--rrc2", default="")
    p.add_argument("-s", "--sections", type=int, default=C.STT_DEF_SECTIONS)
    p.add_argument("-l", "--section-lines", type=int, default=C.STT_DEF_SECLINES)
    p.add_argument("--stitch-overlap", type=int, default=C.STT_DEF_OVERLAPPX)
    p.add_argument("--stt-threshold", type=float, default=C.STT_DEF_PHCTHRHLD)
    p.add_argument("--stt-maxdeltay", type=float, default=C.STT_DEF_MAXDELTAY)
    p.add_argument("-e", "--edge-cols", type=int, default=C.STT_DEF_EDGECOLS)
    p.add_argument("-r", "--rrc", dest="do_rrc", action="store_true", default=True)
    p.add_argument("--no-rrc", dest="do_rrc", action="store_false")
    p.add_argument("-c", "--only-calculate", action="store_true", default=False)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--coord-mode", choices=["continuous", "quantized"],
                   default="continuous")
    p.add_argument("--fast", action="store_true", default=False,
                   help="fast constant-shift resample")
    p.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help=(
            "run the prestitch pipeline SPMD over an N-device line mesh "
            "(0 = single device; fast-mode remap semantics)"
        ),
    )
    p.add_argument(
        "--profile", default="", metavar="DIR",
        help=(
            "write a JAX device profile (TensorBoard trace) of the run to "
            "DIR"
        ),
    )
    a = p.parse_args(argv)
    if a.edge_cols < 0 or a.edge_cols > a.stitch_overlap // 2:
        raise UsageError("invalid edge cols")
    _require_file(a.pan1, "--pan1")
    _require_file(a.pan2, "--pan2")
    _require_file(a.rrc1, "--rrc1")
    _require_file(a.rrc2, "--rrc2")

    from .utils.logging import device_profile

    with device_profile(a.profile):
        if a.mesh:
            from .models.sharded_prestitch import run_sharded_prestitch

            run_sharded_prestitch(
                a.pan1, a.pan2, a.rrc1, a.rrc2, n_devices=a.mesh,
                sections=a.sections, line_per_section=a.section_lines,
                overlap_cols=a.stitch_overlap, threshold=a.stt_threshold,
                max_delta_y=a.stt_maxdeltay, edge_cols=a.edge_cols,
                do_rrc=a.do_rrc, only_calculate=a.only_calculate,
                out_dir=a.out_dir,
            )
            return 0

        from .models.stitcher import Stitcher

        st = Stitcher(
            a.pan1, a.pan2, a.rrc1, a.rrc2, a.sections, a.section_lines,
            a.stitch_overlap, out_dir=a.out_dir,
            quantized_coords=a.coord_mode == "quantized",
            fast=a.fast,
        )
        st.calc_stt_parameters(a.stt_threshold, a.stt_maxdeltay, a.edge_cols)
        if not a.only_calculate:
            if a.do_rrc:
                st.do_rrc()
            st.pre_stitch()
        return 0


def _scene(argv) -> int:
    p = argparse.ArgumentParser(
        prog="oiptpu scene",
        description=(
            "Whole-scene fused pipeline: RRC + registration + alignment + "
            "prestitch + stitch in ONE device program (fast-mode semantics; "
            "scene must fit in HBM)"
        ),
    )
    p.add_argument("--pan1", required=True, help="CMOS1 PAN raw image")
    p.add_argument("--pan2", required=True, help="CMOS2 PAN raw image")
    p.add_argument("--mss", required=True, help="CMOS1 MSS raw image")
    p.add_argument("--rrc-pan1", default="", help="RRC CSV for PAN1")
    p.add_argument("--rrc-pan2", default="", help="RRC CSV for PAN2")
    for b in range(1, 5):
        p.add_argument(f"--rrc-msb{b}", default="",
                       help=f"RRC CSV for CMOS1 MSS band #{b}")
    p.add_argument(
        "--mss2", default="",
        help=(
            "CMOS2 MSS raw image: also align it against the prestitched "
            "PAN2 and stitch the MSS pair (the full sample-task workflow)"
        ),
    )
    for b in range(1, 5):
        p.add_argument(f"--rrc-m2b{b}", default="",
                       help=f"RRC CSV for CMOS2 MSS band #{b}")
    p.add_argument("--out-mss", default="",
                   help="stitched MSS output TIFF (with --mss2)")
    p.add_argument("--slices", type=int, default=C.IBCV_DEF_SLICES)
    p.add_argument("--ibc-sections", type=int, default=0,
                   help="registration sections (0 = auto from strip length)")
    p.add_argument("-c", "--fold-cols", type=int, default=C.STT_DEF_OVERLAPPX)
    p.add_argument("-s", "--stt-sections", type=int, default=C.STT_DEF_SECTIONS)
    p.add_argument("--ibc-threshold", type=float, default=C.IBCV_DEF_THRESHOLD)
    p.add_argument("--stt-threshold", type=float, default=C.STT_DEF_PHCTHRHLD)
    p.add_argument("--stt-maxdeltay", type=float, default=C.STT_DEF_MAXDELTAY)
    p.add_argument("-o", "--out", default="",
                   help="stitched PAN output (.TIFF or .RAW)")
    p.add_argument("--out-dir", default=None)
    p.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help=(
            "run the fused scene pipeline SPMD over an N-device line mesh "
            "(0 = single device; same fast-mode semantics)"
        ),
    )
    p.add_argument(
        "--stream", action="store_true", default=False,
        help=(
            "stream the scene in sections (bounded HBM/host RSS for "
            "scenes larger than device memory; bit-identical outputs; "
            "combine with --mesh N to shard each section over the mesh "
            "for scenes beyond N x HBM)"
        ),
    )
    p.add_argument(
        "--stream-section-lines", type=int, default=4096,
        help="PAN lines per streamed section (with --stream)",
    )
    p.add_argument(
        "--profile", default="", metavar="DIR",
        help=(
            "write a JAX device profile (TensorBoard trace) of the run to "
            "DIR — device-level observability on top of the per-stage "
            "MB/s report"
        ),
    )
    a = p.parse_args(argv)
    if a.fold_cols < 2:
        raise UsageError("fold column value too small")
    if not (0.0 <= a.ibc_threshold < 1.0) or not (
        0.0 <= a.stt_threshold < 1.0
    ):
        raise UsageError("invalid threshold value")
    rrc_mss = (a.rrc_msb1, a.rrc_msb2, a.rrc_msb3, a.rrc_msb4)
    rrc_mss2 = (a.rrc_m2b1, a.rrc_m2b2, a.rrc_m2b3, a.rrc_m2b4)
    if any(rrc_mss2) and not a.mss2:
        raise UsageError("--rrc-m2b* needs --mss2")
    if a.out_mss and not a.mss2:
        raise UsageError("--out-mss needs --mss2")
    for opt, f in (
        ("--pan1", a.pan1), ("--pan2", a.pan2), ("--mss", a.mss),
        ("--mss2", a.mss2),
        ("--rrc-pan1", a.rrc_pan1), ("--rrc-pan2", a.rrc_pan2),
        *[(f"--rrc-msb{i}", f) for i, f in enumerate(rrc_mss, 1)],
        *[(f"--rrc-m2b{i}", f) for i, f in enumerate(rrc_mss2, 1)],
    ):
        _require_file(f, opt)

    common = dict(
        mss2_file=a.mss2, rrc_mss2_files=rrc_mss2,
        slices=a.slices, sections=a.ibc_sections or None,
        fold_cols=a.fold_cols, stt_sections=a.stt_sections,
        threshold=a.ibc_threshold, stt_threshold=a.stt_threshold,
        stt_max_delta_y=a.stt_maxdeltay,
        out_stitched=a.out, out_stitched_mss=a.out_mss, out_dir=a.out_dir,
    )
    common["profile_dir"] = a.profile
    if a.stream:
        from .models.scene_stream import run_scene_streamed

        run_scene_streamed(
            a.pan1, a.pan2, a.mss, a.rrc_pan1, a.rrc_pan2, rrc_mss,
            section_rows=a.stream_section_lines, mesh=a.mesh, **common,
        )
        return 0
    from .models.scene import run_scene

    run_scene(
        a.pan1, a.pan2, a.mss, a.rrc_pan1, a.rrc_pan2, rrc_mss,
        mesh=a.mesh, **common,
    )
    return 0


def _stitch(argv) -> int:
    p = argparse.ArgumentParser(prog="oiptpu stitch",
                                description="Stitch two PAN or MSS images.")
    p.add_argument("--image1", required=True, help="Left image file path")
    p.add_argument("--image2", required=True, help="Right image file path")
    p.add_argument("-o", "--out", default="")
    p.add_argument("-c", "--fold-cols", type=int, required=True,
                   help="Folding cols (in pixel) when stitching two images")
    p.add_argument("-g", "--GDAL", dest="use_gdal", action="store_true",
                   default=False)
    p.add_argument("-m", "--band-map", default="",
                   help="Map output band order (1-based), i.e '3,2,1,4'")
    p.add_argument(
        "--band-interp", action="store_true", default=False,
        help=(
            "tag 4-band TIFF output bands R/G/B/Alpha "
            "(StitchTiffGDAL setBandInterpretion; implies -g)"
        ),
    )
    p.add_argument("--out-dir", default=None)
    a = p.parse_args(argv)
    if a.fold_cols < 2:
        raise UsageError("fold column value too small")
    band_map = None
    if a.band_map:
        if not a.use_gdal:
            raise UsageError("-m needs -g")
        parts = a.band_map.split(",")
        if len(parts) != 4:
            raise UsageError("need 4 band indices")
        band_map = [int(x) for x in parts]
        if any(m <= 0 or m > C.MSS_BANDS for m in band_map):
            raise UsageError("invalid band index")

    from .models.stitcher import stitch

    stitch(
        a.image1, a.image2, a.out, a.fold_cols // 2,
        a.use_gdal or a.band_interp, band_map,
        out_dir=a.out_dir, band_interp=a.band_interp,
    )
    return 0


CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str | None:
    """Where this program puts JAX's persistent compilation cache: None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself), else
    a fixed directory inside the checkout (the path is part of the cache
    key, so it must not move between runs)."""
    import os

    if os.environ.get(CACHE_ENV):
        return None
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache: repeated scene runs skip the
    (minutes-long) kernel compilation."""
    # multi-host launch: when the OIP_DIST_* env is present, join the
    # cross-process coordination service before the first backend use so
    # jax.devices() spans every process's devices.  A misconfigured launch
    # must fail loudly here, or N processes would each run single-process
    # and race on the shared output files.
    from .parallel.distributed import maybe_initialize_distributed

    maybe_initialize_distributed()

    cache = compile_cache_dir()
    if cache is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", cache)


def _print_stage_report() -> None:
    """Per-stage seconds/MBps summary (the reference's ubiquitous
    stop_watch/comma_sep instrumentation, aggregated)."""
    from .utils.logging import olog, stage_report

    rep = stage_report()
    if not rep:
        return
    olog("==== stage report ====")
    for name, st in rep.items():
        olog(
            "%-24s %8.3f s  %10.1f MBps  (%d calls)",
            name, st["seconds"], st["MBps"] if st["bytes"] else 0.0,
            st["calls"],
        )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    _enable_compile_cache()
    try:
        if argv and argv[0] == "auxsep":
            rc = _auxsep(argv[1:])
        elif argv and argv[0] == "prestitch":
            rc = _prestitch(argv[1:])
        elif argv and argv[0] == "stitch":
            rc = _stitch(argv[1:])
        elif argv and argv[0] == "scene":
            rc = _scene(argv[1:])
        else:
            a = _build_default_parser().parse_args(argv)
            rc = _default_action(a)
        _print_stage_report()
        return rc
    except UsageError as e:
        print(f"USAGE ERROR: {e}.")
        return 254
    except (ValueError, RuntimeError, OSError) as e:
        from .utils.logging import loge

        loge("%s.", e)
        return 2
    except Exception:  # noqa: BLE001 — reference maps unknown errors to 1
        from .utils.logging import loge

        loge("UNKOWN FATAL ERROR OCCURED.")
        return 1


if __name__ == "__main__":
    sys.exit(main())
