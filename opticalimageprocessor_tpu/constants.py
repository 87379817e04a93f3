"""Data-model constants for the Taijing-3-class dual-CMOS push-broom camera.

These mirror the compile-time knobs of the reference implementation
(`/root/reference/OpticalImageProcessor/oipshared.h:27-64`) so that default
behaviour is interchangeable.  Every algorithm default below is overridable
through the CLI flags (``cli.py``) and the model constructors' keyword args.
"""

# ---------------------------------------------------------------------------
# Raster geometry (oipshared.h:27-32)
# ---------------------------------------------------------------------------
BYTES_PER_PIXEL = 2                  # uint16, little endian
PIXELS_PER_LINE = 12288              # PAN detector width
BYTES_PER_PANLINE = PIXELS_PER_LINE * BYTES_PER_PIXEL
MSS_BANDS = 4
PIXELS_PER_MSSBAND = PIXELS_PER_LINE // MSS_BANDS   # 3072
BYTES_PER_MSSBAND = BYTES_PER_PIXEL * PIXELS_PER_MSSBAND

# ---------------------------------------------------------------------------
# Inter-band correlation defaults (oipshared.h:33-39)
# ---------------------------------------------------------------------------
CORRELATION_LINES = 16000
IBCV_DEF_THRESHOLD = 0.4             # minimum phase-correlation response
IBCV_MIN_COUNT = 5                   # minimum valid samples before polyfit
IBCV_DEF_SECTIONS = 5
IBCV_DEF_SLICES = 10
IBCV_MIN_SLICES = 8

# ---------------------------------------------------------------------------
# Inter-band pixel alignment defaults (oipshared.h:41-46)
# ---------------------------------------------------------------------------
IBPA_DEFAULT_LINEOFFSET = 0
IBPA_DEFAULT_BATCHLINES = 20000
IBPA_DEFAULT_LINEOVERLAP = 520
IBPA_MAX_LINEOVERLAP = 3000
IBPA_MIN_PROCESSLINES = 1500

# OpenCV-remap row limits honoured by the reference (imageop.h:19-20).  The
# device kernels have no such limit, but the section sizes remain the unit of
# host<->HBM streaming and of cross-device sharding.
REMAP_ROW_GUARD = 32767
REMAP_SECTION_ROWS = 30000

# ---------------------------------------------------------------------------
# CMOS stitching defaults (oipshared.h:48-54)
# ---------------------------------------------------------------------------
STT_DEF_SECTIONS = 10
STT_DEF_SECLINES = 16000
STT_DEF_OVERLAPPX = 200
STT_DEF_PHCTHRHLD = 0.4
STT_DEF_MAXDELTAY = 0.0
STT_DEF_EDGECOLS = 0

# ---------------------------------------------------------------------------
# File-name stem-extension conventions (oipshared.h:56-64)
# ---------------------------------------------------------------------------
STT_STEM_EXT = ".STT"
PRESTT_STEM_EXT = ".PRESTT"
RRC_STEM_EXT = ".RRC"
IBPA_STEM_EXT = ".ALIGNED"
TIFF_FILE_EXT = ".TIFF"
RAW_FILE_EXT = ".RAW"
AUX_FILE_EXT = ".AUX"
STEM_EXT_PAN = ".PAN"
STEM_EXT_MSS = ".MSS"
