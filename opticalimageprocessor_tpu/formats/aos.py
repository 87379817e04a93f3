"""CCSDS-AOS downlink frame formats: AOS / image-transfer (IMTR) / image frames.

Binary layout transcribed from the format-constant blocks of the reference
(``aux_separator.h:29-138``) and its parsing logic (``aux_separator.h:395-690``).
This module is pure host-side numpy and provides:

* vectorised scanners/validators (whole-buffer, batch CRC) replacing the
  reference's byte-at-a-time two-thread loop;
* synthetic frame *builders* used by the golden-file tests (the reference has
  no tests; the builders let us round-trip the full auxsep pipeline).

Byte-order note: all multi-byte downlink fields are big-endian except the
Z-image header's field delimiter which is read with native (little) endianness
(aux_separator.h:601-602).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .crc16 import crc16_ccitt_false

# --- AOS physical frames (aux_separator.h:29-57) ---------------------------
SYNC_BYTES = b"\x1a\xcf\xfc\x1d"
AOS_FRAME_BYTES = 1024
AOS_HEADER_OFF = 4
AOS_HEADER_BYTES = 6
AOS_VCID_OFF = 5
AOS_VCID_MASK = 0x3F
AOS_VCID_EMPTY = 0x3F
AOS_VCDUSEQ_OFF = 6          # 24-bit big-endian sequence counter
AOS_VCDUINJ_OFF = 10
AOS_VCDUINJ_INVAL = 0xAAAAAAAA
AOS_VCDUINJ_VALID = 0x00000000
AOS_DATA_OFF = 14
AOS_DATA_BYTES = 880
AOS_CRC_OFF = 894            # CRC-16/CCITT-FALSE over bytes [4, 894)
AOS_LDPC_OFF = 896
AOS_LDPC_BYTES = 128         # carried but never checked (aux_separator.h:688)

AOS_FRAME_INVALID = -1
AOS_FRAME_EMPTY = 0
AOS_FRAME_VALID = 1

# --- image-transfer frames, reassembled from AOS payload bytes
#     (aux_separator.h:60-78) ----------------------------------------------
IMTR_SIG = b"\x49\x54\xce\x1f"
IMTR_FRAME_BYTES = 882
IMTR_SEQ_OFF = 4             # u32 BE
IMTR_CHID_OFF = 8
IMTR_CHID_CMOS1 = 0x11
IMTR_CHID_CMOS2 = 0x22
IMTR_DTMARK_OFF = 9
IMTR_DTMARK_IMG = 0x22
IMTR_IMGDATA_OFF = 10
IMTR_IMGDATA_BYTES = 866
IMTR_CRC_OFF = 876           # CRC-16/CCITT-FALSE over bytes [0, 876)
IMTR_ENDSIG = b"\x2e\xe9\xc8\xfd"
IMTR_ENDSIG_OFF = 878

# --- image frames inside the IMDT byte stream (aux_separator.h:80-118) -----
IMGSIG_SIG = b"\xeb\x90\xe1\x4d"
IMGSIG_AUX_LINES = 1024
IMGSIG_AUX_BYTES = 48
IMGSIG_AUX_ALLBYTES = IMGSIG_AUX_BYTES * IMGSIG_AUX_LINES  # 49152
IMGSIG_IMG_HPARTS = 8
IMGSIG_PAN_VPARTS = 4
IMGSIG_MSS_VPARTS = 1
IMGSIG_PAN_LINES = 1024
IMGSIG_MSS_LINES = 256
IMGSIG_IMBASE_LINES = 256
IMGSIG_IMBASE_COLS = 1536
IMGSIG_META_BYTES = 172
IMGSIG_CAM_OFF = 4
IMGSIG_FID_OFF = 5
IMGSIG_SEQ_OFF = 6           # u16 BE
IMGSIG_IMGSZ_OFF = 8         # u32 BE, total image dwords of the frame
IMGSIG_SUBIML_OFF = 12       # 40 x u32 BE per-sub-image dword counts
IMGSIG_SUBIML_COUNT = 40

IMGSIG_ZRTO_NONE = 0         # uncompressed; other values = JP2 ratios

# --- per-sub-image compressed block header (aux_separator.h:120-138) -------
Z_EVEN_FRAME = 0xFFFFFFF0
Z_ODD_FRAME = 0xFFFFFFF1
Z_IMGIDX_OFF = 4             # u32 BE
Z_ZFORMAT_OFF = 8
Z_ZFORMAT_JP2 = 0x04
Z_VFORMAT_OFF = 9
Z_HDRVER_OFF = 11
Z_HDRVER_VALUE = 0x02
Z_DATADWORDS_OFF = 12        # u32 BE
Z_ZDATA_OFF = 16

SUB_IMAGE_BYTES = IMGSIG_IMBASE_LINES * IMGSIG_IMBASE_COLS * 2  # 786432


@dataclass
class AosScanResult:
    """Offsets (into the scanned buffer) of frame starts, by category."""

    valid: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    empty: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    invalid: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # byte position just past the last consumed frame/signature — the
    # resume point when scanning a long downlink in chunks
    cursor: int = 0


def find_signatures(buf: np.ndarray, sig: bytes, start: int = 0) -> np.ndarray:
    """All offsets of ``sig`` in ``buf`` (uint8 1-D), vectorised memmem."""
    buf = np.ascontiguousarray(buf)
    n = buf.shape[0]
    if n < len(sig):
        return np.zeros(0, dtype=np.int64)
    mask = buf[start : n - len(sig) + 1] == sig[0]
    for j, b in enumerate(sig[1:], 1):
        mask &= buf[start + j : n - len(sig) + 1 + j] == b
    return np.nonzero(mask)[0] + start


def scan_aos_frames(buf: np.ndarray) -> AosScanResult:
    """Scan an AOS byte buffer, reproducing the reference state machine.

    The reference (aux_separator.h:421-461) repeatedly memmem's for the sync
    marker; a frame that validates advances the cursor by 1024 bytes, an
    invalid/empty one advances past the 4 sync bytes only.  We replicate that
    by walking the (pre-computed, vectorised) sorted signature offsets.
    Frames needing bytes beyond the buffer end are ignored (NextAosFrame
    returns NULL when fewer than 1024 bytes remain).
    """
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    from ..utils import native

    sigs = native.find_signatures(buf, SYNC_BYTES)
    sigs = sigs[sigs + AOS_FRAME_BYTES <= buf.shape[0]]
    if sigs.size == 0:
        return AosScanResult()

    # Batch-validate every candidate with per-field gathers (no full-frame
    # copies), then emulate the cursor walk.
    def field(off):
        return buf[sigs + off]

    vcid = field(AOS_VCID_OFF) & AOS_VCID_MASK
    inj = (
        (field(AOS_VCDUINJ_OFF).astype(np.uint32) << 24)
        | (field(AOS_VCDUINJ_OFF + 1).astype(np.uint32) << 16)
        | (field(AOS_VCDUINJ_OFF + 2).astype(np.uint32) << 8)
        | field(AOS_VCDUINJ_OFF + 3).astype(np.uint32)
    )
    crc_stored = (field(AOS_CRC_OFF).astype(np.uint16) << 8) | field(
        AOS_CRC_OFF + 1
    ).astype(np.uint16)
    crc_calc = native.crc16_many(
        buf, sigs + AOS_HEADER_OFF, AOS_CRC_OFF - AOS_HEADER_OFF
    )

    status = np.full(sigs.size, AOS_FRAME_INVALID, dtype=np.int8)
    ok_inj = (inj == AOS_VCDUINJ_INVAL) | (inj == AOS_VCDUINJ_VALID)
    is_empty = (inj == AOS_VCDUINJ_INVAL) & (vcid == AOS_VCID_EMPTY)
    is_valid = ok_inj & ~is_empty & (crc_calc == crc_stored)
    status[is_empty] = AOS_FRAME_EMPTY
    status[is_valid] = AOS_FRAME_VALID

    # Cursor walk over candidates: skip signatures that fall inside an
    # already-consumed valid frame.
    valid_offs, empty_offs, invalid_offs = [], [], []
    cursor = 0
    for off, st in zip(sigs.tolist(), status.tolist()):
        if off < cursor:
            continue
        if st == AOS_FRAME_VALID:
            valid_offs.append(off)
            cursor = off + AOS_FRAME_BYTES
        elif st == AOS_FRAME_EMPTY:
            empty_offs.append(off)
            cursor = off + len(SYNC_BYTES)
        else:
            invalid_offs.append(off)
            cursor = off + len(SYNC_BYTES)
    return AosScanResult(
        valid=np.asarray(valid_offs, dtype=np.int64),
        empty=np.asarray(empty_offs, dtype=np.int64),
        invalid=np.asarray(invalid_offs, dtype=np.int64),
        cursor=cursor,
    )


def extract_aos_payloads(buf: np.ndarray, valid_offsets: np.ndarray) -> np.ndarray:
    """Gather the 880-byte payloads of validated AOS frames → (n, 880) u8."""
    from ..utils import native

    return native.gather_blocks(
        buf, np.asarray(valid_offsets) + AOS_DATA_OFF, AOS_DATA_BYTES
    )


@dataclass
class ImtrParseResult:
    payload: np.ndarray            # (n_valid, 866) uint8 image payload bytes
    seq: np.ndarray                # (n_valid,) uint32
    chid: int = 0                  # channel id of the first valid frame
    n_frames: int = 0              # total 882-byte frames cut from the stream
    n_invalid: int = 0
    missing_ranges: list[tuple[int, int]] = field(default_factory=list)


def parse_imtr_stream(
    stream: np.ndarray, last_seq: int = 0
) -> ImtrParseResult:
    """Cut 882-byte image-transfer frames from the concatenated AOS payload
    byte stream and validate them (aux_separator.h:469-556).

    The reference cuts fixed-size frames with *no* resynchronisation: an
    invalid frame is dropped and the cut continues at the next 882-byte
    boundary.  Sequence gaps are recorded (reference logs a warning,
    aux_separator.h:530-533); ``last_seq`` seeds the gap detection so a
    long downlink can be parsed in chunks.
    """
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    n = stream.shape[0] // IMTR_FRAME_BYTES
    if n == 0:
        return ImtrParseResult(
            payload=np.zeros((0, IMTR_IMGDATA_BYTES), np.uint8),
            seq=np.zeros(0, np.uint32),
        )
    frames = stream[: n * IMTR_FRAME_BYTES].reshape(n, IMTR_FRAME_BYTES)

    ok = np.all(frames[:, :4] == np.frombuffer(IMTR_SIG, np.uint8), axis=1)
    ok &= np.all(
        frames[:, IMTR_ENDSIG_OFF : IMTR_ENDSIG_OFF + 4]
        == np.frombuffer(IMTR_ENDSIG, np.uint8),
        axis=1,
    )
    ok &= frames[:, IMTR_DTMARK_OFF] == IMTR_DTMARK_IMG
    crc_stored = (frames[:, IMTR_CRC_OFF].astype(np.uint16) << 8) | frames[
        :, IMTR_CRC_OFF + 1
    ].astype(np.uint16)
    from ..utils import native

    crc_calc = native.crc16_many(
        stream[: n * IMTR_FRAME_BYTES],
        np.arange(n, dtype=np.int64) * IMTR_FRAME_BYTES,
        IMTR_CRC_OFF,
    )
    ok &= crc_calc == crc_stored

    seq = (
        (frames[:, IMTR_SEQ_OFF].astype(np.uint32) << 24)
        | (frames[:, IMTR_SEQ_OFF + 1].astype(np.uint32) << 16)
        | (frames[:, IMTR_SEQ_OFF + 2].astype(np.uint32) << 8)
        | frames[:, IMTR_SEQ_OFF + 3].astype(np.uint32)
    )
    valid_idx = np.nonzero(ok)[0]
    vseq = seq[valid_idx]
    # vectorised sequence-gap detection (the per-frame python walk costs
    # ~1 s on a 200k-frame downlink)
    if vseq.size:
        prev = np.concatenate(
            [[np.uint32(last_seq)], vseq[:-1]]
        ).astype(np.int64)
        gap_at = np.nonzero(vseq.astype(np.int64) != prev + 1)[0]
        missing = [
            (int(prev[i]) + 1, int(vseq[i]) - 1) for i in gap_at.tolist()
        ]
    else:
        missing = []
    chid = int(frames[valid_idx[0], IMTR_CHID_OFF]) if valid_idx.size else 0
    body = frames[:, IMTR_IMGDATA_OFF : IMTR_IMGDATA_OFF + IMTR_IMGDATA_BYTES]
    if valid_idx.size == n:
        payload = np.ascontiguousarray(body)  # all valid: strided copy, no
    else:                                     # per-row fancy gather
        payload = np.ascontiguousarray(body[valid_idx])
    return ImtrParseResult(
        payload=payload,
        seq=vseq,
        chid=chid,
        n_frames=n,
        n_invalid=int(n - valid_idx.size),
        missing_ranges=missing,
    )


@dataclass
class ImageFrameMeta:
    """Metadata block trailing each image frame (aux_separator.h:169-178)."""

    camera: int
    master_or_backup: int
    z_ratio: int
    file_id: int
    seq: int
    image_dwords: int
    sub_image_dwords: np.ndarray   # (40,) uint32: 32 PAN + 8 MSS sub-tiles
    start: int                     # byte offset of frame start (aux block)
    sig_off: int                   # byte offset of the signature
    frame_end: int                 # byte offset just past the metadata


def parse_image_frame_meta(buf: np.ndarray, sig_off: int) -> ImageFrameMeta:
    """Decode the 172-byte signature+metadata block at ``sig_off``.

    The frame's *data precedes the signature*: layout on disk is
    ``[aux 49152 B][image payload image_dwords*4 B][EB90E14D + meta]``
    (NextImageDataFrame, aux_separator.h:627-656).
    """
    sp = buf[sig_off : sig_off + IMGSIG_META_BYTES]
    camera_byte = int(sp[IMGSIG_CAM_OFF])
    sub = sp[IMGSIG_SUBIML_OFF : IMGSIG_SUBIML_OFF + 4 * IMGSIG_SUBIML_COUNT]
    sub = sub.reshape(IMGSIG_SUBIML_COUNT, 4).astype(np.uint32)
    sub_dwords = (sub[:, 0] << 24) | (sub[:, 1] << 16) | (sub[:, 2] << 8) | sub[:, 3]
    image_dwords = int(
        (int(sp[IMGSIG_IMGSZ_OFF]) << 24)
        | (int(sp[IMGSIG_IMGSZ_OFF + 1]) << 16)
        | (int(sp[IMGSIG_IMGSZ_OFF + 2]) << 8)
        | int(sp[IMGSIG_IMGSZ_OFF + 3])
    )
    data_bytes = image_dwords * 4 + IMGSIG_AUX_ALLBYTES
    return ImageFrameMeta(
        camera=(camera_byte & 0x80) >> 7,
        master_or_backup=(camera_byte & 0x40) >> 6,
        z_ratio=camera_byte & 0x3F,
        file_id=int(sp[IMGSIG_FID_OFF]),
        seq=int((int(sp[IMGSIG_SEQ_OFF]) << 8) | int(sp[IMGSIG_SEQ_OFF + 1])),
        image_dwords=image_dwords,
        sub_image_dwords=sub_dwords,
        start=sig_off - data_bytes,
        sig_off=sig_off,
        frame_end=sig_off + IMGSIG_META_BYTES,
    )


@dataclass
class ZImageHeader:
    field_dlmt: int
    image_idx: int
    code_format: int
    video_format: int
    version: int
    data_dwords: int


def parse_z_image_header(block: np.ndarray) -> ZImageHeader:
    """Parse + validate the compressed sub-image header
    (ParseZImageHeader, aux_separator.h:600-620)."""
    b = np.asarray(block[:16], dtype=np.uint8)
    field_dlmt = int(b[0]) | (int(b[1]) << 8) | (int(b[2]) << 16) | (int(b[3]) << 24)
    image_idx = (
        (int(b[Z_IMGIDX_OFF]) << 24)
        | (int(b[Z_IMGIDX_OFF + 1]) << 16)
        | (int(b[Z_IMGIDX_OFF + 2]) << 8)
        | int(b[Z_IMGIDX_OFF + 3])
    )
    zih = ZImageHeader(
        field_dlmt=field_dlmt,
        image_idx=image_idx,
        code_format=int(b[Z_ZFORMAT_OFF]),
        video_format=int(b[Z_VFORMAT_OFF]),
        version=int(b[Z_HDRVER_OFF]),
        data_dwords=(
            (int(b[Z_DATADWORDS_OFF]) << 24)
            | (int(b[Z_DATADWORDS_OFF + 1]) << 16)
            | (int(b[Z_DATADWORDS_OFF + 2]) << 8)
            | int(b[Z_DATADWORDS_OFF + 3])
        ),
    )
    if zih.field_dlmt not in (Z_EVEN_FRAME, Z_ODD_FRAME):
        raise ValueError(f"invalid field delimiter: {zih.field_dlmt:08X}")
    if not (zih.code_format & Z_ZFORMAT_JP2):
        raise ValueError(f"invalid code format: {zih.code_format:04X}, JP2 expected")
    if zih.version != Z_HDRVER_VALUE:
        raise ValueError(f"unknown header version: {zih.version:04X}")
    return zih


# ===========================================================================
# Synthetic builders (test fixtures; the reference ships no test data)
# ===========================================================================


def build_aos_frame(payload: bytes, vcdu_seq: int, vcid: int = 1) -> bytes:
    """One valid 1024-byte AOS frame around an 880-byte payload."""
    assert len(payload) == AOS_DATA_BYTES
    frame = bytearray(AOS_FRAME_BYTES)
    frame[0:4] = SYNC_BYTES
    frame[4] = 0x40  # version/SCID filler
    frame[AOS_VCID_OFF] = vcid & AOS_VCID_MASK
    frame[AOS_VCDUSEQ_OFF] = (vcdu_seq >> 16) & 0xFF
    frame[AOS_VCDUSEQ_OFF + 1] = (vcdu_seq >> 8) & 0xFF
    frame[AOS_VCDUSEQ_OFF + 2] = vcdu_seq & 0xFF
    frame[AOS_VCDUINJ_OFF : AOS_VCDUINJ_OFF + 4] = b"\x00\x00\x00\x00"
    frame[AOS_DATA_OFF : AOS_DATA_OFF + AOS_DATA_BYTES] = payload
    crc = crc16_ccitt_false(bytes(frame[AOS_HEADER_OFF:AOS_CRC_OFF]))
    frame[AOS_CRC_OFF] = (crc >> 8) & 0xFF
    frame[AOS_CRC_OFF + 1] = crc & 0xFF
    # LDPC bytes left zero (carried, never checked).
    return bytes(frame)


def build_empty_aos_frame() -> bytes:
    frame = bytearray(AOS_FRAME_BYTES)
    frame[0:4] = SYNC_BYTES
    frame[AOS_VCID_OFF] = AOS_VCID_EMPTY
    frame[AOS_VCDUINJ_OFF : AOS_VCDUINJ_OFF + 4] = b"\xaa\xaa\xaa\xaa"
    return bytes(frame)


def build_imtr_frame(payload: bytes, seq: int, chid: int = IMTR_CHID_CMOS1) -> bytes:
    """One valid 882-byte image-transfer frame around an 866-byte payload."""
    assert len(payload) == IMTR_IMGDATA_BYTES
    frame = bytearray(IMTR_FRAME_BYTES)
    frame[0:4] = IMTR_SIG
    frame[IMTR_SEQ_OFF] = (seq >> 24) & 0xFF
    frame[IMTR_SEQ_OFF + 1] = (seq >> 16) & 0xFF
    frame[IMTR_SEQ_OFF + 2] = (seq >> 8) & 0xFF
    frame[IMTR_SEQ_OFF + 3] = seq & 0xFF
    frame[IMTR_CHID_OFF] = chid
    frame[IMTR_DTMARK_OFF] = IMTR_DTMARK_IMG
    frame[IMTR_IMGDATA_OFF : IMTR_IMGDATA_OFF + IMTR_IMGDATA_BYTES] = payload
    crc = crc16_ccitt_false(bytes(frame[:IMTR_CRC_OFF]))
    frame[IMTR_CRC_OFF] = (crc >> 8) & 0xFF
    frame[IMTR_CRC_OFF + 1] = crc & 0xFF
    frame[IMTR_ENDSIG_OFF : IMTR_ENDSIG_OFF + 4] = IMTR_ENDSIG
    return bytes(frame)


def _jp2_encode_tile(tile_be_bytes: bytes, idx: int) -> bytes:
    """Wrap a 256x1536 tile in the Z-header + lossless JPEG2000 codestream
    (the builder-side inverse of InflateSubImage, aux_separator.h:374-393)."""
    import cv2

    tile = np.frombuffer(tile_be_bytes, dtype=np.uint16).reshape(
        IMGSIG_IMBASE_LINES, IMGSIG_IMBASE_COLS
    )
    ok, enc = cv2.imencode(
        ".jp2", tile, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000]
    )
    if not ok:
        raise RuntimeError("JPEG2000 encode failed")
    code = enc.tobytes()
    if len(code) % 4:
        code += bytes(4 - len(code) % 4)
    hdr = bytearray(Z_ZDATA_OFF)
    dlmt = Z_EVEN_FRAME if idx % 2 == 0 else Z_ODD_FRAME
    hdr[0:4] = dlmt.to_bytes(4, "little")
    hdr[Z_IMGIDX_OFF : Z_IMGIDX_OFF + 4] = idx.to_bytes(4, "big")
    hdr[Z_ZFORMAT_OFF] = Z_ZFORMAT_JP2
    hdr[Z_HDRVER_OFF] = Z_HDRVER_VALUE
    hdr[Z_DATADWORDS_OFF : Z_DATADWORDS_OFF + 4] = (len(code) // 4).to_bytes(
        4, "big"
    )
    return bytes(hdr) + code


def build_image_frame(
    pan_lines: np.ndarray,
    mss_lines: np.ndarray,
    seq: int,
    aux: bytes | None = None,
    file_id: int = 1,
    compress: str | None = None,
) -> bytes:
    """Build one image frame for the IMDT stream.

    ``pan_lines``: (1024, 12288) uint16 (big-endian on the wire);
    ``mss_lines``: (256, 12288) uint16.  Sub-images are 256x1536 tiles in
    row-major (v-part, h-part) order: 4 PAN stripes then 1 MSS stripe
    (WriteImageData, aux_separator.h:341-364).  ``compress='jp2'`` emits
    lossless JPEG2000 sub-tiles (Z-header wrapped); None emits raw tiles.
    """
    assert pan_lines.shape == (IMGSIG_PAN_LINES, 12288)
    assert mss_lines.shape == (IMGSIG_MSS_LINES, 12288)
    if aux is None:
        aux = bytes(IMGSIG_AUX_ALLBYTES)
    assert len(aux) == IMGSIG_AUX_ALLBYTES

    tiles = []
    for r in range(IMGSIG_PAN_VPARTS + IMGSIG_MSS_VPARTS):
        src = pan_lines if r < IMGSIG_PAN_VPARTS else mss_lines
        row0 = (r % IMGSIG_PAN_VPARTS) * IMGSIG_IMBASE_LINES if r < IMGSIG_PAN_VPARTS else 0
        for c in range(IMGSIG_IMG_HPARTS):
            tile = src[
                row0 : row0 + IMGSIG_IMBASE_LINES,
                c * IMGSIG_IMBASE_COLS : (c + 1) * IMGSIG_IMBASE_COLS,
            ]
            raw = np.ascontiguousarray(tile, dtype=">u2").tobytes()
            if compress == "jp2":
                tiles.append(_jp2_encode_tile(raw, len(tiles)))
            else:
                tiles.append(raw)

    payload = b"".join(tiles)
    image_dwords = len(payload) // 4
    sub_dwords = [len(t) // 4 for t in tiles]

    meta = bytearray(IMGSIG_META_BYTES)
    meta[0:4] = IMGSIG_SIG
    # camera=0, master; z_ratio 0 = uncompressed, 0x11 = 4:1-class JP2
    meta[IMGSIG_CAM_OFF] = 0x11 if compress == "jp2" else IMGSIG_ZRTO_NONE
    meta[IMGSIG_FID_OFF] = file_id
    meta[IMGSIG_SEQ_OFF] = (seq >> 8) & 0xFF
    meta[IMGSIG_SEQ_OFF + 1] = seq & 0xFF
    meta[IMGSIG_IMGSZ_OFF : IMGSIG_IMGSZ_OFF + 4] = image_dwords.to_bytes(4, "big")
    for i, sd in enumerate(sub_dwords):
        off = IMGSIG_SUBIML_OFF + 4 * i
        meta[off : off + 4] = sd.to_bytes(4, "big")
    return aux + payload + bytes(meta)


def _batch_crc(frames: np.ndarray, start: int, length: int) -> np.ndarray:
    """CRC-16/CCITT-FALSE of bytes [start, start+length) of every row of a
    C-contiguous (n, frame_bytes) u8 array (native sweep when built)."""
    from ..utils import native

    n, frame_bytes = frames.shape
    offsets = np.arange(n, dtype=np.int64) * frame_bytes + start
    return native.crc16_many(frames.reshape(-1), offsets, length)


def build_imtr_stream(
    payloads: np.ndarray, start_seq: int = 1, chid: int = IMTR_CHID_CMOS1
) -> np.ndarray:
    """Vectorised inverse of :func:`parse_imtr_stream`: wrap (n, 866) u8
    payload rows into (n, 882) valid image-transfer frames with
    consecutive sequence numbers (batch CRC, ~1000x the per-frame
    :func:`build_imtr_frame` loop for multi-frame fixtures)."""
    payloads = np.ascontiguousarray(payloads, dtype=np.uint8)
    n = payloads.shape[0]
    assert payloads.shape == (n, IMTR_IMGDATA_BYTES)
    frames = np.zeros((n, IMTR_FRAME_BYTES), np.uint8)
    frames[:, :4] = np.frombuffer(IMTR_SIG, np.uint8)
    seq = (np.arange(n, dtype=np.uint32) + np.uint32(start_seq))[:, None]
    shifts = np.array([24, 16, 8, 0], np.uint32)
    frames[:, IMTR_SEQ_OFF : IMTR_SEQ_OFF + 4] = (
        (seq >> shifts) & 0xFF
    ).astype(np.uint8)
    frames[:, IMTR_CHID_OFF] = chid
    frames[:, IMTR_DTMARK_OFF] = IMTR_DTMARK_IMG
    frames[:, IMTR_IMGDATA_OFF : IMTR_IMGDATA_OFF + IMTR_IMGDATA_BYTES] = payloads
    crc = _batch_crc(frames, 0, IMTR_CRC_OFF)
    frames[:, IMTR_CRC_OFF] = (crc >> 8).astype(np.uint8)
    frames[:, IMTR_CRC_OFF + 1] = (crc & 0xFF).astype(np.uint8)
    frames[:, IMTR_ENDSIG_OFF : IMTR_ENDSIG_OFF + 4] = np.frombuffer(
        IMTR_ENDSIG, np.uint8
    )
    return frames


def build_aos_stream(
    payloads: np.ndarray, start_vcdu_seq: int = 0, vcid: int = 1
) -> np.ndarray:
    """Vectorised inverse of :func:`scan_aos_frames`: wrap (n, 880) u8
    payload rows into (n, 1024) valid AOS frames (LDPC zeros, batch CRC
    over bytes [4, 894) like ValidateAosFrame, aux_separator.h:679-681)."""
    payloads = np.ascontiguousarray(payloads, dtype=np.uint8)
    n = payloads.shape[0]
    assert payloads.shape == (n, AOS_DATA_BYTES)
    frames = np.zeros((n, AOS_FRAME_BYTES), np.uint8)
    frames[:, :4] = np.frombuffer(SYNC_BYTES, np.uint8)
    frames[:, 4] = 0x40
    frames[:, AOS_VCID_OFF] = vcid & AOS_VCID_MASK
    seq = (np.arange(n, dtype=np.uint32) + np.uint32(start_vcdu_seq))[:, None]
    shifts = np.array([16, 8, 0], np.uint32)
    frames[:, AOS_VCDUSEQ_OFF : AOS_VCDUSEQ_OFF + 3] = (
        (seq >> shifts) & 0xFF
    ).astype(np.uint8)
    # VCDUINJ left 0x00000000 (valid)
    frames[:, AOS_DATA_OFF : AOS_DATA_OFF + AOS_DATA_BYTES] = payloads
    crc = _batch_crc(frames, AOS_HEADER_OFF, AOS_CRC_OFF - AOS_HEADER_OFF)
    frames[:, AOS_CRC_OFF] = (crc >> 8).astype(np.uint8)
    frames[:, AOS_CRC_OFF + 1] = (crc & 0xFF).astype(np.uint8)
    return frames


def split_stream_into_imtr_payload(data: bytes) -> list[bytes]:
    """Chunk an IMDT byte stream into 866-byte IMTR payloads (zero-padded)."""
    out = []
    for i in range(0, len(data), IMTR_IMGDATA_BYTES):
        chunk = data[i : i + IMTR_IMGDATA_BYTES]
        if len(chunk) < IMTR_IMGDATA_BYTES:
            chunk = chunk + bytes(IMTR_IMGDATA_BYTES - len(chunk))
        out.append(chunk)
    return out


def split_stream_into_aos_payload(data: bytes) -> list[bytes]:
    """Chunk an IMTR frame stream into 880-byte AOS payloads (zero-padded)."""
    out = []
    for i in range(0, len(data), AOS_DATA_BYTES):
        chunk = data[i : i + AOS_DATA_BYTES]
        if len(chunk) < AOS_DATA_BYTES:
            chunk = chunk + bytes(AOS_DATA_BYTES - len(chunk))
        out.append(chunk)
    return out
