"""ctypes bindings for the native host-runtime library (native/oipnative.cpp).

Every entry point has a numpy fallback so the framework works without the
compiled library; the native paths accelerate the host-bound stages (frame
CRC sweeps, byte swaps, LZW for TIFF output).  ``native_available()`` tells
callers which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)


def build_library(native_dir: str = _NATIVE_DIR) -> str | None:
    """Path of ``native_dir``/build/liboipnative.so, built from the
    committed sources by ``native_dir``/build.sh when absent; None when it
    cannot be built (no compiler)."""
    path = os.path.join(native_dir, "build", "liboipnative.so")
    if not os.path.exists(path):
        subprocess.run(
            ["sh", os.path.join(native_dir, "build.sh")],
            capture_output=True, check=False,
        )
    return path if os.path.exists(path) else None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build_library()
    if path is not None:
        try:
            lib = ctypes.CDLL(path)
            lib.oip_crc16.restype = ctypes.c_uint16
            lib.oip_crc16.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            lib.oip_crc16_many.restype = None
            lib.oip_crc16_many.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.oip_find_signatures.restype = ctypes.c_int64
            lib.oip_find_signatures.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.oip_gather_blocks.restype = None
            lib.oip_gather_blocks.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.oip_byteswap16.restype = None
            lib.oip_byteswap16.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            if hasattr(lib, "oip_scan_aos"):
                lib.oip_scan_aos.restype = ctypes.c_int64
                lib.oip_scan_aos.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64,               # buf, n
                    ctypes.c_void_p, ctypes.c_int64,               # sync
                    ctypes.c_int64,                                # frame
                    ctypes.c_int64, ctypes.c_uint8, ctypes.c_uint8,
                    ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
                    ctypes.c_int64, ctypes.c_int64,                # hdr, crc
                    ctypes.c_int64, ctypes.c_int64,                # data
                    ctypes.c_void_p, ctypes.c_void_p,              # out
                    ctypes.c_void_p,                               # counts
                ]
            lib.oip_deinterleave_bands.restype = None
            lib.oip_deinterleave_bands.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.oip_lzw_encode.restype = ctypes.c_int64
            lib.oip_lzw_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.oip_lzw_decode.restype = ctypes.c_int64
            lib.oip_lzw_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ]
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def native_available() -> bool:
    return _load() is not None


def crc16_many(base: np.ndarray, offsets: np.ndarray, frame_len: int) -> np.ndarray:
    """Batch CRC-16/CCITT-FALSE at byte ``offsets`` into ``base``."""
    lib = _load()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if lib is not None and base.flags["C_CONTIGUOUS"]:
        out = np.empty(offsets.shape[0], dtype=np.uint16)
        lib.oip_crc16_many(
            base.ctypes.data, offsets.ctypes.data, offsets.shape[0],
            frame_len, out.ctypes.data,
        )
        return out
    from ..formats.crc16 import crc16_ccitt_false_many

    idx = offsets[:, None] + np.arange(frame_len)[None, :]
    return crc16_ccitt_false_many(base[idx])


def find_signatures(buf: np.ndarray, sig: bytes) -> np.ndarray:
    lib = _load()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if lib is not None:
        hits = []
        cap = 1 << 20
        out = np.empty(cap, dtype=np.int64)
        sig_arr = np.frombuffer(sig, dtype=np.uint8)
        start = 0
        while True:
            n = lib.oip_find_signatures(
                buf.ctypes.data + start, buf.shape[0] - start,
                sig_arr.ctypes.data, len(sig), out.ctypes.data, cap,
            )
            hits.append(out[:n] + start)
            if n < cap:
                break
            start = int(hits[-1][-1]) + 1
        return np.concatenate(hits) if hits else np.zeros(0, np.int64)
    from ..formats.aos import find_signatures as np_find

    return np_find(buf, sig)


def gather_blocks(base: np.ndarray, offsets: np.ndarray, block_len: int) -> np.ndarray:
    """Gather fixed-size byte blocks at arbitrary offsets -> (n, block_len)."""
    lib = _load()
    base = np.ascontiguousarray(base, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.empty((offsets.shape[0], block_len), np.uint8)
    if lib is not None:
        lib.oip_gather_blocks(
            base.ctypes.data, offsets.ctypes.data, offsets.shape[0],
            block_len, out.ctypes.data,
        )
        return out
    for i, o in enumerate(offsets.tolist()):
        out[i] = base[o : o + block_len]
    return out


def byteswap16(data: np.ndarray) -> np.ndarray:
    """In-place 16-bit byteswap; returns the array."""
    lib = _load()
    if lib is not None and data.flags["C_CONTIGUOUS"] and data.dtype == np.uint16:
        lib.oip_byteswap16(data.ctypes.data, data.size)
        return data
    data[...] = data.byteswap()
    return data


def deinterleave_bands(
    interleaved: np.ndarray, bands: int, seg: int
) -> np.ndarray:
    """(lines, bands*seg) uint16 with per-line band segments -> contiguous
    (bands, lines, seg) — the MSS line layout split (preproc.h:62-75)."""
    lines = interleaved.shape[0]
    lib = _load()
    if (
        lib is not None
        and interleaved.flags["C_CONTIGUOUS"]
        and interleaved.dtype == np.uint16
    ):
        out = np.empty((bands, lines, seg), np.uint16)
        ptrs = np.asarray(
            [out[b].ctypes.data for b in range(bands)], dtype=np.int64
        )
        lib.oip_deinterleave_bands(
            interleaved.ctypes.data, lines, bands, seg, ptrs.ctypes.data
        )
        return out
    return np.ascontiguousarray(
        interleaved.reshape(lines, bands, seg).transpose(1, 0, 2)
    )


def lzw_encode(data: bytes | np.ndarray) -> bytes | None:
    """TIFF-flavour LZW encode; None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.ascontiguousarray(data, dtype=np.uint8)
    )
    cap = arr.size + (arr.size >> 1) + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = lib.oip_lzw_encode(arr.ctypes.data, arr.size, out.ctypes.data, cap)
    if n < 0:
        return None
    return out[:n].tobytes()


def lzw_decode(data: bytes, expected_size: int) -> bytes:
    """TIFF-flavour LZW decode (native fast path, python fallback)."""
    lib = _load()
    arr = np.frombuffer(data, dtype=np.uint8)
    if lib is not None:
        out = np.empty(expected_size, dtype=np.uint8)
        n = lib.oip_lzw_decode(arr.ctypes.data, arr.size, out.ctypes.data, expected_size)
        if n >= 0:
            return out[:n].tobytes()
    return _lzw_decode_py(data, expected_size)


def _lzw_decode_py(data: bytes, expected_size: int) -> bytes:
    """Pure-python TIFF LZW decoder (slow; test/portability fallback)."""
    CLEAR, EOI, FIRST = 256, 257, 258
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width = 9
    acc = 0
    nbits = 0
    prev: bytes | None = None
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (acc >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == EOI:
                return bytes(out)
            if code == CLEAR:
                table = [bytes([i]) for i in range(256)] + [b"", b""]
                width = 9
                prev = None
                continue
            if code < len(table):
                entry = table[code]
            elif code == len(table) and prev is not None:
                entry = prev + prev[:1]
            else:
                raise ValueError("corrupt LZW stream")
            out += entry
            if prev is not None:
                table.append(prev + entry[:1])
                # decoder lags the encoder by one entry (libtiff convention)
                if len(table) == (1 << width) - 1 and width < 12:
                    width += 1
            prev = entry
            if len(out) >= expected_size:
                return bytes(out)
    return bytes(out)


def scan_aos(buf: np.ndarray, out: np.ndarray | None = None):
    """Single-pass native AOS scan (oip_scan_aos): sync memmem +
    VCID/injection/CRC validation + payload extraction in one sweep of the
    chunk (the four-pass numpy route's cache-friendly replacement).

    ``out`` is an optional reusable payload buffer (capacity >=
    ``(len(buf)//1024 + 1) * 880`` bytes): chunked callers pass the same
    buffer every chunk so the large allocation is page-faulted once, not
    per chunk (cold anonymous-page faults are expensive in sandboxed
    hosts).  The returned payload view aliases ``out`` — consume it
    before the next call.

    Returns (payload (n_valid, 880) u8, n_valid, n_empty, n_invalid,
    cursor) or None when the native library is unavailable — callers fall
    back to formats.aos.scan_aos_frames + extract_aos_payloads (identical
    results, locked by test_native_scan_aos_matches_numpy).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "oip_scan_aos"):
        return None
    from ..formats import aos

    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    n = buf.shape[0]
    cap = (n // aos.AOS_FRAME_BYTES + 1) * aos.AOS_DATA_BYTES
    if out is not None and out.size >= cap:
        payload = out
    else:
        payload = np.empty(cap, np.uint8)
    nbytes = np.zeros(1, np.int64)
    counts = np.zeros(3, np.int64)
    sync = np.frombuffer(aos.SYNC_BYTES, np.uint8)
    cursor = lib.oip_scan_aos(
        buf.ctypes.data, n, sync.ctypes.data, len(aos.SYNC_BYTES),
        aos.AOS_FRAME_BYTES,
        aos.AOS_VCID_OFF, aos.AOS_VCID_MASK, aos.AOS_VCID_EMPTY,
        aos.AOS_VCDUINJ_OFF, aos.AOS_VCDUINJ_VALID, aos.AOS_VCDUINJ_INVAL,
        aos.AOS_HEADER_OFF, aos.AOS_CRC_OFF,
        aos.AOS_DATA_OFF, aos.AOS_DATA_BYTES,
        payload.ctypes.data, nbytes.ctypes.data, counts.ctypes.data,
    )
    n_valid = int(counts[0])
    return (
        payload[: n_valid * aos.AOS_DATA_BYTES].reshape(
            n_valid, aos.AOS_DATA_BYTES
        ),
        n_valid, int(counts[1]), int(counts[2]), int(cursor),
    )
