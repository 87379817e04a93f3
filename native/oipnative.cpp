// oipnative — host-side native runtime for opticalimageprocessor_tpu.
//
// Native rebuild of the reference's host-bound inner loops
// (aux_separator.h frame scanning/CRC, InflateSubImage byte swap,
// imageop.h TIFF output):
//   * CRC-16/CCITT-FALSE over frame batches (table-driven)
//   * signature scanning (memmem sweep returning all offsets)
//   * 16-bit byte swapping
//   * LZW compression/decompression (TIFF flavour, MSB-first, with
//     horizontal-predictor support handled in Python/numpy)
//   * MSS band deinterleave/interleave (preproc.h:62-75 equivalent)
//
// Exposed with a plain C ABI for ctypes.  Build: see native/build.sh.

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// ---------------------------------------------------------------------------
// CRC-16/CCITT-FALSE (poly 0x1021, init 0xFFFF, no reflect, xorout 0)
//
// Slice-by-8: T[k][b] = CRC (init 0) of byte b followed by k zero bytes, so
// eight bytes fold in one step (the 16-bit state only touches the first two
// lookups).  ~5x the byte-at-a-time table walk; bit-identical results.
// ---------------------------------------------------------------------------
static uint16_t crc_table[8][256];
static bool crc_init_done = false;

static void crc_init() {
    for (int b = 0; b < 256; ++b) {
        uint32_t crc = (uint32_t)b << 8;
        for (int i = 0; i < 8; ++i)
            crc = (crc & 0x8000u) ? ((crc << 1) ^ 0x1021u) : (crc << 1);
        crc_table[0][b] = (uint16_t)(crc & 0xFFFFu);
    }
    for (int k = 1; k < 8; ++k)
        for (int b = 0; b < 256; ++b) {
            uint16_t c = crc_table[k - 1][b];
            crc_table[k][b] =
                (uint16_t)((c << 8) ^ crc_table[0][(c >> 8) & 0xFF]);
        }
    crc_init_done = true;
}

static inline uint16_t crc16_run(const uint8_t* p, int64_t n, uint16_t crc) {
    while (n >= 8) {
        crc = (uint16_t)(crc_table[7][p[0] ^ (crc >> 8)] ^
                         crc_table[6][p[1] ^ (crc & 0xFF)] ^
                         crc_table[5][p[2]] ^ crc_table[4][p[3]] ^
                         crc_table[3][p[4]] ^ crc_table[2][p[5]] ^
                         crc_table[1][p[6]] ^ crc_table[0][p[7]]);
        p += 8;
        n -= 8;
    }
    for (int64_t i = 0; i < n; ++i)
        crc = (uint16_t)((crc << 8) ^
                         crc_table[0][((crc >> 8) ^ p[i]) & 0xFF]);
    return crc;
}

uint16_t oip_crc16(const uint8_t* data, size_t n) {
    if (!crc_init_done) crc_init();
    return crc16_run(data, (int64_t)n, 0xFFFFu);
}

// CRC over many equal-length frames given by byte offsets into `base`.
void oip_crc16_many(const uint8_t* base, const int64_t* offsets, int64_t n_frames,
                    int64_t frame_len, uint16_t* out) {
    if (!crc_init_done) crc_init();
    for (int64_t f = 0; f < n_frames; ++f)
        out[f] = crc16_run(base + offsets[f], frame_len, 0xFFFFu);
}

// ---------------------------------------------------------------------------
// Signature scan: all offsets of a short signature in a buffer.
// Returns number of hits written (up to max_hits).
// ---------------------------------------------------------------------------
int64_t oip_find_signatures(const uint8_t* buf, int64_t n, const uint8_t* sig,
                            int64_t sig_len, int64_t* out, int64_t max_hits) {
    int64_t hits = 0;
    const uint8_t* p = buf;
    const uint8_t* end = buf + n;
    while (p < end && hits < max_hits) {
        const uint8_t* q = (const uint8_t*)memmem(p, (size_t)(end - p), sig,
                                                  (size_t)sig_len);
        if (!q) break;
        out[hits++] = q - buf;
        p = q + 1;
    }
    return hits;
}

// ---------------------------------------------------------------------------
// Single-pass AOS scan (aux_separator.h:421-461 state machine): memmem the
// sync marker, validate VCID/injection/CRC, and copy out the validated
// payloads — one cache-friendly sweep instead of the four separate passes
// (signature scan, CRC gather, status walk, payload gather).
//
// Frame geometry is passed in so the C stays format-agnostic; the Python
// wrapper supplies the aux_separator.h constants.  Returns the cursor (the
// byte just past the last consumed frame/signature); counts[0..2] receive
// valid/empty/invalid, *payload_bytes the bytes written to payload_out
// (capacity must be >= (n / frame_bytes + 1) * data_bytes).
// ---------------------------------------------------------------------------
int64_t oip_scan_aos(const uint8_t* buf, int64_t n,
                     const uint8_t* sync, int64_t sync_len,
                     int64_t frame_bytes,
                     int64_t vcid_off, uint8_t vcid_mask, uint8_t vcid_empty,
                     int64_t inj_off,
                     uint32_t inj_valid, uint32_t inj_inval,
                     int64_t hdr_off, int64_t crc_off,
                     int64_t data_off, int64_t data_bytes,
                     uint8_t* payload_out, int64_t* payload_bytes,
                     int64_t* counts) {
    if (!crc_init_done) crc_init();
    counts[0] = counts[1] = counts[2] = 0;
    int64_t out = 0;
    int64_t cursor = 0;
    const uint8_t* end = buf + n;
    const uint8_t* p = buf;
    while (p < end) {
        const uint8_t* q = (const uint8_t*)memmem(
            p, (size_t)(end - p), sync, (size_t)sync_len);
        if (!q || q + frame_bytes > end) break;
        uint32_t inj = ((uint32_t)q[inj_off] << 24) |
                       ((uint32_t)q[inj_off + 1] << 16) |
                       ((uint32_t)q[inj_off + 2] << 8) |
                       (uint32_t)q[inj_off + 3];
        uint8_t vcid = (uint8_t)(q[vcid_off] & vcid_mask);
        bool is_empty = (inj == inj_inval) && (vcid == vcid_empty);
        if (is_empty) {
            counts[1]++;
            p = q + sync_len;
            cursor = q - buf + sync_len;
            continue;
        }
        bool ok_inj = (inj == inj_inval) || (inj == inj_valid);
        if (ok_inj) {
            uint16_t crc = crc16_run(q + hdr_off, crc_off - hdr_off, 0xFFFFu);
            uint16_t stored =
                (uint16_t)(((uint16_t)q[crc_off] << 8) | q[crc_off + 1]);
            if (crc == stored) {
                memcpy(payload_out + out, q + data_off, (size_t)data_bytes);
                out += data_bytes;
                counts[0]++;
                p = q + frame_bytes;
                cursor = q - buf + frame_bytes;
                continue;
            }
        }
        counts[2]++;
        p = q + sync_len;
        cursor = q - buf + sync_len;
    }
    *payload_bytes = out;
    return cursor;
}

// ---------------------------------------------------------------------------
// Gather fixed-size blocks at arbitrary byte offsets into a packed output
// (payload extraction for validated frames).
// ---------------------------------------------------------------------------
void oip_gather_blocks(const uint8_t* base, const int64_t* offsets,
                       int64_t n_blocks, int64_t block_len, uint8_t* out) {
    for (int64_t i = 0; i < n_blocks; ++i)
        memcpy(out + i * block_len, base + offsets[i], (size_t)block_len);
}

// ---------------------------------------------------------------------------
// 16-bit byte swap, in place (aux_separator.h:387-392 hot loop)
// ---------------------------------------------------------------------------
void oip_byteswap16(uint16_t* data, int64_t n_words) {
    for (int64_t i = 0; i < n_words; ++i) {
        uint16_t w = data[i];
        data[i] = (uint16_t)(((w & 0x00FF) << 8) | ((w & 0xFF00) >> 8));
    }
}

// ---------------------------------------------------------------------------
// MSS band deinterleave: each raw line is B contiguous band segments of
// `seg` pixels; split into B planar buffers (preproc.h:62-75 equivalent,
// one pass, no per-line call overhead).
// ---------------------------------------------------------------------------
void oip_deinterleave_bands(const uint16_t* src, int64_t lines, int64_t bands,
                            int64_t seg, uint16_t** dst) {
    for (int64_t y = 0; y < lines; ++y)
        for (int64_t b = 0; b < bands; ++b)
            memcpy(dst[b] + y * seg, src + (y * bands + b) * seg,
                   (size_t)seg * 2);
}

// ---------------------------------------------------------------------------
// LZW (TIFF flavour): MSB-first bit packing, codes grow 9->12 bits, early
// change (code size increments one code earlier, per TIFF spec), ClearCode
// 256, EOI 257.
// ---------------------------------------------------------------------------

struct BitWriter {
    uint8_t* out;
    int64_t cap;
    int64_t pos;       // byte position
    uint32_t acc;      // bit accumulator (MSB-first)
    int nbits;         // bits in accumulator
};

static inline bool bw_put(BitWriter* w, uint32_t code, int width) {
    w->acc = (w->acc << width) | (code & ((1u << width) - 1));
    w->nbits += width;
    while (w->nbits >= 8) {
        if (w->pos >= w->cap) return false;
        w->out[w->pos++] = (uint8_t)(w->acc >> (w->nbits - 8));
        w->nbits -= 8;
    }
    return true;
}

static inline bool bw_flush(BitWriter* w) {
    if (w->nbits > 0) {
        if (w->pos >= w->cap) return false;
        w->out[w->pos++] = (uint8_t)(w->acc << (8 - w->nbits));
        w->nbits = 0;
    }
    return true;
}

// Hash-table LZW encoder (string table as parent-code x byte -> code).
int64_t oip_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t dst_cap) {
    const int CLEAR = 256, EOI = 257, FIRST = 258, MAXCODE = 4093;
    const int HSIZE = 9001;
    static thread_local int32_t htab[9001];
    static thread_local int32_t codetab[9001];

    BitWriter w{dst, dst_cap, 0, 0, 0};
    int width = 9;
    int next_code = FIRST;

    auto reset_table = [&]() {
        memset(htab, 0xFF, sizeof(int32_t) * HSIZE);
        next_code = FIRST;
        width = 9;
    };

    if (!bw_put(&w, CLEAR, width)) return -1;
    reset_table();
    if (n == 0) {
        if (!bw_put(&w, EOI, width)) return -1;
        if (!bw_flush(&w)) return -1;
        return w.pos;
    }

    int32_t cur = src[0];
    for (int64_t i = 1; i < n; ++i) {
        uint8_t c = src[i];
        int32_t key = (cur << 8) | c;
        int32_t h = ((int32_t)(((uint32_t)key * 2654435761u) % HSIZE));
        bool found = false;
        while (htab[h] != -1) {
            if (htab[h] == key) {
                cur = codetab[h];
                found = true;
                break;
            }
            if (++h >= HSIZE) h = 0;
        }
        if (found) continue;

        if (!bw_put(&w, (uint32_t)cur, width)) return -1;
        // register new string
        htab[h] = key;
        codetab[h] = next_code++;
        // libtiff convention: encoder widens when next_code reaches 2^width
        // (its decoder widens one entry earlier, at 2^width - 1)
        if (next_code == (1 << width) && width < 12) ++width;
        if (next_code > MAXCODE) {
            if (!bw_put(&w, CLEAR, width)) return -1;
            reset_table();
        }
        cur = c;
    }
    if (!bw_put(&w, (uint32_t)cur, width)) return -1;
    if (!bw_put(&w, EOI, width)) return -1;
    if (!bw_flush(&w)) return -1;
    return w.pos;
}

// LZW decoder.  Returns decoded byte count, or -1 on error/overflow.
int64_t oip_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t dst_cap) {
    const int CLEAR = 256, EOI = 257, FIRST = 258;
    static thread_local int32_t prefix[4096];
    static thread_local uint8_t suffix[4096];
    static thread_local uint8_t stack[4096];

    int width = 9;
    int next_code = FIRST;
    int64_t bitpos = 0;
    int64_t out = 0;
    int32_t old_code = -1;
    uint8_t first_char = 0;

    auto read_code = [&]() -> int32_t {
        if ((bitpos + width) > n * 8) return EOI;
        int64_t byte = bitpos >> 3;
        int shift = (int)(bitpos & 7);
        uint32_t v = 0;
        for (int i = 0; i < 4 && byte + i < n; ++i) v = (v << 8) | src[byte + i];
        int avail = (int)((n - byte) * 8);
        int used = (avail >= 32) ? 32 : avail;
        v <<= (32 - used);
        v >>= (32 - width - shift);
        bitpos += width;
        return (int32_t)(v & ((1u << width) - 1));
    };

    for (;;) {
        int32_t code = read_code();
        if (code == EOI) break;
        if (code == CLEAR) {
            width = 9;
            next_code = FIRST;
            old_code = -1;
            continue;
        }
        int sp = 0;
        int32_t c = code;
        if (code >= next_code) {
            if (old_code < 0 || code > next_code) return -1;
            stack[sp++] = first_char;
            c = old_code;
        }
        while (c >= FIRST) {
            if (sp >= 4095) return -1;
            stack[sp++] = suffix[c];
            c = prefix[c];
        }
        first_char = (uint8_t)c;
        stack[sp++] = (uint8_t)c;
        if (out + sp > dst_cap) return -1;
        while (sp > 0) dst[out++] = stack[--sp];

        if (old_code >= 0 && next_code < 4096) {
            prefix[next_code] = old_code;
            suffix[next_code] = first_char;
            ++next_code;
            // decoder lags the encoder by one entry: widen at 2^width - 1
            if (next_code == (1 << width) - 1 && width < 12) ++width;
        }
        old_code = code;
    }
    return out;
}

}  // extern "C"
