// Native image-codec hot paths (the stb_image-equivalent layer's only
// slow parts once zlib handles entropy coding).
// (reference: src/render/stb_image_impl.cpp -- the reference vendors
// stb_image in C; here the Python codecs in utils/image.py call these
// via ctypes.)  A copy of opengl_raytracing_tpu/native/image_native.cpp
// with the same C ABI and code.
//
// png_unfilter: PNG scanline defilter (filters 0-4, 8-bit samples).
// hdr_unrle:    Radiance .hdr new-style RLE scanline decode to RGBE.
// jpeg_entropy_scan / jpeg_entropy_encode: baseline JPEG huffman decode
//               and encode.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// raw: h * (1 + w*c) bytes of (filter_byte, filtered_row) pairs.
// out: h * w * c bytes, unfiltered.  Returns 0 on success, <0 on a bad
// filter type (matching the python codec's ValueError).
int png_unfilter(const uint8_t* raw, int64_t h, int64_t w, int64_t c,
                 uint8_t* out) {
    const int64_t stride = w * c;
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t ftype = raw[y * (stride + 1)];
        const uint8_t* row = raw + y * (stride + 1) + 1;
        uint8_t* cur = out + y * stride;
        const uint8_t* prev = y > 0 ? out + (y - 1) * stride : nullptr;
        switch (ftype) {
            case 0:
                std::memcpy(cur, row, stride);
                break;
            case 1:  // Sub
                for (int64_t x = 0; x < stride; ++x) {
                    const int left = x >= c ? cur[x - c] : 0;
                    cur[x] = (uint8_t)(row[x] + left);
                }
                break;
            case 2:  // Up
                for (int64_t x = 0; x < stride; ++x) {
                    const int up = prev ? prev[x] : 0;
                    cur[x] = (uint8_t)(row[x] + up);
                }
                break;
            case 3:  // Average
                for (int64_t x = 0; x < stride; ++x) {
                    const int left = x >= c ? cur[x - c] : 0;
                    const int up = prev ? prev[x] : 0;
                    cur[x] = (uint8_t)(row[x] + ((left + up) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t x = 0; x < stride; ++x) {
                    const int a = x >= c ? cur[x - c] : 0;
                    const int b = prev ? prev[x] : 0;
                    const int cc = (prev && x >= c) ? prev[x - c] : 0;
                    const int p = a + b - cc;
                    const int pa = std::abs(p - a);
                    const int pb = std::abs(p - b);
                    const int pc = std::abs(p - cc);
                    const int pred = (pa <= pb && pa <= pc) ? a
                                     : (pb <= pc ? b : cc);
                    cur[x] = (uint8_t)(row[x] + pred);
                }
                break;
            default:
                return -(int)ftype;
        }
    }
    return 0;
}

// Radiance .hdr new-style RLE: decode `h` scanlines of width `w` from
// `data[pos..n)` into rgbe_out [h*w*4].  Each scanline starts with the
// 4-byte header 0x02 0x02 hi lo (length == w) followed by 4 RLE-coded
// component planes.  Old-style (unencoded) scanlines are handled too.
// Returns the final read position, or <0 on malformed input.
int64_t hdr_unrle(const uint8_t* data, int64_t n, int64_t pos,
                  int64_t h, int64_t w, uint8_t* rgbe_out) {
    for (int64_t y = 0; y < h; ++y) {
        uint8_t* line = rgbe_out + y * w * 4;
        if (pos + 4 > n) return -1;
        if (w >= 8 && w < 32768 && data[pos] == 2 && data[pos + 1] == 2
            && ((int64_t)data[pos + 2] << 8 | data[pos + 3]) == w) {
            pos += 4;
            for (int comp = 0; comp < 4; ++comp) {
                int64_t x = 0;
                while (x < w) {
                    if (pos >= n) return -2;
                    int count = data[pos++];
                    if (count > 128) {  // run
                        count -= 128;
                        if (pos >= n || x + count > w) return -3;
                        const uint8_t v = data[pos++];
                        for (int k = 0; k < count; ++k)
                            line[(x + k) * 4 + comp] = v;
                    } else {            // literal
                        if (pos + count > n || x + count > w) return -4;
                        for (int k = 0; k < count; ++k)
                            line[(x + k) * 4 + comp] = data[pos + k];
                        pos += count;
                    }
                    x += count;
                }
            }
        } else {
            // old-style flat scanline: w RGBE quads
            if (pos + w * 4 > n) return -5;
            std::memcpy(line, data + pos, w * 4);
            pos += w * 4;
        }
    }
    return pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Baseline JPEG entropy decode (huffman + dequant; IDCT/assembly stay in
// vectorized numpy).  Bit-reader semantics mirror utils.image._BitReader
// exactly: 0xFF00 unstuffing, marker => zero-fill, RST realign.
// ---------------------------------------------------------------------------

namespace {

const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct BitR {
    const uint8_t* d;
    int64_t n, pos;
    uint32_t acc;
    int nbits;
    int marker;  // -1 == none
};

void br_fill(BitR& b) {
    while (b.nbits <= 24) {
        if (b.marker >= 0 || b.pos >= b.n) {  // past-end == appended EOI
            b.acc <<= 8;
            b.nbits += 8;
            continue;
        }
        uint8_t v = b.d[b.pos++];
        if (v == 0xFF) {
            const uint8_t nxt = b.pos < b.n ? b.d[b.pos] : 0xD9;
            if (nxt == 0x00) {
                b.pos++;
            } else {
                b.marker = nxt;
                b.pos--;
                v = 0;
            }
        }
        b.acc = (b.acc << 8) | v;
        b.nbits += 8;
    }
}

inline uint32_t br_peek16(BitR& b) {
    if (b.nbits < 16) br_fill(b);
    return (b.acc >> (b.nbits - 16)) & 0xFFFF;
}

inline int br_receive(BitR& b, int nb) {
    if (nb == 0) return 0;
    if (b.nbits < nb) br_fill(b);
    const int v = (b.acc >> (b.nbits - nb)) & ((1u << nb) - 1);
    b.nbits -= nb;
    return v;
}

int decode_block(BitR& br, const uint8_t* dcv, const uint8_t* dcl,
                 const uint8_t* acv, const uint8_t* acl, const float* qt,
                 int* pred, float* out64) {
    float coef[64] = {0.0f};
    uint32_t v = br_peek16(br);
    const int s0 = dcv[v];
    int ln = dcl[v];
    if (ln == 0) return -1;  // bad DC huffman code
    br.nbits -= ln;
    int diff = br_receive(br, s0);
    if (s0 && diff < (1 << (s0 - 1))) diff -= (1 << s0) - 1;
    *pred += diff;
    coef[0] = (float)*pred * qt[0];
    int k = 1;
    while (k < 64) {
        v = br_peek16(br);
        const int rs = acv[v];
        ln = acl[v];
        if (ln == 0) return -2;  // bad AC huffman code
        br.nbits -= ln;
        const int r = rs >> 4, s = rs & 15;
        if (s == 0) {
            if (r == 15) {
                k += 16;
                continue;
            }
            break;  // EOB
        }
        k += r;
        if (k > 63) return -3;  // AC index overflow
        int val = br_receive(br, s);
        if (val < (1 << (s - 1))) val -= (1 << s) - 1;
        coef[k] = (float)val * qt[k];
        k += 1;
    }
    for (int i = 0; i < 64; ++i) out64[kZigzag[i]] = coef[i];
    return 0;
}

}  // namespace

extern "C" {

// Decodes the whole entropy-coded scan into dequantized natural-order
// coefficient blocks [n_blocks][64], MCU-major in (comp, by, bx) order —
// exactly utils.image._scan_blocks's order.  LUTs are the 16-bit peek
// tables from utils.image._build_huff, one [65536] pair per component.
// Returns the number of blocks written, or <0 on a malformed stream.
int64_t jpeg_entropy_scan(const uint8_t* data, int64_t n, int64_t pos,
                          int32_t mcux, int32_t mcuy, int32_t nc,
                          const int32_t* hs, const int32_t* vs,
                          const uint8_t* dc_val, const uint8_t* dc_len,
                          const uint8_t* ac_val, const uint8_t* ac_len,
                          const float* qts, int32_t restart_interval,
                          float* coefs) {
    BitR br{data, n, pos, 0, 0, -1};
    int preds[8] = {0};
    if (nc > 8) return -9;
    int64_t bi = 0, n_mcu = 0;
    for (int64_t my = 0; my < mcuy; ++my) {
        for (int64_t mx = 0; mx < mcux; ++mx) {
            if (restart_interval && n_mcu
                && n_mcu % restart_interval == 0) {
                // reset_at_rst: realign and consume FF Dn
                br.acc = 0;
                br.nbits = 0;
                br.marker = -1;
                while (br.pos + 1 < n && data[br.pos] == 0xFF
                       && data[br.pos + 1] == 0xFF)
                    br.pos++;
                if (br.pos + 1 < n && data[br.pos] == 0xFF
                    && data[br.pos + 1] >= 0xD0 && data[br.pos + 1] <= 0xD7)
                    br.pos += 2;
                for (int c = 0; c < nc; ++c) preds[c] = 0;
            }
            for (int c = 0; c < nc; ++c) {
                for (int by = 0; by < vs[c]; ++by) {
                    for (int bx = 0; bx < hs[c]; ++bx) {
                        const int r = decode_block(
                            br, dc_val + (int64_t)c * 65536,
                            dc_len + (int64_t)c * 65536,
                            ac_val + (int64_t)c * 65536,
                            ac_len + (int64_t)c * 65536,
                            qts + (int64_t)c * 64, &preds[c],
                            coefs + bi * 64);
                        if (r < 0) return r;
                        ++bi;
                    }
                }
            }
            ++n_mcu;
        }
    }
    return bi;
}

}  // extern "C"

extern "C" {

// Baseline-JPEG huffman entropy ENCODE: blocks [n,64] zigzag-quantized
// int32 in MCU-interleaved scan order, comp_ids [n] (0 = luma table
// pair, else chroma).  Code tables are symbol-indexed [2,256] (codes
// u32, lengths u8).  Writes the byte-stuffed entropy segment (1-filled
// to a byte boundary) into out (capacity out_cap); returns bytes
// written or -1 on overflow.  Mirrors utils.image._jenc_entropy_python
// (the tested oracle).
int64_t jpeg_entropy_encode(const int32_t* blocks, const uint8_t* comp_ids,
                            int64_t n, const uint32_t* dc_codes,
                            const uint8_t* dc_lens,
                            const uint32_t* ac_codes,
                            const uint8_t* ac_lens,
                            uint8_t* out, int64_t out_cap) {
    uint64_t acc = 0;
    int nbits = 0;
    int64_t len = 0;
    int pred[8] = {0};
#define PUT(code, ln)                                                  \
    do {                                                               \
        acc = (acc << (ln)) | (uint64_t)(code);                        \
        nbits += (ln);                                                 \
        while (nbits >= 8) {                                           \
            uint8_t b = (uint8_t)((acc >> (nbits - 8)) & 0xFF);        \
            if (len + 2 > out_cap) return -1;                          \
            out[len++] = b;                                            \
            if (b == 0xFF) out[len++] = 0;                             \
            nbits -= 8;                                                \
        }                                                              \
        acc &= ((uint64_t)1 << nbits) - 1;                             \
    } while (0)

    for (int64_t i = 0; i < n; ++i) {
        const int32_t* blk = blocks + i * 64;
        const int ci = comp_ids[i];
        if (ci >= 8) return -2;  // pred[] bound (python oracle raises)
        const int t = ci == 0 ? 0 : 1;
        const uint32_t* dcc = dc_codes + t * 256;
        const uint8_t* dcl = dc_lens + t * 256;
        const uint32_t* acc_ = ac_codes + t * 256;
        const uint8_t* acl = ac_lens + t * 256;
        int diff = blk[0] - pred[ci];
        pred[ci] = blk[0];
        int s = 0;
        for (int v = diff < 0 ? -diff : diff; v; v >>= 1) ++s;
        PUT(dcc[s], dcl[s]);
        if (s) PUT((diff >= 0 ? diff : diff + (1 << s) - 1)
                   & ((1 << s) - 1), s);
        int run = 0;
        for (int k = 1; k < 64; ++k) {
            int v = blk[k];
            if (v == 0) { ++run; continue; }
            while (run > 15) { PUT(acc_[0xF0], acl[0xF0]); run -= 16; }
            s = 0;
            for (int a = v < 0 ? -v : v; a; a >>= 1) ++s;
            PUT(acc_[(run << 4) | s], acl[(run << 4) | s]);
            PUT((v >= 0 ? v : v + (1 << s) - 1) & ((1 << s) - 1), s);
            run = 0;
        }
        if (run) PUT(acc_[0x00], acl[0x00]);
    }
    if (nbits) PUT((1 << (8 - nbits)) - 1, 8 - nbits);
#undef PUT
    return len;
}

}  // extern "C"
