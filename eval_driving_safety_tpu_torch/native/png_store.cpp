// A stored-mode PNG writer: filter-0 scanlines in zlib stored blocks,
// adler32 fused into the copy, slice-by-8 crc32, one fwrite.
//
// Counterpart of the PNG half of eval_driving_safety_tpu/native/
// sweep_replay.cpp (png_store_bound, png_store_encode, png_store_write),
// with its bytes wherever its adler32 is right: that copy reduces the
// sums only every 32 KB, so a bright scanline overflows them and zlib
// rejects the file; this one reduces them as often as zlib does.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// CRC-32 (zlib polynomial, reflected), slice-by-8.
struct CrcTables {
    uint32_t t[8][256];
    CrcTables() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t crc = i;
            for (int j = 0; j < 8; ++j)
                crc = (crc >> 1) ^ (0xEDB88320u & (~(crc & 1) + 1));
            t[0][i] = crc;
        }
        for (int k = 1; k < 8; ++k)
            for (uint32_t i = 0; i < 256; ++i)
                t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
    }
};
const CrcTables kCrc;

uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t len) {
    crc = ~crc;
    while (len >= 8) {
        uint32_t lo;
        std::memcpy(&lo, p, 4);
        lo ^= crc;
        uint32_t hi;
        std::memcpy(&hi, p + 4, 4);
        crc = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF]
            ^ kCrc.t[5][(lo >> 16) & 0xFF] ^ kCrc.t[4][lo >> 24]
            ^ kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF]
            ^ kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
        p += 8;
        len -= 8;
    }
    while (len--) crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *p++) & 0xFF];
    return ~crc;
}

// adler32 by blocks: over a block of B bytes the running sums advance by
// a += S1 and b += B*a + S2 with S1 = sum(p[i]) and S2 = sum((B-i)*p[i]),
// two independent reductions the compiler vectorizes. The modulo is
// deferred over at most zlib's NMAX = 5552 bytes, the most after which b
// still fits a uint32 whatever the bytes (255 n(n+1)/2 + (n+1)(MOD-1) <
// 2^32): 86 blocks of 64 = 5504.
uint32_t adler32_update(uint32_t adler, const uint8_t* p, size_t len) {
    const uint32_t MOD = 65521;
    const size_t B = 64, CHUNK = 86 * B;
    uint32_t a = adler & 0xFFFF, bsum = adler >> 16;
    while (len >= B) {
        size_t n = len < CHUNK ? (len / B) * B : CHUNK;
        len -= n;
        for (size_t blk = 0; blk < n; blk += B) {
            uint32_t s1 = 0, s2 = 0;
            for (size_t i = 0; i < B; ++i) {
                s1 += p[blk + i];
                s2 += (uint32_t)(B - i) * p[blk + i];
            }
            bsum += (uint32_t)B * a + s2;
            a += s1;
        }
        p += n;
        a %= MOD;
        bsum %= MOD;
    }
    for (size_t i = 0; i < len; ++i) {
        a += p[i];
        bsum += a;
        if (a >= MOD) a -= MOD;
    }
    a %= MOD;
    bsum %= MOD;
    return (bsum << 16) | a;
}

void put_be32(uint8_t* p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
}

// Upper bound of the PNG (signature, IHDR, one IDAT, IEND) of an
// (h, w, c) 8-bit image in stored-mode zlib blocks.
long png_store_bound(int h, int w, int c) {
    long raw = (long)h * (1 + (long)w * c);       // filter byte + scanline
    long nblocks = (raw + 65534) / 65535;
    return 8 + 25 + (12 + 2 + raw + 5 * nblocks + 4) + 12 + 64;
}

// Encode (h, w, c) u8 pixels (row stride `stride` bytes; c = 3 RGB or
// 1 gray) as a stored-mode PNG into `out`. Returns the byte length, or
// -1 on an unsupported c.
long png_store_encode(const uint8_t* img, long stride, int h, int w, int c,
                      uint8_t* out) {
    if (c != 3 && c != 1) return -1;
    uint8_t* o = out;
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A,
                                   '\n'};
    std::memcpy(o, sig, 8);
    o += 8;
    // IHDR
    put_be32(o, 13);
    std::memcpy(o + 4, "IHDR", 4);
    put_be32(o + 8, (uint32_t)w);
    put_be32(o + 12, (uint32_t)h);
    o[16] = 8;                      // bit depth
    o[17] = (c == 3) ? 2 : 0;       // color type: truecolor / grayscale
    o[18] = o[19] = o[20] = 0;      // deflate / filter 0 / no interlace
    put_be32(o + 21, crc32_update(0, o + 4, 17));
    o += 25;
    // IDAT: zlib header + stored blocks + adler32
    uint8_t* idat = o;              // length and tag written after encoding
    uint8_t* z = idat + 8;
    uint8_t* zp = z;
    *zp++ = 0x78;                   // zlib CMF: deflate, 32K window
    *zp++ = 0x01;                   // FLG: fastest, check bits valid
    const long rowbytes = (long)w * c;
    const long raw = (long)h * (1 + rowbytes);
    uint32_t adler = 1;
    long block_left = 0;
    long remaining = raw;
    int y = 0;
    long row_off = -1;              // -1 = at the filter byte of row y
    while (remaining > 0) {
        if (block_left == 0) {
            block_left = remaining < 65535 ? remaining : 65535;
            *zp++ = (remaining == block_left) ? 1 : 0;     // BFINAL
            zp[0] = (uint8_t)(block_left & 0xFF);          // LEN
            zp[1] = (uint8_t)(block_left >> 8);
            zp[2] = (uint8_t)~zp[0];                       // NLEN
            zp[3] = (uint8_t)~zp[1];
            zp += 4;
        }
        long take;
        if (row_off < 0) {                                 // filter byte
            *zp = 0;
            take = 1;
            row_off = 0;
        } else {
            take = rowbytes - row_off;
            if (take > block_left) take = block_left;
            std::memcpy(zp, img + (long)y * stride + row_off, (size_t)take);
            row_off += take;
            if (row_off == rowbytes) {
                row_off = -1;
                ++y;
            }
        }
        adler = adler32_update(adler, zp, (size_t)take);
        zp += take;
        block_left -= take;
        remaining -= take;
    }
    put_be32(zp, adler);
    zp += 4;
    const long zlen = zp - z;
    put_be32(idat, (uint32_t)zlen);
    std::memcpy(idat + 4, "IDAT", 4);
    put_be32(zp, crc32_update(0, idat + 4, (size_t)(4 + zlen)));
    o = zp + 4;
    // IEND
    put_be32(o, 0);
    std::memcpy(o + 4, "IEND", 4);
    put_be32(o + 8, crc32_update(0, o + 4, 4));
    o += 12;
    return o - out;
}

}  // namespace

extern "C" {

// Encode and write to `path` in one call (a thread-local buffer reused
// from frame to frame, and one fwrite). Returns 0 on success, 1 when the
// buffer cannot be allocated, 2 on an unsupported c, 3 when the file
// cannot be opened and 4 when it cannot be written whole.
int png_store_write(const char* path, const uint8_t* img, long stride,
                    int h, int w, int c) {
    static thread_local uint8_t* buf = nullptr;
    static thread_local long cap = 0;
    const long need = png_store_bound(h, w, c);
    if (need > cap) {
        std::free(buf);
        buf = (uint8_t*)std::malloc((size_t)need);
        cap = buf ? need : 0;
        if (!buf) return 1;
    }
    const long n = png_store_encode(img, stride, h, w, c, buf);
    if (n < 0) return 2;
    FILE* f = std::fopen(path, "wb");
    if (!f) return 3;
    const int ok = std::fwrite(buf, 1, (size_t)n, f) == (size_t)n;
    return std::fclose(f) == 0 && ok ? 0 : 4;
}

}  // extern "C"
