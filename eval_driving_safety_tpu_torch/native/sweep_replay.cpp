// The host half of the PGD sweep: replay of packed sign trajectories
// with quantization to u8 frames, and the Stereo R-CNN's integer resize
// with the iteration-0 quantize.
//
// Counterpart of eval_driving_safety_tpu/native/sweep_replay.cpp, cut to
// the functions the port calls (attack/replay_native.py); each computes
// the same bytes as its counterpart there. Its PNG writer is
// png_store.cpp here (data/kitti.py). Unlike there, the two replays
// return a status (1 when an allocation fails), so a caller never reads
// frames that were not written.
//
//   * replay_sweep_u8 / replay_sweep_u8_b1: unpack 2-bit sign codes (or a
//     1-bit positive plane) -> doubled-int update on the exact
//     half-integer grid (attack/pgd.py) -> f32 quantize (one IEEE single
//     multiply and truncation, the numpy and device formula) -> optional
//     BGR->RGB flip. The update/quantize loop is branch-free over an int8
//     sign plane, so the compiler vectorizes it.
//   * resize_v2_q0: the exact integer bilinear resize (data/
//     exact_resize.py) emitting the int32 v-plane and its quantized
//     frame in one pass.
#include <cstdint>
#include <cstdlib>

namespace {

// 2-bit sign codes (s+1 in {0,1,2}) -> 4 int8 signs packed in a uint32,
// little-endian so a single 32-bit store unpacks 4 signs.
struct SignLut {
    uint32_t t[256];
    SignLut() {
        for (int i = 0; i < 256; ++i) {
            uint32_t out = 0;
            for (int j = 0; j < 4; ++j) {
                int s = ((i >> (2 * j)) & 3) - 1;
                out |= (uint32_t)(uint8_t)(int8_t)s << (8 * j);
            }
            t[i] = out;
        }
    }
};
const SignLut kSignLut;

// 1-bit positive plane (LSB-first) -> 8 int8 signs (bit ? +1 : -1) packed
// in a uint64 so one 64-bit store unpacks 8 signs.
struct SignLut1 {
    uint64_t t[256];
    SignLut1() {
        for (int i = 0; i < 256; ++i) {
            uint64_t out = 0;
            for (int j = 0; j < 8; ++j) {
                int8_t s = ((i >> j) & 1) ? 1 : -1;
                out |= (uint64_t)(uint8_t)s << (8 * j);
            }
            t[i] = out;
        }
    }
};
const SignLut1 kSignLut1;

inline int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
inline int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }

// Elements per tile: a multiple of 24, so C == 3 channel flips, 4-sign
// bytes and 8-sign bytes never straddle a tile.
const long kTile = 49152;

// The replay of both sign widths. BITS codes per packed byte: 4 (2-bit
// codes) or 8 (1-bit positive plane). Tiled over iterations: the evolving
// doubled state and the clean tile stay in cache across all iterations
// of a tile (tile outer, iteration inner), so memory sees the clean plane
// about once instead of once per iteration.
template <int PER_BYTE>
int replay(const int32_t* v_clean, const uint8_t* packed,
           const int32_t* alpha2, const int32_t* eps2, const int32_t* max2,
           const float* c255, int iters, int b, int h, int w, int c,
           int flip_channels, uint8_t* out) {
    const long plane = (long)h * w * c;          // per-sample elements
    const long pbytes = plane / PER_BYTE;        // packed bytes per sample
    int32_t* vt = (int32_t*)std::malloc((size_t)kTile * sizeof(int32_t));
    int8_t* s8 = (int8_t*)std::malloc((size_t)kTile);
    if (!vt || !s8) {
        std::free(vt);
        std::free(s8);
        return 1;
    }
    for (int bi = 0; bi < b; ++bi) {
        const int32_t a2 = alpha2[bi], e2 = eps2[bi], m2 = max2[bi];
        const float q = 0.5f * c255[bi];
        const int32_t* clean = v_clean + (long)bi * plane;
        for (long t0 = 0; t0 < plane; t0 += kTile) {
            const long tl = plane - t0 < kTile ? plane - t0 : kTile;
            const int32_t* cl = clean + t0;
            for (long i = 0; i < tl; ++i) vt[i] = cl[i] * 2;
            for (int k = 0; k < iters; ++k) {
                const uint8_t* p = packed + ((long)k * b + bi) * pbytes
                    + t0 / PER_BYTE;
                uint8_t* o = out + ((long)k * b + bi) * plane + t0;
                // unpack: one LUT store per packed byte
                if (PER_BYTE == 4) {
                    uint32_t* s32 = (uint32_t*)s8;
                    for (long i = 0; i < tl / 4; ++i)
                        s32[i] = kSignLut.t[p[i]];
                } else {
                    uint64_t* s64 = (uint64_t*)s8;
                    for (long i = 0; i < tl / 8; ++i)
                        s64[i] = kSignLut1.t[p[i]];
                }
                // update + quantize: branch-free, vectorizable
                for (long i = 0; i < tl; ++i) {
                    const int32_t c2 = cl[i] * 2;
                    int32_t d = vt[i] + (int32_t)s8[i] * a2 - c2;
                    d = imin(imax(d, -e2), e2);
                    const int32_t nv = imin(imax(d + c2, 0), m2);
                    vt[i] = nv;
                    // quantize: trunc(f32(v) * 0.5 * c255), IEEE single
                    float x = (float)nv * q;
                    x = x < 0.f ? 0.f : (x > 255.f ? 255.f : x);
                    o[i] = (uint8_t)(int32_t)x;
                }
                if (flip_channels && c == 3) {   // BGR state -> RGB out
                    for (long i = 0; i < tl; i += 3) {
                        const uint8_t t = o[i];
                        o[i] = o[i + 2];
                        o[i + 2] = t;
                    }
                }
            }
        }
    }
    std::free(vt);
    std::free(s8);
    return 0;
}

}  // namespace

extern "C" {

// v_clean:  (B, H, W, C) int32, UNDOUBLED clean values (the replay works
//           on the doubled grid; clean * 2 is computed on the fly).
// packed:   (iters, B, H*W*C/4) uint8, 2-bit sign codes (s+1).
// alpha2/eps2/max2: per-sample (B,) int32, DOUBLED attack parameters.
// c255:     per-sample (B,) float: quantize scale (1/(den_h*den_w) for
//           the Stereo R-CNN v-space, 1.0 for the DSGN 255-space).
// out:      (iters, B, H, W, C) uint8 quantized frames (channel-flipped
//           when flip_channels, i.e. BGR state -> RGB pixels).
// H*W*C must be a multiple of 4 (of 12 when C == 3). Returns 0, or 1
// when a buffer cannot be allocated (out is then not written).
int replay_sweep_u8(const int32_t* v_clean, const uint8_t* packed,
                    const int32_t* alpha2, const int32_t* eps2,
                    const int32_t* max2, const float* c255,
                    int iters, int b, int h, int w, int c,
                    int flip_channels, uint8_t* out) {
    return replay<4>(v_clean, packed, alpha2, eps2, max2, c255, iters, b,
                     h, w, c, flip_channels, out);
}

// replay_sweep_u8 on the 1-bit POSITIVE plane: (iters, B, H*W*C/8)
// uint8, bit set -> sign +1, clear -> -1 (valid only when no gradient
// was exactly zero). H*W*C must be a multiple of 8. Returns as
// replay_sweep_u8.
int replay_sweep_u8_b1(const int32_t* v_clean, const uint8_t* packed,
                       const int32_t* alpha2, const int32_t* eps2,
                       const int32_t* max2, const float* c255,
                       int iters, int b, int h, int w, int c,
                       int flip_channels, uint8_t* out) {
    return replay<8>(v_clean, packed, alpha2, eps2, max2, c255, iters, b,
                     h, w, c, flip_channels, out);
}

// Integer resize + clean-frame quantize: (h0, w0, c) u8 -> the int32
// v-plane scaled by den_h * den_w (exact_resize.resize_v2_host) in
// v_out, and its quantized u8 frame trunc(f32(v) * c255) with optional
// BGR->RGB flip in q0_out, both (out_h, out_w, c) with columns [0, nw)
// written; columns [nw, out_w) must be zeroed by the caller (or
// nw == out_w). scratch: out_h * w0 * c int32.
void resize_v2_q0(const uint8_t* img, int h0, int w0, int c,
                  const int32_t* i0h, const int32_t* i1h,
                  const int32_t* rh, int den_h,
                  const int32_t* i0w, const int32_t* i1w,
                  const int32_t* rw, int den_w,
                  int out_h, int nw, int out_w, float c255,
                  int flip_channels, int32_t* v_out, uint8_t* q0_out,
                  int32_t* scratch) {
    const long row = (long)w0 * c;
    for (int y = 0; y < out_h; ++y) {
        const uint8_t* a = img + (long)i0h[y] * row;
        const uint8_t* b = img + (long)i1h[y] * row;
        const int32_t r = rh[y], s = den_h - rh[y];
        int32_t* v1 = scratch + (long)y * row;
        for (long i = 0; i < row; ++i)
            v1[i] = s * (int32_t)a[i] + r * (int32_t)b[i];
    }
    const int flip = flip_channels && c == 3;
    for (int y = 0; y < out_h; ++y) {
        const int32_t* v1 = scratch + (long)y * row;
        int32_t* o = v_out + (long)y * out_w * c;
        uint8_t* q = q0_out + (long)y * out_w * c;
        for (int x = 0; x < nw; ++x) {
            const int32_t r = rw[x], s = den_w - rw[x];
            const int32_t* a = v1 + (long)i0w[x] * c;
            const int32_t* b = v1 + (long)i1w[x] * c;
            for (int k = 0; k < c; ++k) {
                const int32_t v = s * a[k] + r * b[k];
                o[(long)x * c + k] = v;
                float f = (float)v * c255;
                f = f < 0.f ? 0.f : (f > 255.f ? 255.f : f);
                q[(long)x * c + (flip ? 2 - k : k)] = (uint8_t)(int32_t)f;
            }
        }
    }
}

}  // extern "C"

