// Plane-sweep-volume disparity warp, forward and backward.
//
// Replaces the TPU kernels of eval_driving_safety_tpu/ops/pallas_psv.py:
// `_fwd_kernel` (forward warp) and `_bwd_kernel` (its adjoint). The TPU
// versions read sublane-aligned windows of a zero-padded copy of the
// features and resolve the 0..7 residual offset with an 8-way switch; the
// validity mask runs as a separate elementwise pass. Here there is no
// padded copy and no mask pass: each plane's valid pixels are one interval,
// computed once per plane.
//
// For plane d with disparity disp_d (feature pixels), k_d = clip(floor(
// disp_d), 0, W-1) and f_d = disp_d - k_d:
//   out[b,d,h,x,c] = (1-f_d) fr[b,h,x-k_d,c] + f_d fr[b,h,x-k_d-1,c]
// zero where a tap leaves the row, and zero where x - disp_d is outside
// [0, W-1]. The backward sums the adjoint over the planes:
//   gfr[b,h,y,c] = sum_d (1-f_d) g'[b,d,h,y+k_d,c] + f_d g'[b,d,h,y+k_d+1,c]
// with g' the masked output gradient. No gradient flows to the
// disparities.
//
// With a left feature map `fl` the forward writes the whole PSV
// (B, D, H, W, 2C): fl tiled over D in the left half, the warp in the
// right half, and the backward also returns gfl = sum_d g[..., :C].
//
// Bound on the card: bytes. Both passes do a few flops per element and
// move the (B, D, H, W, S) volume once (368 MB in bf16 at the paper's
// scale, 7x the L2). Every access is a vector of VB bytes (16 where C and
// the pointers allow it; the launchers take VB from the wrapper, which
// picks the widest that fits), neighbouring threads on neighbouring
// vectors:
// - the forward gives each block one plane row of the output (39 KB at
//   the paper's scale) and streams it out with evict-first stores; the
//   left half is a plain copy. Blocks follow each other in (b, h, d)
//   order, so the blocks running at once read the same rows of fr and
//   fl, from L2 (staging them in shared memory measured no faster);
// - the backward gives each block a tile of pixels of one row and walks
//   the planes in order, each plane's window (the tile's taps of the right
//   half, shifted by k_d, and the tile of the left half) brought into a
//   ring of shared memory by cp.async several planes ahead, zero-filled
//   where the mask or the row ends. Each thread sums one output vector in
//   f32 registers: one writer per output element, no atomics, so the sums
//   are the same from run to run.
// Accumulation is in f32 with explicit fused multiply-adds, so the result
// does not depend on the vector width; outputs are stored in the input
// dtype.
#include "common.cuh"

#include <string.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;  // planes in the backward's shared-memory ring

template <int VB>
struct RawOf;
template <>
struct RawOf<16> {
  using type = uint4;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<4> {
  using type = unsigned int;
};
template <>
struct RawOf<2> {
  using type = unsigned short;
};

// N = VB / sizeof(T) elements moved as one VB-byte access, widened to f32
// and rounded back to T
template <typename T, int VB>
struct Vec {
  static constexpr int N = VB / (int)sizeof(T);
  using Raw = typename RawOf<VB>::type;

  __device__ __forceinline__ static void unpack(Raw r, float (&v)[N]) {
    T e[N];
    memcpy(e, &r, VB);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(e[i]);
  }

  __device__ __forceinline__ static Raw pack(const float (&v)[N]) {
    Raw r;
    if constexpr (std::is_same<T, __nv_bfloat16>::value && N % 2 == 0) {
      __nv_bfloat162 e[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
        e[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      memcpy(&r, e, VB);
    } else {
      T e[N];
#pragma unroll
      for (int i = 0; i < N; ++i) e[i] = from_f<T>(v[i]);
      memcpy(&r, e, VB);
    }
    return r;
  }
};

__device__ __forceinline__ void split_disp(float disp, int w, int* k,
                                           float* f) {
  float kf = fminf(fmaxf(floorf(disp), 0.f), (float)(w - 1));
  *k = (int)kf;
  *f = disp - kf;
}

__device__ __forceinline__ bool valid(int x, float disp, int w) {
  float xs = (float)x - disp;
  return xs >= 0.f && xs <= (float)(w - 1);
}

// One plane's shift, fraction and valid pixels: valid(x) holds exactly for
// lo <= x <= hi (empty when lo > hi).
struct Plane {
  int k;
  float f;
  int lo, hi;
};

__device__ __forceinline__ Plane plane_of(float disp, int w) {
  Plane p;
  split_disp(disp, w, &p.k, &p.f);
  p.lo = 0;
  p.hi = -1;
  // (float)x - disp >= 0 exactly when x >= disp, so the first valid x is
  // ceil(disp). The rounding of x - disp <= W-1 and of disp + W-1 put the
  // last one within one pixel of floor(disp + W-1): the predicate itself
  // settles it, from the top candidate down.
  const float lo = fmaxf(ceilf(disp), 0.f);
  if (isnan(disp) || !(lo <= (float)(w - 1))) return p;
  p.lo = (int)lo;
  int x = (int)fminf(fmaxf(floorf(disp + (float)(w - 1)) + 1.f, -1.f),
                     (float)(w - 1));
  for (int n = 0; n < 3 && x >= p.lo && !valid(x, disp, w); ++n) --x;
  p.hi = x >= p.lo && valid(x, disp, w) ? x : p.lo - 1;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// VB-byte copy into shared memory, asynchronous where cp.async takes the
// width (4, 8, 16 bytes); zero-filled when !ok (src is then not read)
template <int VB>
__device__ __forceinline__ void copy_zfill(void* dst, const void* src,
                                           bool ok) {
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else if constexpr (VB >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(VB), "r"(ok ? VB : 0));
  } else {
    *static_cast<unsigned short*>(dst) =
        ok ? __ldg(static_cast<const unsigned short*>(src))
           : (unsigned short)0;
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Forward. Block i writes plane rows [i * per, (i + 1) * per) of the
// B * H * D rows in (b, h, d) order. A thread writes the vectors
// threadIdx.x, + kThreads, ... of each plane row, tracking (pixel,
// vector) by increments: no division per element.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
psv_fwd_kernel(const T* __restrict__ fr, const T* __restrict__ fl,
               const float* __restrict__ disps, T* __restrict__ out, int B,
               int D, int H, int W, int C, int per) {
  using V = Vec<T, VB>;
  using Raw = typename V::Raw;
  constexpr int N = V::N;
  const bool fused = fl != nullptr;
  const int cv = C / N;                  // vectors per pixel of one half
  const int left = fused ? cv : 0;       // left-half vectors per pixel
  const int sv = left + cv;              // vectors per output pixel
  const int nrow = W * sv;
  const int x0 = threadIdx.x / sv, r0 = threadIdx.x % sv;
  const int dx = kThreads / sv, dr = kThreads % sv;
  const int q0 = blockIdx.x * per;
  const int q1 = q0 + min(per, B * H * D - q0);
  for (int q = q0; q < q1; ++q) {
    const int bh = q / D, d = q - bh * D;
    const int b = bh / H, h = bh - b * H;
    const Raw* rrow = reinterpret_cast<const Raw*>(fr) + (int64_t)bh * W * cv;
    const Raw* lrow =
        fused ? reinterpret_cast<const Raw*>(fl) + (int64_t)bh * W * cv
              : nullptr;
    const Plane p = plane_of(disps[(int64_t)b * D + d], W);
    const float w0 = 1.f - p.f;
    Raw* orow = reinterpret_cast<Raw*>(out) +
                (((int64_t)b * D + d) * H + h) * nrow;
    int x = x0, r = r0;
    for (int i = threadIdx.x; i < nrow; i += kThreads) {
      Raw v{};
      if (r < left) {
        v = __ldg(lrow + x * cv + r);
      } else if (x >= p.lo && x <= p.hi) {
        const int c = r - left, xa = x - p.k;   // 0 <= xa < W
        float a[N], bv[N] = {}, o[N];
        V::unpack(__ldg(rrow + xa * cv + c), a);
        if (xa > 0) V::unpack(__ldg(rrow + (xa - 1) * cv + c), bv);
#pragma unroll
        for (int e = 0; e < N; ++e)
          o[e] = __fmaf_rn(p.f, bv[e], __fmul_rn(w0, a[e]));
        v = V::pack(o);
      }
      __stcs(orow + i, v);
      x += dx;
      r += dr;
      if (r >= sv) {
        r -= sv;
        ++x;
      }
    }
  }
}

// Backward. Block = (b, h) row x tile of `tile` pixels x group of `cg`
// channel vectors (cg = all of a half's vectors unless C is very wide),
// with at least tile * cg threads; thread t owns output vector t (pixel
// t / cg, vector t % cg). A stage of the ring holds plane d's right-half
// window, pixels x0 + k_d .. x0 + k_d + tile (tile + 1 pixels), then the
// left half's tile, pixels x0 .. x0 + tile - 1.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
psv_bwd_kernel(const T* __restrict__ g, const float* __restrict__ disps,
               T* __restrict__ gfr, T* __restrict__ gfl, int D, int H, int W,
               int C, int tile, int cg) {
  using V = Vec<T, VB>;
  using Raw = typename V::Raw;
  constexpr int N = V::N;
  extern __shared__ uint4 smem[];
  const bool fused = gfl != nullptr;
  const int cv = C / N;
  const int left = fused ? cv : 0;
  const int sv = left + cv;
  const int groups = (cv + cg - 1) / cg, tiles = (W + tile - 1) / tile;
  const int grp = blockIdx.x % groups;
  const int xt = (blockIdx.x / groups) % tiles;
  const int bh = blockIdx.x / groups / tiles;
  const int b = bh / H, h = bh - b * H;
  const int x0 = xt * tile, c0 = grp * cg;
  const int nr = (tile + 1) * cg, nl = fused ? tile * cg : 0;
  Raw* ring = reinterpret_cast<Raw*>(smem);
  const int nt = blockDim.x;
  const int j0 = threadIdx.x / cg, r0 = threadIdx.x % cg;
  const int dj = nt / cg, dr = nt % cg;
  const float* disp_b = disps + (int64_t)b * D;

  // this thread's copies of plane d's window into stage s
  auto fetch = [&](int d, int s) {
    const Plane p = plane_of(disp_b[d], W);
    const Raw* grow = reinterpret_cast<const Raw*>(g) +
                      (((int64_t)b * D + d) * H + h) * (int64_t)W * sv;
    Raw* st = ring + s * (nr + nl);
    int j = j0, r = r0;
    for (int i = threadIdx.x; i < nr + nl; i += nt) {
      const int c = c0 + r;
      bool ok = c < cv;
      const Raw* src;
      if (j <= tile) {                   // right-half tap x = x0 + k + j
        const int x = x0 + p.k + j;
        ok = ok && x >= p.lo && x <= p.hi;
        src = grow + (int64_t)x * sv + left + c;
      } else {                           // left-half pixel y
        const int y = x0 + j - tile - 1;
        ok = ok && y < W;
        src = grow + (int64_t)y * sv + c;
      }
      copy_zfill<VB>(st + i, ok ? src : grow, ok);
      j += dj;
      r += dr;
      if (r >= cg) {
        r -= cg;
        ++j;
      }
    }
  };

  const int oc = c0 + r0;
  const bool active = threadIdx.x < tile * cg && oc < cv && x0 + j0 < W;
  float acc[N] = {}, accl[N] = {};
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < D) fetch(s, s);
    cp_async_commit();
  }
  for (int d = 0; d < D; ++d) {
    cp_async_wait<kStages - 2>();        // plane d has landed
    __syncthreads();                     // ... for every thread; and all
                                         // are done with plane d - 1
    if (d + kStages - 1 < D)
      fetch(d + kStages - 1, (d + kStages - 1) % kStages);
    cp_async_commit();
    if (active) {
      int k;
      float f;
      split_disp(disp_b[d], W, &k, &f);
      const Raw* st = ring + (d % kStages) * (nr + nl);
      float a[N], bv[N];
      V::unpack(st[threadIdx.x], a);          // window pixel j0: x = y + k
      V::unpack(st[threadIdx.x + cg], bv);    // j0 + 1: x = y + k + 1
      const float w0 = 1.f - f;
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc[e] = __fmaf_rn(f, bv[e], __fmaf_rn(w0, a[e], acc[e]));
      if (fused) {
        float l[N];
        V::unpack(st[nr + threadIdx.x], l);
#pragma unroll
        for (int e = 0; e < N; ++e) accl[e] = __fadd_rn(accl[e], l[e]);
      }
    }
  }
  cp_async_wait<0>();
  if (active) {
    const int64_t o = ((int64_t)bh * W + x0 + j0) * cv + oc;
    reinterpret_cast<Raw*>(gfr)[o] = V::pack(acc);
    if (fused) reinterpret_cast<Raw*>(gfl)[o] = V::pack(accl);
  }
}

// ------------------------------------------------ launchers

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, v = fallback;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

int max_smem() {
  static const int n =
      device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 48 << 10);
  return n;
}

// Plane rows per forward block (runs of 2 to 14 rows were slower at the
// paper's scale, measured with cli/psv_split.py; PERF.md).
constexpr int kFwdPlanes = 1;

// Pixels per backward tile: one output vector per thread.
int bwd_tile_pixels(int cg) { return kThreads / cg; }

bool aligned(const void* p, int vb) { return ((uintptr_t)p % vb) == 0; }

template <typename T, int VB>
int launch_fwd(const void* fr, const void* fl, const float* disps, void* out,
               int B, int D, int H, int W, int C, cudaStream_t s) {
  const int rows = B * H * D;
  const int per = kFwdPlanes;
  psv_fwd_kernel<T, VB><<<(rows + per - 1) / per, kThreads, 0, s>>>(
      (const T*)fr, (const T*)fl, disps, (T*)out, B, D, H, W, C, per);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_width(int vb, const void* fr, const void* fl, const float* disps,
              void* out, int B, int D, int H, int W, int C, cudaStream_t s) {
  switch (vb) {
    case 16:
      return launch_fwd<T, 16>(fr, fl, disps, out, B, D, H, W, C, s);
    case 8:
      return launch_fwd<T, 8>(fr, fl, disps, out, B, D, H, W, C, s);
    case 4:
      return launch_fwd<T, 4>(fr, fl, disps, out, B, D, H, W, C, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_fwd<T, 2>(fr, fl, disps, out, B, D, H, W, C, s);
  }
  return EDS_ERR_UNSUPPORTED;
}

template <typename T, int VB>
int launch_bwd(const void* g, const float* disps, void* gfr, void* gfl, int B,
               int D, int H, int W, int C, cudaStream_t s) {
  auto kern = psv_bwd_kernel<T, VB>;
  const int cv = C * (int)sizeof(T) / VB;
  const int cg = cv < kThreads ? cv : kThreads;
  const int tile = bwd_tile_pixels(cg);
  const int threads = (tile * cg + 31) / 32 * 32;
  const int64_t blocks = (int64_t)B * H * ((W + tile - 1) / tile) *
                         ((cv + cg - 1) / cg);
  if (blocks >= (1LL << 31)) return EDS_ERR_UNSUPPORTED;
  // at most kStages * 3 * kThreads vectors of VB bytes
  const int smem = kStages * ((tile + 1) * cg + (gfl ? tile * cg : 0)) * VB;
  if (smem > (48 << 10)) {
    static const int e = set_smem(kern, max_smem());
    if (e) return e;
  }
  kern<<<(unsigned)blocks, threads, smem, s>>>(
      (const T*)g, disps, (T*)gfr, (T*)gfl, D, H, W, C, tile, cg);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_width(int vb, const void* g, const float* disps, void* gfr, void* gfl,
              int B, int D, int H, int W, int C, cudaStream_t s) {
  switch (vb) {
    case 16:
      return launch_bwd<T, 16>(g, disps, gfr, gfl, B, D, H, W, C, s);
    case 8:
      return launch_bwd<T, 8>(g, disps, gfr, gfl, B, D, H, W, C, s);
    case 4:
      return launch_bwd<T, 4>(g, disps, gfr, gfl, B, D, H, W, C, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_bwd<T, 2>(g, disps, gfr, gfl, B, D, H, W, C, s);
  }
  return EDS_ERR_UNSUPPORTED;
}

// 2 or 4 bytes per element of dtype, 0 for another dtype
int element_bytes(int dtype) {
  return dtype == EDS_DTYPE_F32 ? 4 : dtype == EDS_DTYPE_BF16 ? 2 : 0;
}

// the shapes and vector width (VB bytes) the kernels take: VB holds whole
// elements and divides a pixel's C channels and every pointer
bool takes(int esize, int vb, int64_t rows, int W, int C,
           std::initializer_list<const void*> ptrs) {
  if (esize == 0 || rows >= (1LL << 31) || (int64_t)W * C >= (1LL << 30))
    return false;
  if ((vb != 2 && vb != 4 && vb != 8 && vb != 16) || vb < esize ||
      C * esize % vb != 0)
    return false;
  for (const void* p : ptrs)
    if (!aligned(p, vb)) return false;
  return true;
}

}  // namespace

// fr, fl: (B, H, W, C); fl may be null. disps: (B, D) f32.
// out: (B, D, H, W, C) without fl, (B, D, H, W, 2C) with it.
// vec_bytes: the access width, 2 (bf16 only), 4, 8 or 16 bytes.
extern "C" int psv_warp_forward(int dtype, const void* fr, const void* fl,
                                const float* disps, void* out, int B, int D,
                                int H, int W, int C, int vec_bytes,
                                void* stream) {
  const int64_t rows = (int64_t)B * D * H;
  if (rows == 0 || W * C == 0) return 0;
  const int esize = element_bytes(dtype);
  if (!takes(esize, vec_bytes, rows, W, C, {fr, fl, out}))
    return EDS_ERR_UNSUPPORTED;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EDS_DTYPE_F32)
    return fwd_width<float>(vec_bytes, fr, fl, disps, out, B, D, H, W, C, s);
  return fwd_width<__nv_bfloat16>(vec_bytes, fr, fl, disps, out, B, D, H, W,
                                  C, s);
}

// g: (B, D, H, W, C) without gfl, (B, D, H, W, 2C) with it.
// gfr, gfl: (B, H, W, C); gfl may be null. vec_bytes as above.
extern "C" int psv_warp_backward(int dtype, const void* g, const float* disps,
                                 void* gfr, void* gfl, int B, int D, int H,
                                 int W, int C, int vec_bytes, void* stream) {
  const int64_t rows = (int64_t)B * D * H;
  if (rows == 0 || W * C == 0) return 0;
  const int esize = element_bytes(dtype);
  if (!takes(esize, vec_bytes, rows, W, C, {g, gfr, gfl}))
    return EDS_ERR_UNSUPPORTED;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EDS_DTYPE_F32)
    return bwd_width<float>(vec_bytes, g, disps, gfr, gfl, B, D, H, W, C, s);
  return bwd_width<__nv_bfloat16>(vec_bytes, g, disps, gfr, gfl, B, D, H, W,
                                  C, s);
}
