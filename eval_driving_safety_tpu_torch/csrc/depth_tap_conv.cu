// Fused depth stage of the (2+1)D volume convolutions: a 3-tap conv over
// D, folded frozen BatchNorm and an optional ReLU, and its backward.
//
// Replaces the TPU kernels of eval_driving_safety_tpu/ops/pallas_depthconv.py:
// `_fwd_kernel` (forward) and `_bwd_kernel` (dx, dW, d inv, d off).
//
// The volume is viewed as x (B, D, N = H*W, C), a free reshape of the
// channel-last (B, D, H, W, C) tensor. W is (3, C, F); inv/off are (F,).
//   z[d] = x[d-1] W0 + x[d] W1 + x[d+1] W2      (rows outside [0, D) are 0)
//   y[d] = act(z[d] * inv + off)
// Backward, with dm = dy * 1[y > 0] (or dy without ReLU), dz = dm * inv:
//   dx[d]  = dz[d+1] W0^T + dz[d] W1^T + dz[d-1] W2^T
//   dW_t   = sum_{b,d,n} x[d+t-1]^T dz[d]
//   d inv  = sum dm * z,   d off = sum dm
//
// Design. The TPU kernel walks the grid in order and carries dW in a
// revisited output block; here blocks run in no order, so dW and the
// BN-coefficient grads are reduced per block in registers and shared
// memory and added to the (zeroed) outputs with f32 atomics, one per
// output element per block. A block owns NB = 32 consecutive pixels and
// DC = 8 consecutive planes: it stages the DC + 2 input rows it needs in
// shared memory once (as f32, pixel-fastest) together with the weights,
// so each input element is read from device memory about (DC+2)/DC
// times, not 3 times. Each of the 256 threads computes a 4-pixel x
// F/4-feature register tile of one plane with f32 FMAs. dx is the same
// tap conv run on dz with the transposed, tap-reversed weights, so the
// forward and dx share one tile routine; the wgrad pass (only when the
// weights need a gradient) recomputes z from x, as the TPU kernel does.
//
// Bound on the card: bytes. At the widths of the DSGN volumes (C, F of
// 32 or 64) the work is 6CF flops per pixel against 2(C+F) bytes moved
// in bf16, below the tensor cores' ratio of operations to bandwidth.
// This first version uses CUDA-core f32 FMAs, not tensor cores.
#include "common.cuh"

namespace {

constexpr int NB = 32;            // pixels per tile
constexpr int NBP = NB + 4;       // padded shared row (keeps float4 alignment)
constexpr int DC = 8;             // planes per tile
constexpr int PT = 4;             // pixels per thread
constexpr int kThreads = 256;     // DC planes x (NB / PT) pixel groups x 4 feature groups
constexpr int kMaxC = 64;         // widest channel count the tiles take
constexpr int kMaxWOut = (3 * kMaxC * kMaxC + kThreads - 1) / kThreads;

// acc[i][j] += sum_t sum_k src[row pl + t][k][pg*PT + i] * w[t][k][fg*FT + j]
// src: (DC + 2) rows of [cin][NBP] floats, row r = plane d0 - 1 + r.
// w:   [3][cin][cout] floats with cout = 4 * FT.
template <int FT>
__device__ __forceinline__ void tap_tile(const float* src, const float* w,
                                         int cin, int pl, int pg, int fg,
                                         float (&acc)[PT][FT]) {
  const int cout = 4 * FT;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float* s = src + (size_t)(pl + t) * cin * NBP + pg * PT;
    const float* wt = w + (size_t)t * cin * cout + fg * FT;
    for (int k = 0; k < cin; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(s + k * NBP);
      float wv[FT];
      if constexpr (FT % 4 == 0) {
#pragma unroll
        for (int j = 0; j < FT; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(wt + k * cout + j);
          wv[j] = q.x; wv[j + 1] = q.y; wv[j + 2] = q.z; wv[j + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < FT; ++j) wv[j] = wt[k * cout + j];
      }
#pragma unroll
      for (int j = 0; j < FT; ++j) {
        acc[0][j] = fmaf(xv.x, wv[j], acc[0][j]);
        acc[1][j] = fmaf(xv.y, wv[j], acc[1][j]);
        acc[2][j] = fmaf(xv.z, wv[j], acc[2][j]);
        acc[3][j] = fmaf(xv.w, wv[j], acc[3][j]);
      }
    }
  }
}

// Stage rows [d_first, d_first + nrows) of the (B, D, N, ch) tile
// [n0, n0 + NB) into dst[r][k][p] as f32; rows or pixels outside the
// tensor are zero. With dy != nullptr the staged value is the masked
// output gradient dy * 1[y > 0] (relu) or dy, times scale[k] if given.
// ch divides kThreads, so each thread keeps one channel k and walks the
// pixels p0, p0 + kThreads / ch, ...: consecutive threads read
// consecutive elements.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           const T* dy, const T* scale,
                                           int relu, int64_t b, int D, int N,
                                           int ch, int d_first, int nrows,
                                           int n0) {
  const int k = threadIdx.x % ch, p0 = threadIdx.x / ch;
  const int step = kThreads / ch;
  const float sc = scale ? to_f(scale[k]) : 1.f;
  for (int r = 0; r < nrows; ++r) {
    const int d = d_first + r;
    const bool in_d = d >= 0 && d < D;
    const int64_t row = (b * D + d) * (int64_t)N;
    float* out = dst + (r * ch + k) * NBP;
    for (int p = p0; p < NB; p += step) {
      const int n = n0 + p;
      float v = 0.f;
      if (in_d && n < N) {
        const int64_t idx = (row + n) * ch + k;
        if (dy) {
          v = (!relu || to_f(src[idx]) > 0.f) ? to_f(dy[idx]) * sc : 0.f;
        } else {
          v = to_f(src[idx]);
        }
      }
      out[p] = v;
    }
  }
}

template <typename T, int FT>
__global__ void __launch_bounds__(kThreads)
dtc_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ inv, const T* __restrict__ off,
               T* __restrict__ y, int D, int N, int C, int relu) {
  constexpr int F = 4 * FT;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [3][C][F]
  float* xs = ws + 3 * C * F;                    // [DC + 2][C][NBP]
  const int64_t b = blockIdx.z;
  const int n0 = blockIdx.x * NB, d0 = blockIdx.y * DC;
  for (int i = threadIdx.x; i < 3 * C * F; i += kThreads) ws[i] = to_f(w[i]);
  stage_rows<T>(xs, x, nullptr, nullptr, 0, b, D, N, C, d0 - 1, DC + 2, n0);
  __syncthreads();

  const int fg = threadIdx.x & 3, pg = (threadIdx.x >> 2) & 7,
            pl = threadIdx.x >> 5;
  float acc[PT][FT] = {};
  tap_tile<FT>(xs, ws, C, pl, pg, fg, acc);
  const int d = d0 + pl;
  if (d >= D) return;
  float sc[FT], sh[FT];
#pragma unroll
  for (int j = 0; j < FT; ++j) {
    sc[j] = to_f(inv[fg * FT + j]);
    sh[j] = to_f(off[fg * FT + j]);
  }
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int n = n0 + pg * PT + i;
    if (n >= N) continue;
    T* yr = y + ((b * D + d) * N + n) * (int64_t)F + fg * FT;
#pragma unroll
    for (int j = 0; j < FT; ++j) {
      float v = acc[i][j] * sc[j] + sh[j];
      if (relu) v = fmaxf(v, 0.f);
      yr[j] = from_f<T>(v);
    }
  }
}

// dx = tap conv of dz with W'_t = W_{2-t}^T; FT = C / 4 (dx channels).
template <typename T, int FT>
__global__ void __launch_bounds__(kThreads)
dtc_dx_kernel(const T* __restrict__ y, const T* __restrict__ dy,
              const T* __restrict__ w, const T* __restrict__ inv,
              T* __restrict__ dx, int D, int N, int F, int relu) {
  constexpr int C = 4 * FT;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [3][F][C]
  float* zs = ws + 3 * C * F;                    // [DC + 2][F][NBP]
  const int64_t b = blockIdx.z;
  const int n0 = blockIdx.x * NB, d0 = blockIdx.y * DC;
  for (int i = threadIdx.x; i < 3 * C * F; i += kThreads) {
    const int t = i / (C * F), rem = i - t * C * F;
    const int f = rem / C, c = rem - f * C;
    ws[i] = to_f(w[(2 - t) * C * F + c * F + f]);
  }
  stage_rows<T>(zs, y, dy, inv, relu, b, D, N, F, d0 - 1, DC + 2, n0);
  __syncthreads();

  const int fg = threadIdx.x & 3, pg = (threadIdx.x >> 2) & 7,
            pl = threadIdx.x >> 5;
  float acc[PT][FT] = {};
  tap_tile<FT>(zs, ws, F, pl, pg, fg, acc);
  const int d = d0 + pl;
  if (d >= D) return;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int n = n0 + pg * PT + i;
    if (n >= N) continue;
    T* r = dx + ((b * D + d) * N + n) * (int64_t)C + fg * FT;
#pragma unroll
    for (int j = 0; j < FT; ++j) r[j] = from_f<T>(acc[i][j]);
  }
}

// dW (3, C, F) and dco (2, F) = (d inv, d off), f32, added atomically.
// One block per (pixel tile, batch) walks all planes in chunks of DC;
// FT = F / 4 for the z recompute.
template <typename T, int FT>
__global__ void __launch_bounds__(kThreads)
dtc_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ dy, const T* __restrict__ w,
                 const T* __restrict__ inv, float* __restrict__ dw,
                 float* __restrict__ dco, int D, int N, int C, int relu) {
  constexpr int F = 4 * FT;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [3][C][F]
  float* xs = ws + 3 * C * F;                    // [DC + 2][C][NBP]
  float* ms = xs + (DC + 2) * C * NBP;           // [DC][F][NBP] = dm
  float* red = ms + DC * F * NBP;                // [2][F]
  const int64_t b = blockIdx.z;
  const int n0 = blockIdx.x * NB;
  const int nw = 3 * C * F;
  for (int i = threadIdx.x; i < nw; i += kThreads) ws[i] = to_f(w[i]);
  for (int i = threadIdx.x; i < 2 * F; i += kThreads) red[i] = 0.f;

  const int fg = threadIdx.x & 3, pg = (threadIdx.x >> 2) & 7,
            pl = threadIdx.x >> 5;
  float accw[kMaxWOut];
#pragma unroll
  for (int j = 0; j < kMaxWOut; ++j) accw[j] = 0.f;

  for (int d0 = 0; d0 < D; d0 += DC) {
    __syncthreads();                 // previous chunk's readers are done
    stage_rows<T>(xs, x, nullptr, nullptr, 0, b, D, N, C, d0 - 1, DC + 2, n0);
    stage_rows<T>(ms, y, dy, nullptr, relu, b, D, N, F, d0, DC, n0);
    __syncthreads();

    // d inv / d off: z of this thread's tile, reduced into `red`
    float acc[PT][FT] = {};
    tap_tile<FT>(xs, ws, C, pl, pg, fg, acc);
#pragma unroll
    for (int j = 0; j < FT; ++j) {
      const int f = fg * FT + j;
      const float* m = ms + (pl * F + f) * NBP + pg * PT;
      float mz = 0.f, msum = 0.f;
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        mz = fmaf(m[i], acc[i][j], mz);
        msum += m[i];
      }
      atomicAdd(red + f, mz);
      atomicAdd(red + F + f, msum);
    }

    // dW_t[c][f] / inv[f] += sum_{plane, pixel} x[d + t - 1][c] * dm[d][f]
#pragma unroll
    for (int j = 0; j < kMaxWOut; ++j) {
      const int o = threadIdx.x + j * kThreads;
      if (o < nw) {
        const int t = o / (C * F), rem = o - t * C * F;
        const int c = rem / F, f = rem - c * F;
        float s = 0.f;
        for (int q = 0; q < DC; ++q) {
          const float* xr = xs + ((q + t) * C + c) * NBP;
          const float* mr = ms + (q * F + f) * NBP;
#pragma unroll
          for (int p = 0; p < NB; p += 4) {
            const float4 a = *reinterpret_cast<const float4*>(xr + p);
            const float4 m = *reinterpret_cast<const float4*>(mr + p);
            s = fmaf(a.x, m.x, s);
            s = fmaf(a.y, m.y, s);
            s = fmaf(a.z, m.z, s);
            s = fmaf(a.w, m.w, s);
          }
        }
        accw[j] += s;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxWOut; ++j) {
    const int o = threadIdx.x + j * kThreads;
    if (o < nw) atomicAdd(dw + o, accw[j] * to_f(inv[o % F]));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * F; i += kThreads) atomicAdd(dco + i, red[i]);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int FT>
int launch_fwd(const void* x, const void* w, const void* inv, const void* off,
               void* y, int B, int D, int N, int C, int relu,
               cudaStream_t s) {
  const int F = 4 * FT;
  const size_t smem = sizeof(float) * (3 * C * F + (DC + 2) * C * NBP);
  auto kern = dtc_fwd_kernel<T, FT>;
  if (int e = set_smem(kern, smem)) return e;
  dim3 grid((N + NB - 1) / NB, (D + DC - 1) / DC, B);
  kern<<<grid, kThreads, smem, s>>>((const T*)x, (const T*)w, (const T*)inv,
                                    (const T*)off, (T*)y, D, N, C, relu);
  return (int)cudaGetLastError();
}

template <typename T, int FT>
int launch_dx(const void* y, const void* dy, const void* w, const void* inv,
              void* dx, int B, int D, int N, int F, int relu,
              cudaStream_t s) {
  const int C = 4 * FT;
  const size_t smem = sizeof(float) * (3 * C * F + (DC + 2) * F * NBP);
  auto kern = dtc_dx_kernel<T, FT>;
  if (int e = set_smem(kern, smem)) return e;
  dim3 grid((N + NB - 1) / NB, (D + DC - 1) / DC, B);
  kern<<<grid, kThreads, smem, s>>>((const T*)y, (const T*)dy, (const T*)w,
                                    (const T*)inv, (T*)dx, D, N, F, relu);
  return (int)cudaGetLastError();
}

template <typename T, int FT>
int launch_wgrad(const void* x, const void* y, const void* dy, const void* w,
                 const void* inv, float* dw, float* dco, int B, int D, int N,
                 int C, int relu, cudaStream_t s) {
  const int F = 4 * FT;
  if (int e = (int)cudaMemsetAsync(dw, 0, sizeof(float) * 3 * C * F, s)) return e;
  if (int e = (int)cudaMemsetAsync(dco, 0, sizeof(float) * 2 * F, s)) return e;
  if ((int64_t)B * N == 0) return 0;
  const size_t smem = sizeof(float) *
      (3 * C * F + (DC + 2) * C * NBP + DC * F * NBP + 2 * F);
  auto kern = dtc_wgrad_kernel<T, FT>;
  if (int e = set_smem(kern, smem)) return e;
  dim3 grid((N + NB - 1) / NB, 1, B);
  kern<<<grid, kThreads, smem, s>>>((const T*)x, (const T*)y, (const T*)dy,
                                    (const T*)w, (const T*)inv, dw, dco, D, N,
                                    C, relu);
  return (int)cudaGetLastError();
}

// Dispatch on the dtype and on a channel count in {8, 16, 32, 64}.
#define EDS_DISPATCH(DTYPE, CH, CALL)                                   \
  do {                                                                  \
    if (DTYPE == EDS_DTYPE_F32) {                                       \
      using T = float;                                                  \
      switch (CH) {                                                     \
        case 8: { constexpr int FT = 2; return CALL; }                  \
        case 16: { constexpr int FT = 4; return CALL; }                 \
        case 32: { constexpr int FT = 8; return CALL; }                 \
        case 64: { constexpr int FT = 16; return CALL; }                \
      }                                                                 \
    } else if (DTYPE == EDS_DTYPE_BF16) {                               \
      using T = __nv_bfloat16;                                          \
      switch (CH) {                                                     \
        case 8: { constexpr int FT = 2; return CALL; }                  \
        case 16: { constexpr int FT = 4; return CALL; }                 \
        case 32: { constexpr int FT = 8; return CALL; }                 \
        case 64: { constexpr int FT = 16; return CALL; }                \
      }                                                                 \
    }                                                                   \
    return EDS_ERR_UNSUPPORTED;                                         \
  } while (0)

// a channel count the staging takes: it divides kThreads, at most kMaxC
bool channels_ok(int c) {
  return c >= 1 && c <= kMaxC && kThreads % c == 0;
}

}  // namespace

// x (B, D, N, C), w (3, C, F), inv/off (F,) -> y (B, D, N, F); all in the
// same dtype. F in {8, 16, 32, 64}, C <= 64.
extern "C" int dtc_forward(int dtype, const void* x, const void* w,
                           const void* inv, const void* off, void* y, int B,
                           int D, int N, int C, int F, int relu,
                           void* stream) {
  if (!channels_ok(C)) return EDS_ERR_UNSUPPORTED;
  if ((int64_t)B * D * N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  EDS_DISPATCH(dtype, F,
               (launch_fwd<T, FT>(x, w, inv, off, y, B, D, N, C, relu, s)));
}

// dx (B, D, N, C) from y, dy (B, D, N, F). C in {8, 16, 32, 64}, F <= 64.
extern "C" int dtc_backward_dx(int dtype, const void* y, const void* dy,
                               const void* w, const void* inv, void* dx,
                               int B, int D, int N, int C, int F, int relu,
                               void* stream) {
  if (!channels_ok(F)) return EDS_ERR_UNSUPPORTED;
  if ((int64_t)B * D * N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  EDS_DISPATCH(dtype, C,
               (launch_dx<T, FT>(y, dy, w, inv, dx, B, D, N, F, relu, s)));
}

// dw (3, C, F) and dco (2, F) in f32, zeroed here and summed over the
// whole (B, D, N) grid. F in {8, 16, 32, 64}, C <= 64.
extern "C" int dtc_backward_w(int dtype, const void* x, const void* y,
                              const void* dy, const void* w, const void* inv,
                              float* dw, float* dco, int B, int D, int N,
                              int C, int F, int relu, void* stream) {
  if (!channels_ok(C)) return EDS_ERR_UNSUPPORTED;
  cudaStream_t s = (cudaStream_t)stream;
  EDS_DISPATCH(dtype, F,
               (launch_wgrad<T, FT>(x, y, dy, w, inv, dw, dco, B, D, N, C,
                                    relu, s)));
}
