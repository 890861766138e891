// Plane-sweep-volume disparity warp, forward and backward.
//
// Replaces the TPU kernels of eval_driving_safety_tpu/ops/pallas_psv.py:
// `_fwd_kernel` (forward warp) and `_bwd_kernel` (its adjoint). The TPU
// versions read sublane-aligned windows of a zero-padded copy of the
// features and resolve the 0..7 residual offset with an 8-way switch; the
// validity mask runs as a separate elementwise pass. Here each thread
// reads its two taps directly, with the image edges and the mask handled
// by predicates, so there is no padded copy and no mask pass.
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
// move the (B, D, H, W, S) volume once; threads map to consecutive
// channels, so every warp reads and writes contiguous runs. Accumulation
// is in f32; outputs are stored in the input dtype.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

// One block row per output row (b, d, h): grid.x walks the B * D * H rows,
// grid.y and the threads the W * C elements of a row, so the per-element
// index math stays in 32 bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
psv_fwd_kernel(const T* __restrict__ fr, const T* __restrict__ fl,
               const float* __restrict__ disps, T* __restrict__ out, int D,
               int H, int W, int C) {
  const int S = fl ? 2 * C : C;
  const int row = blockIdx.x;                  // (b * D + d) * H + h
  const int h = row % H, bd = row / H, b = bd / D;
  const float disp = disps[bd];
  int k;
  float f;
  split_disp(disp, W, &k, &f);
  const int64_t src_row = ((int64_t)b * H + h) * W * C;
  const T* frow = fr + src_row;
  T* orow = out + (int64_t)row * W * S;
  for (int i = blockIdx.y * kThreads + threadIdx.x; i < W * C;
       i += gridDim.y * kThreads) {
    const int c = i % C, x = i / C;
    const int xa = x - k, xb = x - k - 1;       // xa < W since k >= 0
    float v = 0.f;
    if (valid(x, disp, W)) {
      const float a = xa >= 0 ? to_f(frow[xa * C + c]) : 0.f;
      const float bb = xb >= 0 ? to_f(frow[xb * C + c]) : 0.f;
      v = (1.f - f) * a + f * bb;
    }
    if (fl) {
      orow[x * S + c] = fl[src_row + i];
      orow[x * S + C + c] = from_f<T>(v);
    } else {
      orow[i] = from_f<T>(v);
    }
  }
}

// One block row per gradient row (b, h); each thread sums its element
// over the D planes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
psv_bwd_kernel(const T* __restrict__ g, const float* __restrict__ disps,
               T* __restrict__ gfr, T* __restrict__ gfl, int D, int H, int W,
               int C) {
  const int S = gfl ? 2 * C : C;
  const int off = S - C;                       // right half of g
  const int row = blockIdx.x;                  // b * H + h
  const int h = row % H, b = row / H;
  for (int i = blockIdx.y * kThreads + threadIdx.x; i < W * C;
       i += gridDim.y * kThreads) {
    const int c = i % C, y = i / C;
    float acc = 0.f, accl = 0.f;
    for (int d = 0; d < D; ++d) {
      const float disp = disps[b * D + d];
      int k;
      float f;
      split_disp(disp, W, &k, &f);
      const T* grow = g + (((int64_t)b * D + d) * H + h) * W * S + c;
      const int xa = y + k;            // out[xa] read fr[y] with 1 - f
      const int xb = y + k + 1;        // out[xb] read fr[y] with f
      if (xa < W && valid(xa, disp, W))
        acc += (1.f - f) * to_f(grow[xa * S + off]);
      if (xb < W && valid(xb, disp, W))
        acc += f * to_f(grow[xb * S + off]);
      if (gfl) accl += to_f(grow[y * S]);
    }
    const int64_t o = (int64_t)row * W * C + i;
    gfr[o] = from_f<T>(acc);
    if (gfl) gfl[o] = from_f<T>(accl);
  }
}

// rows x ceil(W * C / kThreads) blocks, at most 65535 along y (the
// element loops stride over the rest of a row)
dim3 grid_for(int64_t rows, int W, int C) {
  const int per_row = (W * C + kThreads - 1) / kThreads;
  return dim3((unsigned)rows, per_row < 65535 ? per_row : 65535);
}

}  // namespace

// fr, fl: (B, H, W, C); fl may be null. disps: (B, D) f32.
// out: (B, D, H, W, C) without fl, (B, D, H, W, 2C) with it.
extern "C" int psv_warp_forward(int dtype, const void* fr, const void* fl,
                                const float* disps, void* out, int B, int D,
                                int H, int W, int C, void* stream) {
  const int64_t rows = (int64_t)B * D * H;
  if (rows == 0 || W * C == 0) return 0;
  if (rows >= (1LL << 31) || (int64_t)W * C >= (1LL << 31) / 2)
    return EDS_ERR_UNSUPPORTED;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EDS_DTYPE_F32) {
    psv_fwd_kernel<float><<<grid_for(rows, W, C), kThreads, 0, s>>>(
        (const float*)fr, (const float*)fl, disps, (float*)out, D, H, W, C);
  } else if (dtype == EDS_DTYPE_BF16) {
    psv_fwd_kernel<__nv_bfloat16><<<grid_for(rows, W, C), kThreads, 0, s>>>(
        (const __nv_bfloat16*)fr, (const __nv_bfloat16*)fl, disps,
        (__nv_bfloat16*)out, D, H, W, C);
  } else {
    return EDS_ERR_UNSUPPORTED;
  }
  return (int)cudaGetLastError();
}

// g: (B, D, H, W, C) without gfl, (B, D, H, W, 2C) with it.
// gfr, gfl: (B, H, W, C); gfl may be null.
extern "C" int psv_warp_backward(int dtype, const void* g, const float* disps,
                                 void* gfr, void* gfl, int B, int D, int H,
                                 int W, int C, void* stream) {
  const int64_t rows = (int64_t)B * H;
  if (rows == 0 || W * C == 0) return 0;
  if (rows >= (1LL << 31) || (int64_t)W * C >= (1LL << 31) / 2)
    return EDS_ERR_UNSUPPORTED;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EDS_DTYPE_F32) {
    psv_bwd_kernel<float><<<grid_for(rows, W, C), kThreads, 0, s>>>(
        (const float*)g, disps, (float*)gfr, (float*)gfl, D, H, W, C);
  } else if (dtype == EDS_DTYPE_BF16) {
    psv_bwd_kernel<__nv_bfloat16><<<grid_for(rows, W, C), kThreads, 0, s>>>(
        (const __nv_bfloat16*)g, disps, (__nv_bfloat16*)gfr,
        (__nv_bfloat16*)gfl, D, H, W, C);
  } else {
    return EDS_ERR_UNSUPPORTED;
  }
  return (int)cudaGetLastError();
}
