// Fused depth stage of the (2+1)D volume convolutions: a 3-tap conv over
// D, folded frozen BatchNorm and an optional ReLU, and its backward.
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
// Which kernel replaces which TPU kernel of
// eval_driving_safety_tpu/ops/pallas_depthconv.py, by dtype:
//   bf16 forward   dtc_fwd_mma_kernel  <- `_fwd_kernel` (via `_pallas_fwd`)
//   bf16 dx        dtc_dx_mma_kernel   <- `_bwd_kernel`'s dx (`_pallas_bwd`)
//   fp32 forward   dtc_fwd_kernel      <- `_fwd_kernel`
//   fp32 dx        dtc_dx_kernel       <- `_bwd_kernel`'s dx
//   dW, d inv, d off (both dtypes)  dtc_wgrad_kernel <- `_bwd_kernel`'s rest
// Every kernel takes C, F in {8, 16, 32, 64} and every depth D >= 1.
//
// What bounds them. The work is 2 * 3 * C * F operations per pixel and
// plane against 2 (C + F) bytes moved in bf16: 48 operations per byte at
// C = F = 32, 96 at 64. That is under the tensor cores' ratio of rate to
// bandwidth (about 295 in bf16), so on tensor cores the bound is bytes.
// On CUDA-core f32 FMAs (about 67 TFLOP/s) it is operations: the
// full-volume launch (1, 96, 29952, 32, 32) needs 17.7 GFLOP, at least
// 0.26 ms against 0.11 ms to move its bytes, and the half-volume launch
// (C = F = 64) 8.8 GFLOP, 0.13 ms against 0.028 ms.
//
// bf16 design (the attack path). Each plane is an implicit GEMM: for a
// tile of NB = 64 pixels, Y[d] (NB x F) = [X[d-1] | X[d] | X[d+1]]
// (NB x 3C) [W0; W1; W2] (3C x F), run with mma.sync m16n8k16 (bf16 in,
// f32 accumulators) on fragments read by ldmatrix from shared memory;
// each of the 4 warps owns 16 pixel rows and all F outputs. Because x is
// channel-last, a plane's tile is one contiguous run of NB * C * 2 bytes:
// it is staged with 16-byte cp.async (zero-filled past N and outside
// [0, D)) into a row-swizzled tile that ldmatrix reads without bank
// conflicts. A block walks its planes in order with a ring of staged
// planes: planes d + 2 .. d + 1 + kLook are in flight while the tensor
// cores work on plane d (kLook = 3, or fewer at the width class 64, where
// shared memory is short), and each input plane is read from device
// memory once per block.
// D is split into chunks across blockIdx.y, each read with a one-plane
// halo (`planes_per_block`): chunks of 4 planes at widths up to 32, where
// many short blocks balance the SMs best, and at 64 the fewest chunks that
// fill one wave of resident blocks. The weights (3 C F bf16) are staged
// once per block. Each kernel is compiled for three width classes, 16, 32
// and 64: a launch takes the narrowest class that holds C and F, and its
// tiles are zero-filled in shared memory past the real widths (a width of
// 8 to the MMA's K of 16). The forward epilogue
// applies inv/off and the ReLU in f32 to the accumulators, rounds once
// to bf16 and stores 16-byte rows through a per-warp staging tile. Every
// output row is written by exactly one block, without atomics.
// dx is the same walk over y and dy: the thread that copied a chunk of
// a plane forms dz = bf16(dm * inv) from it in shared memory, as the TPU
// kernel forms dz in the matmul's input dtype (`_bwd_kernel`, dz0/dzm/
// dzp). That rounding of dz is the one extra rounding against the plain
// version, which keeps dz in f32. The taps are the same weights read
// transposed (ldmatrix without .trans) in reversed order.
//
// fp32 design (the tiny model's card-vs-CPU check; not on the attack
// path, and TF32 would not hold its 1e-4 tolerance). A block owns NB = 32
// pixels and DC = 8 planes, stages the DC + 2 input rows and the weights
// as f32 in shared memory, and each of 256 threads computes a 4-pixel x
// F/4-feature tile with f32 FMAs (`tap_tile`). The wgrad kernel (only
// when the weights need a gradient) reuses that staging, recomputes z
// from x as the TPU kernel does, and adds each block's sums to the
// zeroed f32 outputs with atomics.
#include "common.cuh"

#include <type_traits>

namespace {

// ------------------------------------------------ bf16: tensor cores

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaNB = 16 * kMmaWarps;    // pixels per block, 16 per warp
constexpr int kMinPlanes = 3;             // least planes of a D chunk, W = 64
constexpr int kNarrowPlanes = 4;          // planes of a D chunk, W <= 32

// The tensor-core kernels are compiled for three width classes W = 16,
// 32, 64: every channel count of a launch is at most W, and every tile in
// shared memory is W wide, zero-padded past the real C or F. The model
// runs C = F = W (8 and 16 in the tiny config, 32 and 64 at paper scale);
// other pairs pay the padded work.
//
// Shared-memory footprint of class W, in bf16 elements: input ring, (dx)
// y ring, weights [3][W][W], per-warp output tiles. kLook planes beyond
// d + 1 are in flight while plane d is computed; the ring holds planes
// d - 2 .. d + 1 + kLook (d - 2 may still be read by a warp finishing
// plane d - 1); dx's y ring holds the planes copied but not yet masked,
// d + 1 .. d + 1 + kLook. At W = 64 shared memory is short: the forward
// looks one plane ahead, so that three blocks fit on an SM (measured
// faster than two blocks looking two ahead), and dx two (two blocks fit
// either way). Narrower classes look three ahead.
template <bool DX, int W>
struct MmaTile {
  static constexpr int kLook = W == 64 ? (DX ? 2 : 1) : 3;
  static constexpr int kRing = kLook + 4;
  static constexpr int kYRing = kLook + 1;
  static constexpr int kSlot = kMmaNB * W;
  static constexpr int kW = 3 * W * W;
  static constexpr int kOut = 16 * W;              // one warp's output tile
  static constexpr int kElems = kRing * kSlot + (DX ? kYRing * kSlot : 0) +
                                kW + kMmaWarps * kOut;
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * kElems;
};

// Physical 16-byte chunk of logical chunk j in a row of CH chunks: rows
// are XOR-swizzled so that the 8 rows an ldmatrix reads in one chunk
// column land in 8 distinct bank groups.
template <int CH>
__device__ __forceinline__ int swz(int row, int j) {
  constexpr int shift = CH == 1 ? 3 : CH == 2 ? 2 : CH == 4 ? 1 : 0;
  return j ^ ((row >> shift) & (CH - 1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  }
}
// acc (16 x 8, f32) += a (16 x 16, row) * b (16 x 8, col), bf16 inputs
__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The planes [d0, d0 + per) of one NB-pixel tile, bf16 on tensor cores,
// for width class W. Forward (DX false): a = x (B, D, N, kin = C), out =
// y (B, D, N, nout = F). dx (DX true): a = dy and yv = y (B, D, N, kin =
// F), out = dx (B, D, N, nout = C). w is (3, C, F) in both; off is read by
// the forward only. kin and nout are in {8, 16, 32, 64} and at most W.
template <bool DX, int W>
__device__ __forceinline__ void tap_planes_mma(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ yv,
    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ inv,
    const __nv_bfloat16* __restrict__ off, __nv_bfloat16* __restrict__ out,
    int D, int N, int kin, int nout, int relu, int per) {
  using Tile = MmaTile<DX, W>;
  using bf16 = __nv_bfloat16;
  constexpr int CHW = W / 8;                    // 16-byte chunks of a tile row
  constexpr int NT = W / 8;                     // 8-wide MMA column tiles
  constexpr int NB = kMmaNB, kLook = Tile::kLook, kRing = Tile::kRing,
                kYRing = Tile::kYRing;
  extern __shared__ uint4 smem_mma[];
  bf16* ring = reinterpret_cast<bf16*>(smem_mma);     // [kRing][NB][W]
  bf16* yring = ring + kRing * Tile::kSlot;           // [kYRing][NB][W] (dx)
  bf16* ws = yring + (DX ? kYRing * Tile::kSlot : 0); // [3][W (c)][W (f)]
  bf16* os = ws + Tile::kW;                           // [warps][16][W]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.z;
  const int n0 = blockIdx.x * NB;
  const int d0 = blockIdx.y * per, d1 = min(D, d0 + per);
  // real chunks of an input and an output row; the loops below walk all
  // CHW chunks of a tile row, so their trip counts are compile-time
  const int ch = kin / 8, cho = nout / 8;
  const int C = DX ? nout : kin, F = DX ? kin : nout;

  // the weights, native (3, C, F) rows, join the first plane's group;
  // rows past C and columns past F are zero-filled
  constexpr int kWChunks = 3 * W * CHW;
#pragma unroll
  for (int k = 0; k < (kWChunks + kMmaThreads - 1) / kMmaThreads; ++k) {
    const int i = tid + k * kMmaThreads;
    if (i >= kWChunks) break;
    const int row = i / CHW, j = i % CHW, t = row / W, c = row % W;
    const bool ok = c < C && 8 * j < F;
    cp_async16(ws + row * W + swz<CHW>(c, j) * 8,
               w + (ok ? (t * C + c) * F + 8 * j : 0), ok ? 16 : 0);
  }

  // copy plane p of the tile into its ring slot (and y's slot for dx),
  // zero-filled outside the tensor and past kin. A thread's chunk column
  // j = tid % CHW is the same in every row it copies (CHW | 128).
  auto fetch = [&](int p) {
    const int r = p - (d0 - 1);
    bf16* dst = ring + (r % kRing) * Tile::kSlot;
    bf16* ydst = yring + (r % kYRing) * Tile::kSlot;
    const bool in_d = p >= 0 && p < D;
#pragma unroll
    for (int k = 0; k < NB * CHW / kMmaThreads; ++k) {
      const int i = tid + k * kMmaThreads;
      const int row = i / CHW, j = i % CHW, n = n0 + row;
      const bool ok = in_d && n < N && j < ch;
      const int64_t g = ok ? ((b * D + p) * N + n) * kin + 8 * j : 0;
      const int s = row * W + swz<CHW>(row, j) * 8;
      cp_async16(dst + s, a + g, ok ? 16 : 0);
      if constexpr (DX) cp_async16(ydst + s, yv + g, ok ? 16 : 0);
    }
  };

  // dx: dz = bf16(dy * 1[y > 0] * inv) in place of dy, over the chunks
  // this thread copied (padding chunks stay 0)
  float sc_in[8];
  if constexpr (DX) {
    const int j = tid % CHW;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      sc_in[e] = j < ch ? to_f(inv[8 * j + e]) : 0.f;
  }
  auto mask = [&](int p) {
    const int r = p - (d0 - 1);
    bf16* z = ring + (r % kRing) * Tile::kSlot;
    const bf16* yy = yring + (r % kYRing) * Tile::kSlot;
#pragma unroll
    for (int k = 0; k < NB * CHW / kMmaThreads; ++k) {
      const int i = tid + k * kMmaThreads;
      const int row = i / CHW, j = i % CHW;
      const int s = row * W + swz<CHW>(row, j) * 8;
      uint4 gv = *reinterpret_cast<const uint4*>(z + s);
      const uint4 yq = *reinterpret_cast<const uint4*>(yy + s);
      bf16* ge = reinterpret_cast<bf16*>(&gv);
      const bf16* ye = reinterpret_cast<const bf16*>(&yq);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool keep = !relu || to_f(ye[e]) > 0.f;
        ge[e] = __float2bfloat16(keep ? to_f(ge[e]) * sc_in[e] : 0.f);
      }
      *reinterpret_cast<uint4*>(z + s) = gv;
    }
  };

  // forward epilogue coefficients of this thread's columns 8j + 2q + {0,1}
  // (0 past F: those columns are never stored)
  const int g = lane >> 2, q = lane & 3;
  float sc[NT][2], sh[NT][2];
  if constexpr (!DX) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * q + e;
        sc[j][e] = col < F ? to_f(inv[col]) : 0.f;
        sh[j][e] = col < F ? to_f(off[col]) : 0.f;
      }
  }

  // prologue: planes d0 - 1 .. d0 + kLook, one commit group each; dx
  // masks d0 - 1 and d0 before d0 + kLook takes the y slot of d0 - 1
  for (int p = d0 - 1; p <= d0 + kLook; ++p) {
    if constexpr (DX) {
      if (p == d0 + kLook) {
        cp_async_wait<kLook - 1>();
        mask(d0 - 1);
        mask(d0);
      }
    }
    if (p <= d1) fetch(p);
    cp_async_commit();
  }
  const int row0 = warp * 16;
  bf16* ow = os + warp * Tile::kOut;
  for (int d = d0; d < d1; ++d) {
    if (d + 1 + kLook <= d1) fetch(d + 1 + kLook);  // slot of plane d - 3
    cp_async_commit();
    cp_async_wait<kLook>();            // planes up to d + 1 have landed
    if constexpr (DX) mask(d + 1);
    __syncthreads();

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      // forward: tap t reads plane d - 1 + t with W_t (k = c, n = f);
      // dx: the same plane with W_{2-t} read transposed (k = f, n = c)
      const bf16* src = ring + ((d - d0 + t) % kRing) * Tile::kSlot;
      const bf16* wt = ws + (DX ? 2 - t : t) * W * W;
#pragma unroll
      for (int ks = 0; ks < W / 16; ++ks) {
        uint32_t af[4];
        const int ar = row0 + (lane & 15);
        ldmatrix_x4<false>(af, src + ar * W +
                                   swz<CHW>(ar, 2 * ks + (lane >> 4)) * 8);
        const int mat = lane >> 3, rr = lane & 7;
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t bf[4];
          int wrow, wch;
          if constexpr (DX) {       // rows n = c, chunks of k = f
            wrow = 8 * (2 * jp + (mat >> 1)) + rr;
            wch = 2 * ks + (mat & 1);
          } else {                  // rows k = c, chunks of n = f
            wrow = 16 * ks + 8 * (mat & 1) + rr;
            wch = 2 * jp + (mat >> 1);
          }
          ldmatrix_x4<!DX>(bf, wt + wrow * W + swz<CHW>(wrow, wch) * 8);
          mma_bf16(acc[2 * jp], af, bf[0], bf[1]);
          mma_bf16(acc[2 * jp + 1], af, bf[2], bf[3]);
        }
      }
    }

    // epilogue: round once to bf16 into the warp's tile, then 16-byte rows
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
        if constexpr (!DX) {
          v0 = v0 * sc[j][0] + sh[j][0];
          v1 = v1 * sc[j][1] + sh[j][1];
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
        }
        const int r = g + 8 * h;
        *reinterpret_cast<uint32_t*>(ow + r * W + swz<CHW>(r, j) * 8 +
                                     2 * q) = pack_bf16(v0, v1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 16 * CHW / 32; ++k) {
      const int i = lane + 32 * k;
      const int r = i / CHW, j = i % CHW, n = n0 + row0 + r;
      if (n < N && j < cho)
        *reinterpret_cast<uint4*>(out + ((b * D + d) * N + n) * nout + 8 * j) =
            *reinterpret_cast<const uint4*>(ow + r * W + swz<CHW>(r, j) * 8);
    }
    __syncwarp();
  }
}

template <int W>
__global__ void __launch_bounds__(kMmaThreads)
dtc_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ inv,
                   const __nv_bfloat16* __restrict__ off,
                   __nv_bfloat16* __restrict__ y, int D, int N, int C, int F,
                   int relu, int per) {
  tap_planes_mma<false, W>(x, nullptr, w, inv, off, y, D, N, C, F, relu, per);
}

template <int W>
__global__ void __launch_bounds__(kMmaThreads)
dtc_dx_mma_kernel(const __nv_bfloat16* __restrict__ y,
                  const __nv_bfloat16* __restrict__ dy,
                  const __nv_bfloat16* __restrict__ w,
                  const __nv_bfloat16* __restrict__ inv,
                  __nv_bfloat16* __restrict__ dx, int D, int N, int C, int F,
                  int relu, int per) {
  tap_planes_mma<true, W>(dy, y, w, inv, nullptr, dx, D, N, F, C, relu, per);
}

// ------------------------------------------------ fp32: CUDA cores

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

template <int FT>
__global__ void __launch_bounds__(kThreads)
dtc_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ inv, const float* __restrict__ off,
               float* __restrict__ y, int D, int N, int C, int relu) {
  constexpr int F = 4 * FT;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [3][C][F]
  float* xs = ws + 3 * C * F;                    // [DC + 2][C][NBP]
  const int64_t b = blockIdx.z;
  const int n0 = blockIdx.x * NB, d0 = blockIdx.y * DC;
  for (int i = threadIdx.x; i < 3 * C * F; i += kThreads) ws[i] = w[i];
  stage_rows<float>(xs, x, nullptr, nullptr, 0, b, D, N, C, d0 - 1, DC + 2,
                    n0);
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
    sc[j] = inv[fg * FT + j];
    sh[j] = off[fg * FT + j];
  }
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int n = n0 + pg * PT + i;
    if (n >= N) continue;
    float* yr = y + ((b * D + d) * N + n) * (int64_t)F + fg * FT;
#pragma unroll
    for (int j = 0; j < FT; ++j) {
      float v = acc[i][j] * sc[j] + sh[j];
      if (relu) v = fmaxf(v, 0.f);
      yr[j] = v;
    }
  }
}

// dx = tap conv of dz with W'_t = W_{2-t}^T; FT = C / 4 (dx channels).
template <int FT>
__global__ void __launch_bounds__(kThreads)
dtc_dx_kernel(const float* __restrict__ y, const float* __restrict__ dy,
              const float* __restrict__ w, const float* __restrict__ inv,
              float* __restrict__ dx, int D, int N, int F, int relu) {
  constexpr int C = 4 * FT;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [3][F][C]
  float* zs = ws + 3 * C * F;                    // [DC + 2][F][NBP]
  const int64_t b = blockIdx.z;
  const int n0 = blockIdx.x * NB, d0 = blockIdx.y * DC;
  for (int i = threadIdx.x; i < 3 * C * F; i += kThreads) {
    const int t = i / (C * F), rem = i - t * C * F;
    const int f = rem / C, c = rem - f * C;
    ws[i] = w[(2 - t) * C * F + c * F + f];
  }
  stage_rows<float>(zs, y, dy, inv, relu, b, D, N, F, d0 - 1, DC + 2, n0);
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
    float* r = dx + ((b * D + d) * N + n) * (int64_t)C + fg * FT;
#pragma unroll
    for (int j = 0; j < FT; ++j) r[j] = acc[i][j];
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

// ------------------------------------------------ launchers

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// Planes per block of the tensor-core kernels of width class W, of which
// `resident` blocks fit on an SM: D is cut into equal chunks, one block
// each per pixel tile. The rule follows what an H100 measured at the
// paper shapes (cli/depthconv_split.py; PERF.md):
// - W <= 32 stages at most 6 KB of weights per block and holds 4-5 blocks
//   per SM: many short blocks balance the SMs best, so chunks are
//   kNarrowPlanes planes long;
// - W = 64 stages 24 KB of weights per block and holds 2-3 per SM: the
//   fewest blocks that still fill one wave of resident blocks do best,
//   in chunks of at least kMinPlanes planes.
int planes_per_block(int B, int D, int tiles, int W, int resident) {
  int64_t chunks = (D + kNarrowPlanes - 1) / kNarrowPlanes;
  if (W == 64) {
    chunks = (int64_t)resident * sm_count() / ((int64_t)B * tiles);
    const int64_t most = (D + kMinPlanes - 1) / kMinPlanes;
    chunks = chunks < 1 ? 1 : chunks > most ? most : chunks;
  }
  return (int)((D + chunks - 1) / chunks);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool width_ok(int c) { return c == 8 || c == 16 || c == 32 || c == 64; }

// bf16 on tensor cores, the kernel of width class W: forward (DX false)
// or dx (DX true). a = x or dy, yv = y (dx only); C, F at most W.
template <bool DX, int W>
int launch_mma_class(const void* a, const void* yv, const void* w,
                     const void* inv, const void* off, void* out, int B,
                     int D, int N, int C, int F, int relu, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = MmaTile<DX, W>::kBytes;
  auto kern = DX ? dtc_dx_mma_kernel<W> : dtc_fwd_mma_kernel<W>;
  static const int e = set_smem(kern, smem);
  if (e) return e;
  static const int resident = [&] {
    int n = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kMmaThreads, smem);
    return n < 1 ? 1 : n;
  }();
  const int tiles = (N + kMmaNB - 1) / kMmaNB;
  const int per = planes_per_block(B, D, tiles, W, resident);
  dim3 grid(tiles, (D + per - 1) / per, B);
  if constexpr (DX) {
    kern<<<grid, kMmaThreads, smem, s>>>((const bf16*)yv, (const bf16*)a,
                                         (const bf16*)w, (const bf16*)inv,
                                         (bf16*)out, D, N, C, F, relu, per);
  } else {
    kern<<<grid, kMmaThreads, smem, s>>>((const bf16*)a, (const bf16*)w,
                                         (const bf16*)inv, (const bf16*)off,
                                         (bf16*)out, D, N, C, F, relu, per);
  }
  return (int)cudaGetLastError();
}

// the tensor-core launch of the narrowest width class that holds C and F
template <bool DX>
int launch_mma(const void* a, const void* yv, const void* w, const void* inv,
               const void* off, void* out, int B, int D, int N, int C, int F,
               int relu, cudaStream_t s) {
  if (!width_ok(C) || !width_ok(F)) return EDS_ERR_UNSUPPORTED;
  if (!aligned16(a) || !aligned16(w) || !aligned16(out) ||
      (DX && !aligned16(yv)))
    return EDS_ERR_UNSUPPORTED;
  const int wc = C > F ? C : F;
  if (wc <= 16)
    return launch_mma_class<DX, 16>(a, yv, w, inv, off, out, B, D, N, C, F,
                                    relu, s);
  if (wc == 32)
    return launch_mma_class<DX, 32>(a, yv, w, inv, off, out, B, D, N, C, F,
                                    relu, s);
  return launch_mma_class<DX, 64>(a, yv, w, inv, off, out, B, D, N, C, F,
                                  relu, s);
}

template <int FT>
int launch_fwd(const void* x, const void* w, const void* inv, const void* off,
               void* y, int B, int D, int N, int C, int relu,
               cudaStream_t s) {
  const int F = 4 * FT;
  const size_t smem = sizeof(float) * (3 * C * F + (DC + 2) * C * NBP);
  auto kern = dtc_fwd_kernel<FT>;
  if (int e = set_smem(kern, smem)) return e;
  dim3 grid((N + NB - 1) / NB, (D + DC - 1) / DC, B);
  kern<<<grid, kThreads, smem, s>>>((const float*)x, (const float*)w,
                                    (const float*)inv, (const float*)off,
                                    (float*)y, D, N, C, relu);
  return (int)cudaGetLastError();
}

template <int FT>
int launch_dx(const void* y, const void* dy, const void* w, const void* inv,
              void* dx, int B, int D, int N, int F, int relu,
              cudaStream_t s) {
  const int C = 4 * FT;
  const size_t smem = sizeof(float) * (3 * C * F + (DC + 2) * F * NBP);
  auto kern = dtc_dx_kernel<FT>;
  if (int e = set_smem(kern, smem)) return e;
  dim3 grid((N + NB - 1) / NB, (D + DC - 1) / DC, B);
  kern<<<grid, kThreads, smem, s>>>((const float*)y, (const float*)dy,
                                    (const float*)w, (const float*)inv,
                                    (float*)dx, D, N, F, relu);
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

// fn(std::integral_constant<int, ch>) for a channel count in {8, 16, 32, 64}
template <class Fn>
int with_width(int ch, Fn&& fn) {
  switch (ch) {
    case 8: return fn(std::integral_constant<int, 8>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 64: return fn(std::integral_constant<int, 64>{});
  }
  return EDS_ERR_UNSUPPORTED;
}

// a channel count the fp32 staging takes: it divides kThreads, at most kMaxC
bool channels_ok(int c) {
  return c >= 1 && c <= kMaxC && kThreads % c == 0;
}

}  // namespace

// x (B, D, N, C), w (3, C, F), inv/off (F,) -> y (B, D, N, F); all in the
// same dtype. C, F in {8, 16, 32, 64}; bf16 pointers 16-byte aligned.
extern "C" int dtc_forward(int dtype, const void* x, const void* w,
                           const void* inv, const void* off, void* y, int B,
                           int D, int N, int C, int F, int relu,
                           void* stream) {
  if (!channels_ok(C)) return EDS_ERR_UNSUPPORTED;
  if ((int64_t)B * D * N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EDS_DTYPE_BF16) {
    return launch_mma<false>(x, nullptr, w, inv, off, y, B, D, N, C, F,
                             relu, s);
  }
  if (dtype != EDS_DTYPE_F32) return EDS_ERR_UNSUPPORTED;
  return with_width(F, [&](auto f) {
    return launch_fwd<decltype(f)::value / 4>(x, w, inv, off, y, B, D, N, C,
                                               relu, s);
  });
}

// dx (B, D, N, C) from y, dy (B, D, N, F). C, F in {8, 16, 32, 64}.
extern "C" int dtc_backward_dx(int dtype, const void* y, const void* dy,
                               const void* w, const void* inv, void* dx,
                               int B, int D, int N, int C, int F, int relu,
                               void* stream) {
  if (!channels_ok(F)) return EDS_ERR_UNSUPPORTED;
  if ((int64_t)B * D * N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EDS_DTYPE_BF16) {
    return launch_mma<true>(dy, y, w, inv, nullptr, dx, B, D, N, C, F,
                            relu, s);
  }
  if (dtype != EDS_DTYPE_F32) return EDS_ERR_UNSUPPORTED;
  return with_width(C, [&](auto c) {
    return launch_dx<decltype(c)::value / 4>(y, dy, w, inv, dx, B, D, N, F,
                                              relu, s);
  });
}

// dw (3, C, F) and dco (2, F) in f32, zeroed here and summed over the
// whole (B, D, N) grid. F in {8, 16, 32, 64}, C <= 64.
extern "C" int dtc_backward_w(int dtype, const void* x, const void* y,
                              const void* dy, const void* w, const void* inv,
                              float* dw, float* dco, int B, int D, int N,
                              int C, int F, int relu, void* stream) {
  if (!channels_ok(C)) return EDS_ERR_UNSUPPORTED;
  cudaStream_t s = (cudaStream_t)stream;
  return with_width(F, [&](auto f) {
    constexpr int FT = decltype(f)::value / 4;
    if (dtype == EDS_DTYPE_F32)
      return launch_wgrad<float, FT>(x, y, dy, w, inv, dw, dco, B, D, N, C,
                                     relu, s);
    if (dtype == EDS_DTYPE_BF16)
      return launch_wgrad<__nv_bfloat16, FT>(x, y, dy, w, inv, dw, dco, B, D,
                                             N, C, relu, s);
    return EDS_ERR_UNSUPPORTED;
  });
}
