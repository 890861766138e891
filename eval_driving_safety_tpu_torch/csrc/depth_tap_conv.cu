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
// The weight gradient takes all three from one product: with A_d =
// [x[d-1] | x[d] | x[d+1]], G = sum_{b,d} A_d^T dm[d] is (3C x F), and
//   dW_t = inv * G_t,  d inv = sum_{t,c} W_t * G_t,  d off = sum dm
// (sum dm z = sum dm sum_t x W_t), so z is not recomputed and nothing is
// divided by inv.
//
// Which kernel replaces which TPU kernel of
// eval_driving_safety_tpu/ops/pallas_depthconv.py, by dtype:
//   bf16 forward   dtc_fwd_mma_kernel  <- `_fwd_kernel` (via `_pallas_fwd`)
//   bf16 dx        dtc_dx_mma_kernel   <- `_bwd_kernel`'s dx (`_pallas_bwd`)
//   fp32 forward   dtc_f32_kernel<false, F>  <- `_fwd_kernel`
//   fp32 dx        dtc_f32_kernel<true, C>   <- `_bwd_kernel`'s dx
//   bf16 dW, d inv, d off  dtc_wgrad_mma_kernel + dtc_wgrad_reduce_kernel
//                                      <- `_bwd_kernel`'s rest
//   fp32 dW, d inv, d off  dtc_wgrad_f32_kernel + dtc_wgrad_reduce_kernel
//                                      <- `_bwd_kernel`'s rest
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
// The weight gradient (training only) is one split-K GEMM, M = 3C (+ a
// ones row for d off), N = F, K = B D N: the same staged x planes with
// their halo give A, dm formed in shared memory without inv (exact in
// bf16) gives B, both read with ldmatrix .trans. Its bytes are the dx
// kernel's (x, y, dy once) and its operations one conv's, so it is bytes
// bound too. The K range is cut into slices by the launch shape alone;
// each block writes its f32 partial of G to a workspace, and a second
// kernel sums the partials in slice order and applies the epilogue, so
// the sums are the same bits on every run and every card, without atomics.
//
// fp32 design (the fp32 card-vs-CPU checks; no CLI builds an fp32 DSGN).
// Tensor cores take f32 only as TF32, whose one pass does not hold the
// fp32 tolerance of 1e-5, so fp32 runs on CUDA-core FMAs and is bound by
// operations (67 TFLOP/s against 3.35 TB/s). dtc_f32_kernel serves the
// forward and dx, templated on the output width KOUT: the launch's items
// (b, pixel tile, output plane) are cut into one wave of equal contiguous
// runs, one per block, and a block walks its runs' input planes in order.
// Each plane's tile (NB pixels x kin channels, channel-last as in memory,
// rows padded by 4 floats so a warp's reads of 8 rows hit distinct banks)
// is copied by 16-byte cp.async into a ring, the next plane in flight
// while this one is computed; runs cross tile boundaries within a block,
// and the copies run ahead across them. Each input plane is read from
// device memory once per run, a halo plane at each end. A thread holds
// TM = 4 pixels x 8 outputs of three output planes in registers (96
// accumulators): input plane e adds tap 0 to output e + 1, tap 1 to e,
// tap 2 to e - 1, so a staged plane is read once and output e - 1 is
// then written. Per channel a thread reads TM x floats and 8 weight floats
// per tap for 24 FMAs a tap, and its warp's weight reads are broadcasts
// of one row: the FMAs, not shared memory, set the pace. The weights (W_t,
// or for dx W_{2-t}^T) and inv/off are staged once per block. dx forms dz
// = dy * 1[y > 0] * inv in f32 in the thread that copied each chunk, once
// per staged plane. The forward epilogue applies inv/off and the ReLU in
// f32 and every thread stores its pixels' outputs as 16-byte runs. Each
// output is summed in one fixed order (taps 0, 1, 2, channels in order)
// and written by one thread, so the result does not depend on the split.
// The fp32 weight gradient (only when the weights need a gradient) is
// the bf16 one's split-K GEMM on CUDA cores, followed by the same ordered
// reduction: dtc_wgrad_f32_kernel cuts the (b, pixel tile, plane) items
// into slices by the launch shape alone and walks each slice's runs of
// planes through a cp.async ring as dtc_f32_kernel does (F32Run), a
// thread holding 4 channels x 8 outputs x 3 taps of G (96 accumulators)
// for the whole slice, so that 20 shared floats feed 96 FMAs. Nothing is
// added with atomics, and z is not recomputed: the sums are the same bits
// on every run.
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
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  }
}
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  ldmatrix_x4<TRANS>(r, smem_u32(p));
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

// ------------------------------------------------ bf16 weight gradient

// G = sum_{b,d} A_d^T dm[d] (3C + 1 rows, F columns) as one split-K GEMM:
// rows (t, c) pair plane d + t - 1 of x with plane d of dm, and a last
// row of ones sums dm (d off). K = B * D * N is cut into `slices`
// contiguous runs of plane-tiles (b, 64-pixel tile, plane d), one block
// each; a block walks the planes of one tile in order through a ring of
// staged planes, then moves on to its next tile. Shared memory per class
// W, in bf16 elements: x ring [kXRing][NB][W] (planes d - 1 .. d + 1 +
// kWgLook, the one-plane halo included), dy ring [kMRing][NB][W], masked
// in place into dm (planes d .. d + 1 + kWgLook), y ring [kYRing][NB][W]
// (planes copied but not masked yet). One barrier per plane: the copy of
// plane d + 1 + kWgLook is issued after it, when every warp has finished
// plane d - 1.
constexpr int kWgLook = 2;
constexpr int kWgParts = 4;                // runs of slices the reduction sums
constexpr int kWgReduceThreads = 1024;     // kWgParts x 256 >= 3 * 64 + 1

template <int W>
struct WgradTile {
  static constexpr int kXRing = kWgLook + 3;
  static constexpr int kMRing = kWgLook + 2;
  static constexpr int kYRing = kWgLook + 1;
  static constexpr int kSlot = kMmaNB * W;
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (kXRing + kMRing + kYRing) * kSlot;
  // output tiles: kMT 16-row tiles of (t, c) rows (kCT per tap) plus the
  // ones tile, kNT 8-column tiles of f; each warp owns kMW x kNW of them
  // and walks every pixel of every plane for them (no warp reduction)
  static constexpr int kCT = W / 16;
  static constexpr int kMT = 3 * kCT + 1;
  static constexpr int kNT = W / 8;
  static constexpr int kWarpsN = W == 16 ? 1 : kMmaWarps;
  static constexpr int kMW = kMT / (kMmaWarps / kWarpsN);
  static constexpr int kNW = kNT / kWarpsN;
  static_assert(kMW * (kMmaWarps / kWarpsN) == kMT && kNW >= 1 && kNW <= 2,
                "warp tiling");
};

// Slice s of the split-K GEMM, width class W: its (F, 3C + 1) f32 partial
// of G goes to ws[s]. x (B, D, N, C); y, dy (B, D, N, F); C, F <= W.
template <int W>
__global__ void __launch_bounds__(kMmaThreads)
dtc_wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ y,
                     const __nv_bfloat16* __restrict__ dy,
                     float* __restrict__ ws, int D, int N, int C, int F,
                     int relu, int64_t items, int slices) {
  using Tile = WgradTile<W>;
  using bf16 = __nv_bfloat16;
  constexpr int CHW = W / 8, NB = kMmaNB, kCT = Tile::kCT;
  constexpr int kXRing = Tile::kXRing, kMRing = Tile::kMRing,
                kYRing = Tile::kYRing;
  extern __shared__ uint4 smem_mma[];
  bf16* xring = reinterpret_cast<bf16*>(smem_mma);
  bf16* mring = xring + kXRing * Tile::kSlot;
  bf16* yring = mring + kMRing * Tile::kSlot;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, mat = lane >> 3, rr = lane & 7;
  // the warp's tiles: m-tiles wm kMW.., n-tiles wn kNW.. (wm is 0 at W >=
  // 32, known here, so that each m-tile's tap and columns are constants)
  const int wm = Tile::kWarpsN == kMmaWarps ? 0 : warp;
  const int wn = Tile::kWarpsN == kMmaWarps ? warp : 0;
  const int ch = C / 8, chf = F / 8;
  const int tiles = (N + NB - 1) / NB;
  const int64_t s = blockIdx.x;
  const int64_t i0 = s * items / slices, i1 = (s + 1) * items / slices;

  float acc[Tile::kMW][Tile::kNW][4];
#pragma unroll
  for (int mi = 0; mi < Tile::kMW; ++mi)
#pragma unroll
    for (int ni = 0; ni < Tile::kNW; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  // the current run: planes [d0, d1) of tile n0 of image b
  int64_t b = 0;
  int n0 = 0, d0 = 0, d1 = 0;

  // x plane p (zero outside [0, D)) and, for p in [d0, d1), dy and y
  // plane p into their slots; zero past N and past C or F. A thread's
  // chunk column j = tid % CHW is the same in every row it copies.
  auto fetch = [&](int p) {
    const int r = p - (d0 - 1);
    bf16* xd = xring + (r % kXRing) * Tile::kSlot;
    bf16* md = mring + (r % kMRing) * Tile::kSlot;
    bf16* yd = yring + (r % kYRing) * Tile::kSlot;
    const bool in_x = p >= 0 && p < D, in_m = p >= d0 && p < d1;
#pragma unroll
    for (int k = 0; k < NB * CHW / kMmaThreads; ++k) {
      const int i = tid + k * kMmaThreads;
      const int row = i / CHW, j = i % CHW, n = n0 + row;
      const int sw = row * W + swz<CHW>(row, j) * 8;
      const int64_t pix = (b * D + p) * N + n;
      const bool okx = in_x && n < N && j < ch;
      cp_async16(xd + sw, x + (okx ? pix * C + 8 * j : 0), okx ? 16 : 0);
      if (in_m) {
        const bool okm = n < N && j < chf;
        const int64_t gm = okm ? pix * F + 8 * j : 0;
        cp_async16(md + sw, dy + gm, okm ? 16 : 0);
        if (relu) cp_async16(yd + sw, y + gm, okm ? 16 : 0);
      }
    }
  };
  // dm = dy * 1[y > 0] in place of dy, over the chunks this thread copied
  // (exact in bf16: nothing is rounded)
  auto mask = [&](int p) {
    const int r = p - (d0 - 1);
    bf16* md = mring + (r % kMRing) * Tile::kSlot;
    const bf16* yd = yring + (r % kYRing) * Tile::kSlot;
#pragma unroll
    for (int k = 0; k < NB * CHW / kMmaThreads; ++k) {
      const int i = tid + k * kMmaThreads;
      const int row = i / CHW, j = i % CHW;
      const int sw = row * W + swz<CHW>(row, j) * 8;
      uint4 mv = *reinterpret_cast<const uint4*>(md + sw);
      const uint4 yq = *reinterpret_cast<const uint4*>(yd + sw);
      bf16* me = reinterpret_cast<bf16*>(&mv);
      const bf16* ye = reinterpret_cast<const bf16*>(&yq);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (!(to_f(ye[e]) > 0.f)) me[e] = __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(md + sw) = mv;
    }
  };

  // lane parts of the fragment addresses within a slot, the same for
  // every plane and k-step (16-row steps leave a row's swizzle unchanged):
  // A's 8 x 8 matrices are (pixel rows 0-7 | 8-15) x (columns c0 | c0 +
  // 8), B's (rows 0-7 | 8-15) x (n-tile 2 pair | 2 pair + 1)
  const int arow = 8 * (mat >> 1) + rr, brow = 8 * (mat & 1) + rr;
  int a_off[kCT];
#pragma unroll
  for (int ct = 0; ct < kCT; ++ct)
    a_off[ct] = arow * W + swz<CHW>(arow, 2 * ct + (mat & 1)) * 8;
  const int b_off =
      brow * W + swz<CHW>(brow, 2 * (wn * Tile::kNW / 2) + (mat >> 1)) * 8;

  for (int64_t i = i0; i < i1;) {
    const int64_t bt = i / D;
    b = bt / tiles;
    n0 = (int)(bt % tiles) * NB;
    d0 = (int)(i % D);
    d1 = i1 - i < D - d0 ? d0 + (int)(i1 - i) : D;
    // prologue: planes d0 - 1 .. d0 + kWgLook, one commit group each
    for (int p = d0 - 1; p <= d0 + kWgLook; ++p) {
      if (p <= d1) fetch(p);
      cp_async_commit();
    }
    for (int d = d0; d < d1; ++d) {
      cp_async_wait<kWgLook - 1>();      // planes up to d + 1 have landed
      if (relu) mask(d);
      __syncthreads();
      if (d + 1 + kWgLook <= d1) fetch(d + 1 + kWgLook);  // slots of d - 2
      cp_async_commit();

      const uint32_t ms =
          smem_u32(mring + ((d - d0 + 1) % kMRing) * Tile::kSlot + b_off);
      uint32_t xs[3];                     // slots of planes d - 1, d, d + 1
#pragma unroll
      for (int t = 0; t < 3; ++t)
        xs[t] = smem_u32(xring + ((d - d0 + t) % kXRing) * Tile::kSlot);
      // A of m-tile mi at k-step ks: x[d - 1 + t]^T (m = c, k = pixel),
      // pixel-major, so ldmatrix .trans; the ones tile's row 0 is 1 (its
      // output is sum dm). False for padding rows past C (no products).
      auto load_a = [&](uint32_t (&a)[4], int mi, int ks) {
        const int mt = wm * Tile::kMW + mi;
        if (mt == 3 * kCT) {
          const uint32_t one = g == 0 ? 0x3F803F80u : 0u;   // bf16 1, 1
          a[0] = a[2] = one;
          a[1] = a[3] = 0u;
          return true;
        }
        const int t = mt / kCT, ct = mt % kCT;
        if (16 * ct >= C) return false;
        const uint32_t base = t == 0 ? xs[0] : t == 1 ? xs[1] : xs[2];
        ldmatrix_x4<true>(a, base + 2 * (16 * ks * W + a_off[ct]));
        return true;
      };
#pragma unroll
      for (int ks = 0; ks < NB / 16; ++ks) {
        // B = dm[d] (k = pixel, n = f), pixel-major: ldmatrix .trans
        uint32_t bq[Tile::kNW][2];
        {
          uint32_t r4[4];
          ldmatrix_x4<true>(r4, ms + 2 * 16 * ks * W);
          if constexpr (Tile::kNW == 2) {
            bq[0][0] = r4[0]; bq[0][1] = r4[1];
            bq[1][0] = r4[2]; bq[1][1] = r4[3];
          } else {                                 // the warp's half
            const bool hi = wn & 1;
            bq[0][0] = hi ? r4[2] : r4[0];
            bq[0][1] = hi ? r4[3] : r4[1];
          }
        }
        // each m-tile's A is loaded one m-tile ahead of its products
        uint32_t a[2][4];
        bool live[2];
        live[0] = load_a(a[0], 0, ks);
#pragma unroll
        for (int mi = 0; mi < Tile::kMW; ++mi) {
          if (mi + 1 < Tile::kMW)
            live[(mi + 1) & 1] = load_a(a[(mi + 1) & 1], mi + 1, ks);
          if (!live[mi & 1]) continue;
#pragma unroll
          for (int ni = 0; ni < Tile::kNW; ++ni)
            mma_bf16(acc[mi][ni], a[mi & 1], bq[ni][0], bq[ni][1]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();          // the next run's prologue reuses every slot
    i += d1 - d0;
  }

  // this slice's partial, ws[s] laid out (F, 3C + 1): row k = t C + c,
  // and k = 3C for the ones row
  const int K3 = 3 * C + 1;
  float* out = ws + s * F * K3;
#pragma unroll
  for (int mi = 0; mi < Tile::kMW; ++mi) {
    const int mt = wm * Tile::kMW + mi;
#pragma unroll
    for (int ni = 0; ni < Tile::kNW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1);
        const int f = (wn * Tile::kNW + ni) * 8 + 2 * q + (e & 1);
        const int c = 16 * (mt % kCT) + row;
        const int k = mt == 3 * kCT ? (row == 0 ? 3 * C : -1)
                                    : (c < C ? (mt / kCT) * C + c : -1);
        if (k >= 0 && f < F) out[f * K3 + k] = acc[mi][ni][e];
      }
  }
}

// One block per f: G[k][f] = the slices' partials summed in a fixed order
// (kWgParts contiguous runs of slices, each summed in slice order by its
// own threads, then the runs in order), then dW = inv G, d off = G[3C],
// d inv = sum_k W[k][f] G[k][f] as a fixed tree. Every output is written
// once; the same inputs give the same bits on every run. T is the
// element type of w and inv (bf16 or f32); both weight gradients end here.
template <typename T>
__global__ void __launch_bounds__(kWgReduceThreads)
dtc_wgrad_reduce_kernel(const float* __restrict__ ws,
                        const T* __restrict__ w, const T* __restrict__ inv,
                        float* __restrict__ dw, float* __restrict__ dco,
                        int C, int F, int slices) {
  constexpr int kOut = kWgReduceThreads / kWgParts;
  __shared__ float part[kWgParts][kOut];
  const int f = blockIdx.x, k = threadIdx.x % kOut, p = threadIdx.x / kOut;
  const int K3 = 3 * C + 1;
  float gs = 0.f;
  if (k < K3) {
    const float* src = ws + (int64_t)f * K3 + k;
    const int64_t stride = (int64_t)F * K3;
    const int s1 = (p + 1) * slices / kWgParts;
#pragma unroll 4
    for (int s = p * slices / kWgParts; s < s1; ++s) gs += src[s * stride];
  }
  part[p][k] = gs;
  __syncthreads();
  float prod = 0.f;
  if (p == 0) {
    float g = part[0][k];
#pragma unroll
    for (int j = 1; j < kWgParts; ++j) g += part[j][k];
    if (k < 3 * C) {
      dw[k * F + f] = g * to_f(inv[f]);
      prod = to_f(w[k * F + f]) * g;
    } else if (k == 3 * C) {
      dco[F + f] = g;
    }
  }
  __syncthreads();                    // every run's sum has been read
  if (p == 0) part[0][k] = prod;
  __syncthreads();
#pragma unroll
  for (int h = kOut / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) part[0][threadIdx.x] += part[0][threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) dco[f] = part[0][0];
}

// ------------------------------------------ fp32 forward and dx: CUDA cores

// One kernel per direction and output width KOUT (F for the forward, C
// for dx); the input width kin (C, or F for dx) is a launch argument.
// The (b, pixel tile, output plane) items of a launch are cut into equal
// contiguous runs, one per block, and a block walks its runs' input
// planes in order through a ring of staged planes. A thread owns TM
// pixels x 8 outputs of three output planes at once: input plane e adds
// tap 0 to output plane e + 1, tap 1 to e and tap 2 to e - 1 (acc[t]),
// so a staged plane is read by the FMAs once and then dropped, and an
// output plane is complete, and written, after input plane e + 1.
// The choices below are the fastest that cli/depthconv_split.py --fp32
// timed at the paper shapes on an H100 (PERF.md): 4 pixels a thread over
// 2; one plane in flight (a second moved nothing: a plane's FMAs outlast
// its copy); two blocks an SM at widths up to 32, which leaves a thread
// 255 registers (three leave 168, and the forward then spills).
constexpr int kF32Threads = 128;
constexpr int kF32PixelsPerThread = 4;  // TM at output widths 32 and 64
constexpr int kF32Look = 1;             // planes in flight past the current
constexpr int kF32MinBlocks = 2;        // resident blocks an SM, widths <= 32

template <int KOUT>
struct F32Tile {
  static constexpr int G = KOUT / 8;           // groups of 8 outputs
  static constexpr int GW = G < 4 ? G : 4;     // groups within one warp
  static constexpr int WG = G / GW;            // warps across the groups
  static constexpr int P = kF32Threads / G;    // pixel groups of a block
  // pixels a thread: kF32PixelsPerThread, but a tile of at most 128
  static constexpr int TMax = P >= 128 ? 1 : 128 / P;
  static constexpr int TM =
      kF32PixelsPerThread < TMax ? kF32PixelsPerThread : TMax;
  static constexpr int NB = P * TM;            // pixels of a tile
  static constexpr int WS = KOUT + 4;          // staged weight row, floats
  // resident blocks the registers must leave room for (shared memory
  // holds no more than two at KOUT = 64)
  static constexpr int kMinBlocks = KOUT == 64 ? 2 : kF32MinBlocks;
};

// The run of a block being fetched or computed: output planes [d0, d1)
// of pixel tile n0 of image b, read as input planes e = max(d0 - 1, 0)
// .. hi = min(d1, D - 1) (planes outside [0, D) are zero and skipped).
struct F32Run {
  int64_t item, b;   // the run's first item; its image
  int n0, d0, d1, e, hi;
};

__device__ __forceinline__ bool f32_begin(F32Run& r, int64_t item,
                                          int64_t i1, int D, int tiles,
                                          int nb) {
  if (item >= i1) return false;
  const int64_t bt = item / D;
  r.item = item;
  r.b = bt / tiles;
  r.n0 = (int)(bt - r.b * tiles) * nb;
  r.d0 = (int)(item - bt * D);
  r.d1 = i1 - item < D - r.d0 ? r.d0 + (int)(i1 - item) : D;
  r.e = r.d0 > 0 ? r.d0 - 1 : 0;
  r.hi = r.d1 < D ? r.d1 : D - 1;
  return true;
}

// the next input plane of the block's walk (the next run's first one
// after a run's last); false past the block's last item
__device__ __forceinline__ bool f32_next(F32Run& r, int64_t i1, int D,
                                         int tiles, int nb) {
  if (++r.e <= r.hi) return true;
  return f32_begin(r, r.item + (r.d1 - r.d0), i1, D, tiles, nb);
}

// acc[t] += x W_t for each tap t in MASK, channel by channel in order:
// x is this thread's TM pixel rows of the staged plane (`xs`, rows rsP
// floats apart), W_t rows of the staged weights (`wt`, this thread's
// first output column, taps wtap floats apart). Outputs 0-3 of a thread
// are columns wt[0..3], outputs 4-7 columns wt[KOUT / 2 ..].
template <int MASK, int TM, int KOUT>
__device__ __forceinline__ void f32_taps(const float* __restrict__ xs,
                                         int rsP,
                                         const float* __restrict__ wt,
                                         int wtap, int kin,
                                         float (&acc)[3][TM][8]) {
  constexpr int WS = KOUT + 4;
#pragma unroll 2
  for (int c4 = 0; c4 < kin / 4; ++c4) {
    float4 xv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xs + i * rsP + 4 * c4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* wr = wt + (4 * c4 + j) * WS;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if (!((MASK >> t) & 1)) continue;
        const float4 w0 = *reinterpret_cast<const float4*>(wr + t * wtap);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wr + t * wtap + KOUT / 2);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float xe = j == 0 ? xv[i].x : j == 1 ? xv[i].y
                         : j == 2 ? xv[i].z : xv[i].w;
          float* o = acc[t][i];
          o[0] = fmaf(xe, w0.x, o[0]);
          o[1] = fmaf(xe, w0.y, o[1]);
          o[2] = fmaf(xe, w0.z, o[2]);
          o[3] = fmaf(xe, w0.w, o[3]);
          o[4] = fmaf(xe, w1.x, o[4]);
          o[5] = fmaf(xe, w1.y, o[5]);
          o[6] = fmaf(xe, w1.z, o[6]);
          o[7] = fmaf(xe, w1.w, o[7]);
        }
      }
    }
  }
}

// Forward (DX false): a = x (B, D, N, kin = C), out = y (B, D, N, KOUT =
// F). dx (DX true): a = dy and yv = y (B, D, N, kin = F), out = dx (B, D,
// N, KOUT = C); off is read by the forward only. w is (3, C, F) in both.
// a, yv and out are 16-byte aligned; `items` = B * tiles * D.
template <bool DX, int KOUT>
__global__ void __launch_bounds__(kF32Threads, F32Tile<KOUT>::kMinBlocks)
dtc_f32_kernel(const float* __restrict__ a, const float* __restrict__ yv,
               const float* __restrict__ w, const float* __restrict__ inv,
               const float* __restrict__ off, float* __restrict__ out,
               int D, int N, int kin, int relu, int64_t items) {
  using T = F32Tile<KOUT>;
  constexpr int TM = T::TM, NB = T::NB, P = T::P, WS = T::WS;
  constexpr int kRing = kF32Look + 1;
  extern __shared__ float4 smem_f32[];
  const int rs = kin + 4, slot = NB * rs;      // padded pixel rows
  float* ring = reinterpret_cast<float*>(smem_f32);  // [kRing][NB][rs]
  float* yring = ring + kRing * slot;          // [kF32Look][NB][rs] (dx)
  float* ws = yring + (DX ? kF32Look * slot : 0);    // [3][kin][WS]
  float* cs = ws + 3 * kin * WS;               // inv, off [2][KOUT] (fwd)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // output group fg (outputs 4 fg .. + 3 and KOUT / 2 + 4 fg .. + 3) and
  // pixel group pg (tile pixels pg + P i): a warp holds GW groups of
  // 32 / GW consecutive pixel rows, so its x reads hit distinct banks
  // (rs / 4 is odd) and its weight reads are broadcasts of one row
  const int fg = lane % T::GW + T::GW * (warp % T::WG);
  const int pg = lane / T::GW + (32 / T::GW) * (warp / T::WG);
  const int C = DX ? KOUT : kin, F = DX ? kin : KOUT;

  // the weights once per block: forward ws[t][c][f] = W_t; dx ws[t][f][c]
  // = W_{2-t}^T, so that dx is the same walk over dz
  for (int i = tid; i < 3 * C * F; i += kF32Threads) {
    const int t = i / (C * F), r = i - t * (C * F), c = r / F, f = r - c * F;
    if constexpr (DX)
      ws[((2 - t) * F + f) * WS + c] = w[i];
    else
      ws[(t * C + c) * WS + f] = w[i];
  }
  if constexpr (!DX) {
    for (int i = tid; i < KOUT; i += kF32Threads) {
      cs[i] = inv[i];
      cs[KOUT + i] = off[i];
    }
  }
  // a thread copies chunk column jc of tile rows r0, r0 + rstep, ...
  // (kin / 4 divides the threads), the same chunks of every plane; dx
  // scales them by inv
  const int ch = kin / 4, jc = tid % ch, r0 = tid / ch;
  const int rstep = kF32Threads / ch;
  const int own = r0 * rs + 4 * jc, own_step = rstep * rs;
  float4 sc = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (DX)
    sc = make_float4(inv[4 * jc], inv[4 * jc + 1], inv[4 * jc + 2],
                     inv[4 * jc + 3]);

  // copy input plane r.e of r's tile into ring slot s (and y's slot for
  // dx); rows past N are zero-filled
  auto fetch = [&](const F32Run& r, int s) {
    float* dst = ring + (s % kRing) * slot + own;
    float* ydst = yring + (s % kF32Look) * slot + own;
    const int64_t plane = (r.b * D + r.e) * (int64_t)N * kin;
    int64_t g = plane + (int64_t)(r.n0 + r0) * kin + 4 * jc;
    const int64_t g_step = (int64_t)rstep * kin;
    for (int row = r0, n = r.n0 + r0; row < NB; row += rstep, n += rstep) {
      const bool ok = n < N;
      cp_async16(dst, a + (ok ? g : plane), ok ? 16 : 0);
      if (DX && relu) cp_async16(ydst, yv + (ok ? g : plane), ok ? 16 : 0);
      dst += own_step;
      ydst += own_step;
      g += g_step;
    }
  };
  // dx: dz = dy * 1[y > 0] * inv (or dy * inv: y is not copied) in f32,
  // in place of dy, over the chunks this thread copied
  auto mask = [&](int s) {
    float* z = ring + (s % kRing) * slot + own;
    const float* yy = yring + (s % kF32Look) * slot + own;
    for (int row = r0; row < NB; row += rstep, z += own_step, yy += own_step) {
      float4 g = *reinterpret_cast<const float4*>(z);
      if (relu) {
        const float4 q = *reinterpret_cast<const float4*>(yy);
        g.x = q.x > 0.f ? g.x * sc.x : 0.f;
        g.y = q.y > 0.f ? g.y * sc.y : 0.f;
        g.z = q.z > 0.f ? g.z * sc.z : 0.f;
        g.w = q.w > 0.f ? g.w * sc.w : 0.f;
      } else {
        g.x *= sc.x;
        g.y *= sc.y;
        g.z *= sc.z;
        g.w *= sc.w;
      }
      *reinterpret_cast<float4*>(z) = g;
    }
  };
  // write output plane d of r's tile from v: the forward applies inv, off
  // and the ReLU in f32; each thread stores its pixels' two 16-byte runs
  auto emit = [&](const float (&v)[TM][8], const F32Run& r, int d) {
    float* o = out + (r.b * D + d) * (int64_t)N * KOUT + 4 * fg;
    float s8[8], h8[8];
    if constexpr (!DX) {
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int col = 4 * fg + (f < 4 ? f : KOUT / 2 + f - 4);
        s8[f] = cs[col];
        h8[f] = cs[KOUT + col];
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int n = r.n0 + pg + P * i;
      if (n >= N) continue;
      float q[8];
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        q[f] = v[i][f];
        if constexpr (!DX) {
          q[f] = q[f] * s8[f] + h8[f];
          if (relu) q[f] = fmaxf(q[f], 0.f);
        }
      }
      float* row = o + (int64_t)n * KOUT;
      *reinterpret_cast<float4*>(row) = make_float4(q[0], q[1], q[2], q[3]);
      *reinterpret_cast<float4*>(row + KOUT / 2) =
          make_float4(q[4], q[5], q[6], q[7]);
    }
  };

  const int tiles = (N + NB - 1) / NB;
  const int64_t i0 = (int64_t)blockIdx.x * items / gridDim.x;
  const int64_t i1 = ((int64_t)blockIdx.x + 1) * items / gridDim.x;
  F32Run fc, cc;
  bool fv = f32_begin(fc, i0, i1, D, tiles, NB);
  bool cv = fv;
  cc = fc;
  // prologue: the first kF32Look planes, one commit group each
#pragma unroll
  for (int k = 0; k < kF32Look; ++k) {
    if (fv) {
      fetch(fc, k);
      fv = f32_next(fc, i1, D, tiles, NB);
    }
    cp_async_commit();
  }
  float acc[3][TM][8];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int f = 0; f < 8; ++f) acc[t][i][f] = 0.f;
  const float* wt = ws + 4 * fg;
  const int wtap = kin * WS, rsP = P * rs;
  for (int s = 0; cv; ++s) {
    cp_async_wait<kF32Look - 1>();     // plane s has landed
    if constexpr (DX) mask(s);
    // every copy of plane s is visible, and every thread is done with
    // plane s - 1, whose slot the next copy takes (the first pass also
    // publishes the weights)
    __syncthreads();
    if (fv) {
      fetch(fc, s + kF32Look);
      fv = f32_next(fc, i1, D, tiles, NB);
    }
    cp_async_commit();

    // tap t of input plane e feeds output plane e + 1 - t of the run
    const int e = cc.e;
    int m = 0;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      if (e + 1 - t >= cc.d0 && e + 1 - t < cc.d1) m |= 1 << t;
    const float* xs = ring + (s % kRing) * slot + pg * rs;
    // a run's first and last planes feed fewer taps: one pass per tap
    // (each accumulator still takes one tap, channels in order)
    if (m == 7) {
      f32_taps<7, TM, KOUT>(xs, rsP, wt, wtap, kin, acc);
    } else {
      if (m & 1) f32_taps<1, TM, KOUT>(xs, rsP, wt, wtap, kin, acc);
      if (m & 2) f32_taps<2, TM, KOUT>(xs, rsP, wt, wtap, kin, acc);
      if (m & 4) f32_taps<4, TM, KOUT>(xs, rsP, wt, wtap, kin, acc);
    }
    // output e - 1 is complete; so is e at the volume's last plane
    if (e - 1 >= cc.d0 && e - 1 < cc.d1) emit(acc[2], cc, e - 1);
    if (e == D - 1 && e >= cc.d0 && e < cc.d1) emit(acc[1], cc, e);
    if (cc.e < cc.hi) {                // the run goes on: shift outputs
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          acc[2][i][f] = acc[1][i][f];
          acc[1][i][f] = acc[0][i][f];
          acc[0][i][f] = 0.f;
        }
    } else {
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int f = 0; f < 8; ++f) acc[t][i][f] = 0.f;
    }
    cv = f32_next(cc, i1, D, tiles, NB);
  }
}

// ------------------------------------ fp32 weight gradient: CUDA cores

// The split-K GEMM of the bf16 weight gradient, G = sum_{b,d} A_d^T dm[d]
// with A_d = [x[d-1] | x[d] | x[d+1]] and a ones row for d off, on
// CUDA-core f32 FMAs (TF32's one pass does not hold fp32's tolerance).
// The launch's items (b, pixel tile, plane d) are cut into `slices`
// equal contiguous runs, one block each, by the launch shape alone; a
// block walks its runs' x planes in order (F32Run: the one-plane halo at
// each end of a run, clipped to [0, D)), each through a ring filled by
// 16-byte cp.async, the next plane in flight while this one is computed.
// dy (and y under ReLU) of the run's own planes come with their x plane;
// the thread that copied a chunk forms dm = dy * 1[y > 0] in place (exact
// in f32) and adds it to its running sum of dm (d off, for its chunk
// column). Rows are padded by 4 floats so that the reads of a warp whose
// lanes hold other pixel rows land in distinct banks.
// A thread holds 4 channels x 8 outputs x 3 taps of G in registers (96
// accumulators) for the whole slice: per pixel it reads its 4 channels of
// x[d-1], x[d], x[d+1] (three float4) and 8 floats of dm[d], which the
// lanes sharing its outputs read at one address, for 96 FMAs: 20 shared
// floats per 96 FMAs, under the 0.25 a float per FMA an SM can feed.
// L = (C / 4) (F / 8) threads cover G once; the block's P = 128 / L
// groups of L threads split the tile's pixels (at C = F = 32 one warp
// covers G and the 4 warps split the pixels; at 64 the warps split the
// outputs). Input plane e completes output plane e - 1 (and e itself at
// the volume's last plane); a tap outside [0, D) reads a zero plane.
// At the end the groups' partials are added in group order, the dm sums
// in row order, and the block writes its (F, 3C + 1) partial to ws[s];
// dtc_wgrad_reduce_kernel then sums the slices in a fixed order. No
// atomics: the same inputs give the same bits on every run and card.
// The choices below are the fastest of cli/depthconv_split.py --wgrad
// at the paper shapes on an H100 (PERF.md).
constexpr int kWgF32Threads = 128;
constexpr int kWgF32Look = 1;          // planes in flight past the current
constexpr int kWgF32MinBlocks = 2;     // resident blocks an SM (registers)
constexpr int kWgF32TileFloats = 4096; // bound on NB (C + F), NB a power of 2
constexpr int kWgF32Items = 8;         // plane-tiles a slice, at least
constexpr int kWgF32Wave = 132;        // slices a wave; at most two waves
// ring slots: x planes e - 2 .. e and those in flight; dm planes e - 1, e
// and those in flight; y planes copied but not yet masked
constexpr int kWgXRing = kWgF32Look + 3;
constexpr int kWgMRing = kWgF32Look + 2;
constexpr int kWgYRing = kWgF32Look;

// acc[t] += x_t^T dm over this thread's `tmp` pixels of the tile: x_t
// its 4 channels of tap t's staged x plane, dm its 8 outputs of the
// staged dm plane; pixel rows xstep and mstep floats apart. Each
// accumulator adds its pixels in order.
__device__ __forceinline__ void wg_f32_taps(const float* __restrict__ x0,
                                            const float* __restrict__ x1,
                                            const float* __restrict__ x2,
                                            const float* __restrict__ m,
                                            int xstep, int mstep, int tmp,
                                            float (&acc)[3][4][8]) {
#pragma unroll 2
  for (int i = 0; i < tmp; ++i) {
    const float4 a[3] = {*reinterpret_cast<const float4*>(x0),
                         *reinterpret_cast<const float4*>(x1),
                         *reinterpret_cast<const float4*>(x2)};
    const float4 m0 = *reinterpret_cast<const float4*>(m);
    const float4 m1 = *reinterpret_cast<const float4*>(m + 4);
    const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float xv[4] = {a[t].x, a[t].y, a[t].z, a[t].w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int f = 0; f < 8; ++f)
          acc[t][c][f] = fmaf(xv[c], mv[f], acc[t][c][f]);
    }
    x0 += xstep;
    x1 += xstep;
    x2 += xstep;
    m += mstep;
  }
}

// Slice s of the fp32 weight gradient: its (F, 3C + 1) partial of G goes
// to ws[s]. x (B, D, N, C); y, dy (B, D, N, F), all 16-byte aligned; C,
// F in {8, 16, 32, 64}; nb the pixel tile (wgrad_f32_tile); `items` = B
// * tiles * D.
__global__ void __launch_bounds__(kWgF32Threads, kWgF32MinBlocks)
dtc_wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ dy, float* __restrict__ ws,
                     int D, int N, int C, int F, int nb, int relu,
                     int64_t items, int slices) {
  constexpr int T = kWgF32Threads;
  extern __shared__ float4 smem_wg[];
  const int rsx = C + 4, rsm = F + 4;             // padded pixel rows
  const int xslot = nb * rsx, mslot = nb * rsm;
  float* xring = reinterpret_cast<float*>(smem_wg);  // [kWgXRing][nb][rsx]
  float* zero = xring + kWgXRing * xslot;            // [nb][rsx], all 0
  float* mring = zero + xslot;                       // [kWgMRing][nb][rsm]
  float* yring = mring + kWgMRing * mslot;           // [kWgYRing][nb][rsm]

  const int tid = threadIdx.x;
  // this thread's part of G: channel group cg (4 cg .. + 3), output
  // group fg (8 fg .. + 7), pixel group pg (tile pixels pg + P i)
  const int L = (C / 4) * (F / 8), P = T / L, tmp = nb / P;
  const int pg = tid / L, cg = tid % L % (C / 4), fg = tid % L / (C / 4);
  // its copies: x chunk column jx of rows rx0, rx0 + rxs, ...; dy (and
  // y) chunk column jm of rows rm0, rm0 + rms, ...
  const int jx = tid % (C / 4), rx0 = tid / (C / 4), rxs = T / (C / 4);
  const int jm = tid % (F / 4), rm0 = tid / (F / 4), rms = T / (F / 4);

  for (int i = tid; i < xslot / 4; i += T)
    reinterpret_cast<float4*>(zero)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // copy x plane r.e of r's tile into slot s and, for a plane of the
  // run, its dy (and y); rows past N are zero-filled
  auto fetch = [&](const F32Run& r, int s) {
    const int64_t px = (r.b * D + r.e) * (int64_t)N;
    float* xd = xring + (s % kWgXRing) * xslot + rx0 * rsx + 4 * jx;
    for (int row = rx0; row < nb; row += rxs, xd += rxs * rsx) {
      const int n = r.n0 + row;
      const bool ok = n < N;
      cp_async16(xd, x + (ok ? (px + n) * C + 4 * jx : 0), ok ? 16 : 0);
    }
    if (r.e < r.d0 || r.e >= r.d1) return;
    float* md = mring + (s % kWgMRing) * mslot + rm0 * rsm + 4 * jm;
    float* yd = yring + (s % kWgYRing) * mslot + rm0 * rsm + 4 * jm;
    for (int row = rm0; row < nb; row += rms, md += rms * rsm,
             yd += rms * rsm) {
      const int n = r.n0 + row;
      const bool ok = n < N;
      const int64_t g = ok ? (px + n) * F + 4 * jm : 0;
      cp_async16(md, dy + g, ok ? 16 : 0);
      if (relu) cp_async16(yd, y + g, ok ? 16 : 0);
    }
  };
  // dm = dy * 1[y > 0] (or dy) in place, over the chunks this thread
  // copied, added to its running sum of dm
  float4 osum = make_float4(0.f, 0.f, 0.f, 0.f);
  auto mask = [&](int s) {
    float* md = mring + (s % kWgMRing) * mslot + rm0 * rsm + 4 * jm;
    const float* yd = yring + (s % kWgYRing) * mslot + rm0 * rsm + 4 * jm;
    for (int row = rm0; row < nb; row += rms, md += rms * rsm,
             yd += rms * rsm) {
      float4 g = *reinterpret_cast<const float4*>(md);
      if (relu) {
        const float4 q = *reinterpret_cast<const float4*>(yd);
        g.x = q.x > 0.f ? g.x : 0.f;
        g.y = q.y > 0.f ? g.y : 0.f;
        g.z = q.z > 0.f ? g.z : 0.f;
        g.w = q.w > 0.f ? g.w : 0.f;
        *reinterpret_cast<float4*>(md) = g;
      }
      osum.x += g.x;
      osum.y += g.y;
      osum.z += g.z;
      osum.w += g.w;
    }
  };

  float acc[3][4][8];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int f = 0; f < 8; ++f) acc[t][c][f] = 0.f;

  const int tiles = (N + nb - 1) / nb;
  const int64_t i0 = (int64_t)blockIdx.x * items / slices;
  const int64_t i1 = ((int64_t)blockIdx.x + 1) * items / slices;
  F32Run fc, cc;
  bool fv = f32_begin(fc, i0, i1, D, tiles, nb);
  bool cv = fv;
  cc = fc;
  // prologue: the first kWgF32Look planes, one commit group each
#pragma unroll
  for (int k = 0; k < kWgF32Look; ++k) {
    if (fv) {
      fetch(fc, k);
      fv = f32_next(fc, i1, D, tiles, nb);
    }
    cp_async_commit();
  }
  const int xo = pg * rsx + 4 * cg, mo = pg * rsm + 8 * fg;
  const int xstep = P * rsx, mstep = P * rsm;
  auto xs = [&](int s) { return xring + (s % kWgXRing) * xslot + xo; };
  auto ms = [&](int s) { return mring + (s % kWgMRing) * mslot + mo; };
  for (int s = 0; cv; ++s) {
    cp_async_wait<kWgF32Look - 1>();    // plane s has landed
    const int e = cc.e;
    const bool own = e >= cc.d0 && e < cc.d1;
    if (own) mask(s);
    // every copy of plane s and its dm are visible, and every thread is
    // done with step s - 1, whose slots the next copy may take (the first
    // pass also publishes the zero plane)
    __syncthreads();
    if (fv) {
      fetch(fc, s + kWgF32Look);
      fv = f32_next(fc, i1, D, tiles, nb);
    }
    cp_async_commit();

    // output e - 1: taps x[e - 2] (zero below the volume), x[e - 1], x[e]
    if (e - 1 >= cc.d0 && e - 1 < cc.d1)
      wg_f32_taps(e >= 2 ? xs(s - 2) : zero + xo, xs(s - 1), xs(s),
                  ms(s - 1), xstep, mstep, tmp, acc);
    // output e at the volume's last plane: x[e - 1], x[e], zero
    if (own && e == D - 1)
      wg_f32_taps(e >= 1 ? xs(s - 1) : zero + xo, xs(s), zero + xo, ms(s),
                  xstep, mstep, tmp, acc);
    cv = f32_next(cc, i1, D, tiles, nb);
  }
  cp_async_wait<0>();
  __syncthreads();                       // the ring is free

  // the slice's partial: pixel groups added in group order into gs
  // [3C][F], the dm sums of the copying threads in row order
  float* gs = reinterpret_cast<float*>(smem_wg);
  float* os = gs + 3 * C * F;            // [rms][F]
  *reinterpret_cast<float4*>(os + rm0 * F + 4 * jm) = osum;
  for (int q = 0; q < P; ++q) {
    if (pg == q) {
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float4* g = reinterpret_cast<float4*>(
                gs + (t * C + 4 * cg + c) * F + 8 * fg + 4 * h);
            const float* a = acc[t][c] + 4 * h;
            float4 v = q == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *g;
            v.x += a[0];
            v.y += a[1];
            v.z += a[2];
            v.w += a[3];
            *g = v;
          }
    }
    __syncthreads();
  }
  const int K3 = 3 * C + 1;
  float* out = ws + (int64_t)blockIdx.x * F * K3;
  for (int i = tid; i < 3 * C * F; i += T) out[(i % F) * K3 + i / F] = gs[i];
  for (int f = tid; f < F; f += T) {
    float v = 0.f;
    for (int r = 0; r < rms; ++r) v += os[r * F + f];
    out[f * K3 + 3 * C] = v;
  }
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

// the plane-tiles (b, 64-pixel tile, plane) of the bf16 weight gradient
int64_t wgrad_items(int B, int D, int N) {
  return (int64_t)B * ((N + kMmaNB - 1) / kMmaNB) * D;
}

// Slices of the bf16 weight gradient: one per k plane-tiles, at most
// `most` (k = 8 and most = 396, three blocks per SM of an H100, at widths
// up to 32; k = 4 and most = 264, two per SM, at 64: the best of the S
// that cli/depthconv_split.py --wgrad timed at the training and paper
// shapes, within 4%). A function of the launch shape alone, never of the
// card: the sums are the same bits on any card.
int wgrad_slices(int64_t items, int W) {
  const int k = W == 64 ? 4 : 8, most = W == 64 ? 264 : 396;
  const int64_t s = (items + k - 1) / k;
  return (int)(s < most ? s : most);
}

int wgrad_class(int C, int F) {
  const int wc = C > F ? C : F;
  return wc <= 16 ? 16 : wc;
}

// bf16: the split-K GEMM into ws (none when there is nothing to sum),
// then the ordered reduction, which writes every output
template <int W>
int launch_wgrad_mma(const void* x, const void* y, const void* dy,
                     const void* w, const void* inv, float* dw, float* dco,
                     float* ws, int B, int D, int N, int C, int F, int relu,
                     cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int64_t items = wgrad_items(B, D, N);
  const int slices = wgrad_slices(items, W);
  if (slices > 0) {
    constexpr size_t smem = WgradTile<W>::kBytes;
    auto kern = dtc_wgrad_mma_kernel<W>;
    static const int e = set_smem(kern, smem);
    if (e) return e;
    kern<<<slices, kMmaThreads, smem, s>>>((const bf16*)x, (const bf16*)y,
                                           (const bf16*)dy, ws, D, N, C, F,
                                           relu, items, slices);
    if (int e2 = (int)cudaGetLastError()) return e2;
  }
  dtc_wgrad_reduce_kernel<bf16><<<F, kWgReduceThreads, 0, s>>>(
      ws, (const bf16*)w, (const bf16*)inv, dw, dco, C, F, slices);
  return (int)cudaGetLastError();
}

// The fp32 weight gradient's pixel tile at (C, F): the largest power of
// 2 with NB (C + F) <= kWgF32TileFloats, and at least one pixel for each
// pixel group of the block.
int wgrad_f32_tile(int C, int F) {
  const int groups = kWgF32Threads / ((C / 4) * (F / 8));
  int nb = 1;
  while (2 * nb * (C + F) <= kWgF32TileFloats) nb *= 2;
  return nb > groups ? nb : groups;
}

// the plane-tiles (b, pixel tile, plane) of the fp32 weight gradient
int64_t wgrad_f32_items(int B, int D, int N, int C, int F) {
  const int nb = wgrad_f32_tile(C, F);
  return (int64_t)B * ((N + nb - 1) / nb) * D;
}

// Slices of the fp32 weight gradient: one per kWgF32Items plane-tiles,
// cut down to whole waves of kWgF32Wave blocks past one wave (one or two
// blocks an SM of an H100: a part wave leaves SMs with two blocks behind
// those with one; cli/depthconv_split.py --wgrad, PERF.md). A function of
// the launch shape alone, never of the card: the sums are the same bits
// on any card.
int wgrad_f32_slices(int64_t items) {
  const int64_t s = (items + kWgF32Items - 1) / kWgF32Items;
  if (s <= kWgF32Wave) return (int)s;
  return s < 2 * kWgF32Wave ? kWgF32Wave : 2 * kWgF32Wave;
}

// Dynamic shared memory of the fp32 weight gradient at (C, F, tile nb):
// its rings and zero plane, or at the end the partial [3C][F] and the dm
// sums [rows a copy step][F], whichever is larger.
size_t wgrad_f32_smem(int C, int F, int nb) {
  const size_t ring = (size_t)(kWgXRing + 1) * nb * (C + 4) +
                      (size_t)(kWgMRing + kWgYRing) * nb * (F + 4);
  const size_t end = (size_t)3 * C * F + (size_t)kWgF32Threads * 4;
  return sizeof(float) * (ring > end ? ring : end);
}

// fp32: the split-K GEMM on CUDA cores into ws, then the ordered
// reduction, which writes every output
int launch_wgrad_f32(const void* x, const void* y, const void* dy,
                     const void* w, const void* inv, float* dw, float* dco,
                     float* ws, int B, int D, int N, int C, int F, int relu,
                     cudaStream_t s) {
  const int nb = wgrad_f32_tile(C, F);
  const int64_t items = wgrad_f32_items(B, D, N, C, F);
  const int slices = wgrad_f32_slices(items);
  if (slices > 0) {
    static const int e = [] {
      size_t most = 0;
      for (int c = 8; c <= 64; c *= 2)
        for (int f = 8; f <= 64; f *= 2) {
          const size_t b = wgrad_f32_smem(c, f, wgrad_f32_tile(c, f));
          most = b > most ? b : most;
        }
      return set_smem(dtc_wgrad_f32_kernel, most);
    }();
    if (e) return e;
    dtc_wgrad_f32_kernel<<<slices, kWgF32Threads,
                           wgrad_f32_smem(C, F, nb), s>>>(
        (const float*)x, (const float*)y, (const float*)dy, ws, D, N, C, F,
        nb, relu, items, slices);
    if (int e2 = (int)cudaGetLastError()) return e2;
  }
  dtc_wgrad_reduce_kernel<float><<<F, kWgReduceThreads, 0, s>>>(
      ws, (const float*)w, (const float*)inv, dw, dco, C, F, slices);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the fp32 kernel at input width kin: the input
// ring, (dx) the y slots, the weights and (forward) inv, off.
template <bool DX, int KOUT>
size_t f32_smem(int kin) {
  using T = F32Tile<KOUT>;
  const size_t slot = (size_t)T::NB * (kin + 4);
  return sizeof(float) * ((kF32Look + 1) * slot +
                          (DX ? kF32Look * slot : 0) +
                          3 * (size_t)kin * T::WS + (DX ? 0 : 2 * KOUT));
}

// Blocks of an fp32 launch: one wave of `resident` blocks an SM, each
// taking an equal contiguous run of the items; at most one an item. Every
// output's sum runs over its taps and channels in one fixed order, so
// the split changes no bit of the result.
int64_t f32_blocks(int64_t items, int resident) {
  const int64_t wave = (int64_t)resident * sm_count();
  return items < wave ? items : wave;
}

// The launch of the fp32 kernel at (B, D, N, kin): its shared memory,
// items and blocks.
template <bool DX, int KOUT>
int f32_grid(int B, int D, int N, int kin, size_t* smem, int64_t* items,
             int64_t* blocks) {
  auto kern = dtc_f32_kernel<DX, KOUT>;
  static const int e = set_smem(kern, f32_smem<DX, KOUT>(64));
  if (e) return e;
  *smem = f32_smem<DX, KOUT>(kin);
  static int resident_of[4] = {0, 0, 0, 0};          // by kin 8 .. 64
  int& resident = resident_of[kin == 8 ? 0 : kin == 16 ? 1 : kin == 32 ? 2 : 3];
  if (!resident) {
    int n = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kF32Threads,
                                                  *smem);
    resident = n < 1 ? 1 : n;
  }
  *items = (int64_t)B * ((N + F32Tile<KOUT>::NB - 1) / F32Tile<KOUT>::NB) * D;
  *blocks = f32_blocks(*items, resident);
  return 0;
}

// fp32 on CUDA cores: forward (DX false; a = x, kin = C, KOUT = F) or dx
// (DX true; a = dy, yv = y, kin = F, KOUT = C)
template <bool DX, int KOUT>
int launch_f32(const void* a, const void* yv, const void* w, const void* inv,
               const void* off, void* out, int B, int D, int N, int kin,
               int relu, cudaStream_t s) {
  if (!aligned16(a) || !aligned16(out) || (DX && !aligned16(yv)))
    return EDS_ERR_UNSUPPORTED;
  size_t smem;
  int64_t items, blocks;
  if (int e = f32_grid<DX, KOUT>(B, D, N, kin, &smem, &items, &blocks))
    return e;
  dtc_f32_kernel<DX, KOUT><<<(unsigned)blocks, kF32Threads, smem, s>>>(
      (const float*)a, (const float*)yv, (const float*)w, (const float*)inv,
      (const float*)off, (float*)out, D, N, kin, relu, items);
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

}  // namespace

// x (B, D, N, C), w (3, C, F), inv/off (F,) -> y (B, D, N, F); all in the
// same dtype. C, F in {8, 16, 32, 64}; x and y 16-byte aligned (and w in
// bf16).
extern "C" int dtc_forward(int dtype, const void* x, const void* w,
                           const void* inv, const void* off, void* y, int B,
                           int D, int N, int C, int F, int relu,
                           void* stream) {
  if (!width_ok(C) || !width_ok(F)) return EDS_ERR_UNSUPPORTED;
  if ((int64_t)B * D * N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EDS_DTYPE_BF16) {
    return launch_mma<false>(x, nullptr, w, inv, off, y, B, D, N, C, F,
                             relu, s);
  }
  if (dtype != EDS_DTYPE_F32) return EDS_ERR_UNSUPPORTED;
  return with_width(F, [&](auto f) {
    return launch_f32<false, decltype(f)::value>(x, nullptr, w, inv, off, y,
                                                 B, D, N, C, relu, s);
  });
}

// dx (B, D, N, C) from y, dy (B, D, N, F). C, F in {8, 16, 32, 64}; y,
// dy and dx 16-byte aligned (and w in bf16).
extern "C" int dtc_backward_dx(int dtype, const void* y, const void* dy,
                               const void* w, const void* inv, void* dx,
                               int B, int D, int N, int C, int F, int relu,
                               void* stream) {
  if (!width_ok(C) || !width_ok(F)) return EDS_ERR_UNSUPPORTED;
  if ((int64_t)B * D * N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == EDS_DTYPE_BF16) {
    return launch_mma<true>(dy, y, w, inv, nullptr, dx, B, D, N, C, F,
                            relu, s);
  }
  if (dtype != EDS_DTYPE_F32) return EDS_ERR_UNSUPPORTED;
  return with_width(C, [&](auto c) {
    return launch_f32<true, decltype(c)::value>(dy, y, w, inv, nullptr, dx,
                                                B, D, N, F, relu, s);
  });
}

// The fp32 launch of the forward (dx = 0) or dx at (B, D, N, C, F), for
// the checks at the kernels' edges: its pixel tile (what = 0) or its
// blocks (what = 1); -1 for widths the kernels do not take.
extern "C" int dtc_f32_geometry(int what, int dx, int B, int D, int N, int C,
                                int F) {
  if (!width_ok(C) || !width_ok(F)) return -1;
  return with_width(dx ? C : F, [&](auto k) {
    constexpr int KOUT = decltype(k)::value;
    if (what == 0) return F32Tile<KOUT>::NB;
    size_t smem;
    int64_t items, blocks;
    const int e =
        dx ? f32_grid<true, KOUT>(B, D, N, F, &smem, &items, &blocks)
           : f32_grid<false, KOUT>(B, D, N, C, &smem, &items, &blocks);
    return e ? -1 : (int)blocks;
  });
}

// Bytes of the f32 workspace that dtc_backward_w takes in `dtype` (the
// slices' partials of G); -1 for widths the kernels do not take.
extern "C" int dtc_wgrad_workspace_bytes(int dtype, int B, int D, int N,
                                         int C, int F) {
  if (!width_ok(C) || !width_ok(F)) return -1;
  const int slices =
      dtype == EDS_DTYPE_F32
          ? wgrad_f32_slices(wgrad_f32_items(B, D, N, C, F))
          : wgrad_slices(wgrad_items(B, D, N), wgrad_class(C, F));
  return (int)(sizeof(float) * slices * F * (3 * C + 1));
}

// The pixel tile of the weight gradient's items (b, tile, plane) in
// `dtype` at (C, F); -1 for widths the kernels do not take.
extern "C" int dtc_wgrad_tile(int dtype, int C, int F) {
  if (!width_ok(C) || !width_ok(F)) return -1;
  return dtype == EDS_DTYPE_F32 ? wgrad_f32_tile(C, F) : kMmaNB;
}

// dw (3, C, F) and dco (2, F) = (d inv, d off) in f32, summed over the
// whole (B, D, N) grid; every output is written. C, F in {8, 16, 32,
// 64}; x, y, dy 16-byte aligned; ws of dtc_wgrad_workspace_bytes in the
// same dtype. bf16 on tensor cores, fp32 on CUDA cores, each a split-K
// GEMM and an ordered reduction: the sums are the same bits on every run.
extern "C" int dtc_backward_w(int dtype, const void* x, const void* y,
                              const void* dy, const void* w, const void* inv,
                              float* dw, float* dco, float* ws, int B, int D,
                              int N, int C, int F, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!width_ok(C) || !width_ok(F)) return EDS_ERR_UNSUPPORTED;
  if (!aligned16(x) || !aligned16(y) || !aligned16(dy))
    return EDS_ERR_UNSUPPORTED;
  if (dtype == EDS_DTYPE_BF16) {
    switch (wgrad_class(C, F)) {
      case 16:
        return launch_wgrad_mma<16>(x, y, dy, w, inv, dw, dco, ws, B, D, N,
                                    C, F, relu, s);
      case 32:
        return launch_wgrad_mma<32>(x, y, dy, w, inv, dw, dco, ws, B, D, N,
                                    C, F, relu, s);
      default:
        return launch_wgrad_mma<64>(x, y, dy, w, inv, dw, dco, ws, B, D, N,
                                    C, F, relu, s);
    }
  }
  if (dtype != EDS_DTYPE_F32) return EDS_ERR_UNSUPPORTED;
  return launch_wgrad_f32(x, y, dy, w, inv, dw, dco, ws, B, D, N, C, F, relu,
                          s);
}
