// bf16 GEMM on the tensor cores with a fused bias + ReLU epilogue, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/conv2d.py,
// _matmul_kernel (wrapper matmul_bias) for bf16 operands: Y = A(M,K) @
// B(K,N) + bias(N), optional ReLU, an fp32 accumulator carried across the
// whole reduction and the result rounded to bf16 once, as the reference
// kernel computes on upcast operands and writes x's dtype.  Its callers are
// the im2col conv route under the bf16 numerics preset and the MoE expert
// FFN under KernelPolicy(matmul="kernel") (one call per expert weight).
// The backward is two more calls of the same entry, dx = dy @ w^T and
// dw = x^T @ dy, with the transposes read in place.
//
// What bounds it on the H100: operations for the large products (Mixtral's
// expert FFN at capacity 640: 2*640*4096*14336 FLOPs over 2*(640*4096 +
// 4096*14336 + 640*14336) bytes is ~570 FLOP/byte, above the bf16 ridge of
// ~295), bytes for the decode products (M = 16: the 117 MB weight read
// dominates).  The least time is max(2MNK / 989 TFLOP/s, bytes / 3.35
// TB/s).  Only wgmma reaches the first; the second wants every SM's share
// of the weight in flight.
//
// Three bodies; the caller picks one before the launch
// (conv2d/ops.py::gemm_plan_bf16) and names it to the entry point, which
// runs it or refuses it and never picks another:
//
// The wgmma body, for operands TMA can map (each a 16-byte aligned base
// and rows a multiple of 8 values apart) and N % 8 == 0:
//  * A persistent grid of one block of 384 threads per SM walks the output
//    tiles of 128 x BN (BN 128, 192 or 256, and 160 where B is K-major:
//    Mixtral's N = 4096 in 26 tiles of 160 fills 130 of the 132 SMs
//    with 5 rows of tiles) and the splits of their reductions in a fixed
//    order, the tiles along the shorter side fastest, so the blocks in
//    flight share the larger operand's tiles in L2 (a short-M product's B,
//    a tall one's A).
//  * One producer warp feeds a ring of STAGES stages by TMA, each guarded
//    by a full and an empty mbarrier: a stage is a reduction step of 64
//    (128-byte rows, 128-byte swizzle), A 128 x 64 and B 64 x BN, four
//    k16 steps of wgmma between two barrier waits and no __syncthreads in
//    the reduction.  The producer runs on into the next tile while the
//    consumers finish one, so a tile's first loads hide behind the last
//    one's products and epilogue.  TMA's zero fill covers ragged M, N and
//    K.  Each operand is read in its storage order: x (M,K) and w^T (N,K)
//    K-major, x^T (K,M) and w (K,N) MN-major (wgmma's transpose
//    immediates), so dx and dw need no transposed copy.
//  * Two consumer warpgroups of 64 rows each run wgmma.mma_async m64nBNk16
//    with fp32 accumulators in registers (BN / 2 a thread); at BN >= 192
//    setmaxnreg moves registers from the producer warpgroup (down to 40)
//    to them (up to 232).
//  * Epilogue: bias, ReLU and the one rounding to bf16 in registers; each
//    consumer warp writes its 16 rows, 64 columns at a time, into one of
//    two 128-byte swizzled panels of its own (in turn, across tiles too)
//    and hands each to a TMA store, which drains while the warp goes on and the next tile's
//    products run (every warp finishes a tile at once, so stores made by
//    the threads themselves come in bursts; two 2 KB panels a warp keep
//    the ring's stages: a whole staged tile would cost it one); at BN =
//    160 the warp stages 16 rows x 32 columns at a time and stores them
//    in 16-byte pieces.
//
// The swap_ab body, for M <= 64 (decode's M = 16) with x K-major: it
// computes Y^T = B^T A^T, so the weight's N runs along wgmma's 128-row
// tile (as A, MN-major from w (K,N) or K-major from w^T) and x's M rows
// become wgmma's N = 16, 32 or 64 (as B, K-major from x (M,K)).  The
// product is bytes-bound, so the design is weight bytes in flight: up to
// 8 stages of 16 KB of weight per SM, and the reduction split over enough
// units that every SM streams its share.  The epilogue stages each warp's
// 16 weight rows x BN transposed and writes y (M,N) row-major in 16-byte
// pieces.
//
// Both TMA bodies split the reduction where the tiles are too few to fill
// the card (Mixtral's w_out forward, decode): each unit writes its fp32
// partial from the accumulators, and the mma_sync body's sum kernel adds
// the partials in split order, adds the bias, applies the ReLU and rounds
// once.  No atomics: two calls agree bit for bit.
//
// The mma_sync body, for every other operand (rows whose pitch is not a
// multiple of 8 values, an unaligned base, N % 8 != 0: AlexNet conv1's
// 363-wide patches):
//  * A block of 256 threads (8 warps, 2 along M x 4 along N) owns a
//    128 x 128 output tile; each warp a 64 x 32 piece, as 4 x 4 mma.sync
//    m16n8k16 bf16 products with fp32 accumulators (64 a thread).  The
//    fragments come from shared memory by ldmatrix: A stored (M,K) and B
//    stored (N,K) (k contiguous) by the plain form, A stored (K,M) and B
//    stored (K,N) (m or n contiguous) by its .trans form, so each operand
//    lands in shared memory in its storage order and no transposed copy is
//    made.  Rows in shared memory are padded by 8 bf16 (16 bytes), so the
//    eight 16-byte rows an ldmatrix phase reads fall on distinct banks.
//  * The reduction runs in chunks of 32 through a ring of STAGES stages
//    filled by cp.async, three chunks in flight while the tensor cores run
//    on the fourth.  Operands whose rows are 16-byte aligned (a multiple of
//    8 bf16 and an aligned base) copy 16 bytes at a time, out-of-bounds
//    pieces arriving as zeros (the src-size-0 form).  Others (AlexNet
//    conv1's 363-wide patch rows, 726 bytes) take a narrow path: each
//    thread loads bf16 values one by one and stores them into the stage;
//    the ring's barriers order those stores as they order the copies.
//    Nothing outside the operands is read: an out-of-bounds copy names the
//    operand's base with a size of 0.
//  * Split-K: where the tile grid leaves the card short of whole waves the
//    wrapper's rule (conv2d/ops.py::gemm_split) deals the chunks out over
//    n_split blocks per tile, each writing its fp32 partial to scratch; a
//    second kernel adds the partials in split order, adds the bias, applies
//    the ReLU and rounds to bf16 once.  No atomics: two calls agree bit for
//    bit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "../../flash_attention/csrc/flash_sm90.cuh"

namespace {

// max(v, 0) that keeps a NaN, as the reference's jnp.maximum and
// torch.relu do (see matmul_bias.cu).
__device__ __forceinline__ float relu_keep_nan(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 32;        // reduction chunk
constexpr int SPAD = 8;       // bf16 of padding per shared-memory row
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int STAGES = 4;     // chunks in the ring
constexpr int WM = 64;        // rows per warp
constexpr int WN = 32;        // columns per warp

// bf16 of one operand's chunk in shared memory: k-major [BK][R + SPAD]
// (rows run along m or n) or r-major [R][BK + SPAD] (rows run along k).
template <bool KMAJOR, int R>
__host__ __device__ constexpr int tile_elems() {
  return KMAJOR ? BK * (R + SPAD) : R * (BK + SPAD);
}

template <bool KMAJOR, int R>
__host__ __device__ constexpr int row_stride() {
  return KMAJOR ? R + SPAD : BK + SPAD;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a(16x16, row) * b(16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One chunk (reduction k0 .. k0 + BK - 1, rows r0 .. r0 + R - 1 of the
// output side) of an operand stored k-major (element (k, r) at
// src[k * RT + r]) or r-major (at src[r * K + k]), into shared memory at
// dst in the same order; elements past RT or K arrive as zeros.  vec: the
// storage's rows are 16-byte aligned, so whole 8-element pieces are either
// in bounds or out and copies move 16 bytes.
template <bool KMAJOR, int R>
__device__ __forceinline__ void load_chunk(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int r0, int k0, int RT, int K,
                                           bool vec) {
  constexpr int LD = row_stride<KMAJOR, R>();
  constexpr int INNER = KMAJOR ? R : BK;   // contiguous extent of a row
  const int tid = threadIdx.x;
  if (vec) {
    const uint32_t d0 = smem_u32(dst);
#pragma unroll
    for (int it = 0; it < BK * R / 8 / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int outer = e / (INNER / 8), inner = e % (INNER / 8) * 8;
      const int r = KMAJOR ? inner : outer, k = KMAJOR ? outer : inner;
      const int gr = r0 + r, gk = k0 + k;
      const bool in = gr < RT && gk < K;
      const __nv_bfloat16* g =
          in ? src + (KMAJOR ? (size_t)gk * RT + gr : (size_t)gr * K + gk)
             : src;
      cp_async16(d0 + 2 * (outer * LD + inner), g, in ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < BK * R; e += THREADS) {
      const int outer = e / INNER, inner = e % INNER;
      const int r = KMAJOR ? inner : outer, k = KMAJOR ? outer : inner;
      const int gr = r0 + r, gk = k0 + k;
      const bool in = gr < RT && gk < K;
      dst[outer * LD + inner] =
          in ? src[KMAJOR ? (size_t)gk * RT + gr : (size_t)gr * K + gk]
             : zero;
    }
  }
}

// TA: A is stored (K, M) row-major (its tile k-major in shared memory);
// TB: B is stored (N, K) row-major (its tile n-major, k contiguous).
template <bool TA, bool TB>
__global__ void __launch_bounds__(THREADS)
matmul_bias_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ part, int M, int N, int K,
                        int relu, int vec_a, int vec_b) {
  constexpr bool B_KMAJOR = !TB;
  constexpr int A_ELEMS = tile_elems<TA, BM>();
  constexpr int B_ELEMS = tile_elems<B_KMAJOR, BN>();
  constexpr int A_LD = row_stride<TA, BM>();
  constexpr int B_LD = row_stride<B_KMAJOR, BN>();
  extern __shared__ float4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 4) * WM, wn = (warp % 4) * WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // this split's chunks: [c_lo, c_hi) of the ceil(K / BK) chunks
  const int n_split = gridDim.z, split = blockIdx.z;
  const int chunks = (K + BK - 1) / BK;
  const int per = (chunks + n_split - 1) / n_split;
  const int c_lo = split * per;
  const int c_hi = min(chunks, c_lo + per);
  const int n_c = max(0, c_hi - c_lo);

  auto load = [&](int c, int stage) {
    __nv_bfloat16* sa = smem + stage * (A_ELEMS + B_ELEMS);
    const int k0 = (c_lo + c) * BK;
    load_chunk<TA, BM>(sa, a, m0, k0, M, K, vec_a);
    load_chunk<B_KMAJOR, BN>(sa + A_ELEMS, b, n0, k0, N, K, vec_b);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_c) load(s, s);
    cp_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // the shared-memory row and column each lane names to ldmatrix.x4
  const int lr = lane % 8, lm = lane / 8;
  for (int c = 0; c < n_c; ++c) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // chunk c is in; every thread is done with c - 1
    if (c + STAGES - 1 < n_c) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_commit();
    const __nv_bfloat16* As = smem + (c % STAGES) * (A_ELEMS + B_ELEMS);
    const __nv_bfloat16* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mb = wm + 16 * i;
        if (TA) {   // As[k][m]: matrices (k 0-7, m 0-7), (k 0-7, m 8-15),
                    // (k 8-15, m 0-7), (k 8-15, m 8-15), transposed
          const int k = kk + lr + 8 * (lm / 2), m = mb + 8 * (lm % 2);
          ldmatrix_x4_trans(af[i], smem_u32(As + k * A_LD + m));
        } else {    // As[m][k]: (m 0-7, k 0-7), (m 8-15, k 0-7), ...
          const int m = mb + lr + 8 * (lm % 2), k = kk + 8 * (lm / 2);
          ldmatrix_x4(af[i], smem_u32(As + m * A_LD + k));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int nb = wn + 8 * j;
        uint32_t r[4];
        if (TB) {   // Bs[n][k]: (n 0-7, k 0-7), (n 0-7, k 8-15),
                    // (n 8-15, k 0-7), (n 8-15, k 8-15)
          const int n = nb + lr + 8 * (lm / 2), k = kk + 8 * (lm % 2);
          ldmatrix_x4(r, smem_u32(Bs + n * B_LD + k));
        } else {    // Bs[k][n]: the same four, transposed
          const int k = kk + lr + 8 * (lm % 2), n = nb + 8 * (lm / 2);
          ldmatrix_x4_trans(r, smem_u32(Bs + k * B_LD + n));
        }
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_wait<0>();

  // y = bf16(acc + bias, ReLU), or this split's fp32 partial.  A lane's
  // accumulators: rows g and g + 8 of each m16 piece, columns 2t, 2t + 1
  // of each n8 piece.
  const int g = lane / 4, t = lane % 4;
  float* out = n_split == 1 ? nullptr : part + (size_t)split * M * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + wn + 8 * j + 2 * t + q;
      if (n >= N) continue;
      const float bn = n_split == 1 && bias ? __bfloat162float(bias[n]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * i + g + 8 * h;
          if (m >= M) continue;
          float v = acc[i][j][2 * h + q];
          if (n_split == 1) {
            v += bn;
            if (relu) v = relu_keep_nan(v);
            y[(size_t)m * N + n] = __float2bfloat16(v);
          } else {
            out[(size_t)m * N + n] = v;
          }
        }
    }
  }
}

// y = bf16(the sum of the n_split fp32 partials, added in split order,
// + bias, ReLU), V values a thread: 4 (16-byte loads of the partials)
// where the rows allow it, else 1.  Every body's split ends here.
template <int V>
__global__ void __launch_bounds__(256)
matmul_bias_bf16_sum(const float* __restrict__ part,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int M, int N, int n_split,
                     int relu) {
  const size_t n = (size_t)M * N, groups = n / V;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < groups;
       i += (size_t)gridDim.x * blockDim.x) {
    float v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* p = part + s * n + V * i;
      if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] += q.x;
        v[1] += q.y;
        v[2] += q.z;
        v[3] += q.w;
      } else {
        v[0] += p[0];
      }
    }
    const int c = (int)(V * i % N);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (bias) v[e] += __bfloat162float(bias[c + e]);
      if (relu) v[e] = relu_keep_nan(v[e]);
    }
    if constexpr (V == 4) {
      uint2 out;
      out.x = sm90::pack_bf16(v[0], v[1]);
      out.y = sm90::pack_bf16(v[2], v[3]);
      *reinterpret_cast<uint2*>(y + V * i) = out;
    } else {
      y[i] = __float2bfloat16(v[0]);
    }
  }
}

int sum_partials(const float* part, const __nv_bfloat16* bias,
                 __nv_bfloat16* y, int M, int N, int n_split, int relu,
                 cudaStream_t stream) {
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(part) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 8 == 0)
    matmul_bias_bf16_sum<4><<<1024, 256, 0, stream>>>(part, bias, y, M, N,
                                                      n_split, relu);
  else
    matmul_bias_bf16_sum<1><<<1024, 256, 0, stream>>>(part, bias, y, M, N,
                                                      n_split, relu);
  return (int)cudaGetLastError();
}

template <bool TA, bool TB>
int launch(const __nv_bfloat16* a, const __nv_bfloat16* b,
           const __nv_bfloat16* bias, __nv_bfloat16* y, float* part, int M,
           int N, int K, int relu, int vec_a, int vec_b, int n_split,
           cudaStream_t stream) {
  constexpr int BYTES =
      2 * STAGES * (tile_elems<TA, BM>() + tile_elems<!TB, BN>());
  const auto kernel = matmul_bias_bf16_kernel<TA, TB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, n_split);
  kernel<<<grid, THREADS, BYTES, stream>>>(a, b, bias, y, part, M, N, K,
                                           relu, vec_a, vec_b);
  return (int)cudaGetLastError();
}

// Whether an operand's rows are 16-byte aligned: its base and its row
// length (`ld` bf16).
bool aligned(const void* p, int ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0;
}

// ------------------------------------------------------- the TMA bodies
typedef __nv_bfloat16 bf16;

constexpr int TMA_BM = 128;          // tile rows: 64 a consumer warpgroup
constexpr int TMA_BK = 64;           // reduction columns a stage
constexpr int TMA_THREADS = 384;     // consumer warpgroups 0, 1; producer 2
constexpr int TMA_CONSUMERS = 256;
constexpr int PANEL = 64 * 128;      // bytes of a 64-row x 128-byte panel
// The widths each TMA body is built for (conv2d/ops.py's GEMM_BF16_BNS and
// GEMM_BF16_SWAP_BNS): the wgmma body's output tile is 128 x BN, the
// swap_ab body's 128 weight columns x BN rows of x.
#define WGMMA_WIDTHS(X) X(128) X(160) X(192) X(256)
#define SWAP_WIDTHS(X) X(16) X(32) X(64)

// The tile grid: P (wgmma's A, TMA_BM rows a tile) and Q (wgmma's B, BN
// columns a tile).  The wgmma body: P = x, Q = w, rows M, cols N; the
// swap_ab body: P = w^T, Q = x^T, rows N, cols M.
struct Problem {
  int M, N;            // y is (M, N)
  int n_rt, n_ct;      // row and column tiles
  int chunks, n_split; // ceil(K / TMA_BK) chunks, dealt out over n_split
  int relu;
  int cols_fast;       // the units' order: column tile fastest, not row
};

template <int BN, bool SWAP>
struct TmaLayout {
  static constexpr int P_BYTES = TMA_BM * TMA_BK * 2;
  static constexpr int Q_BYTES = BN * TMA_BK * 2;
  static constexpr int STAGE = P_BYTES + Q_BYTES;
  // the wgmma body's epilogue at widths that are multiples of 64 hands
  // each warp's 16 rows to TMA stores
  static constexpr bool STORE = !SWAP && BN % 64 == 0;
  // each consumer warp's staging buffer: two panels of its 16 rows x 64
  // columns, 128-byte swizzled (the TMA stores' boxes), filled in turn;
  // else 16 rows x (32 + 8) bf16, or, swapped, BN rows of y x (16 + 8)
  static constexpr int OUT_PITCH = SWAP ? 24 : 40;
  static constexpr int OUT_WARP =
      STORE ? 2 * 2048 : (SWAP ? BN : 16) * OUT_PITCH * 2;
  static constexpr int OUT_BYTES = TMA_CONSUMERS / 32 * OUT_WARP;
  static constexpr int FIT = (227 * 1024 - 1024 - 256 - OUT_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  // the ring, the staging buffers, full[STAGES] and empty[STAGES]
  // mbarriers; + 1 KB to align the base to 1024
  static constexpr int OUT_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = OUT_OFF + OUT_BYTES;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
  static_assert(STAGES >= 2 && BYTES <= 227 * 1024, "the ring fits");
  static_assert(STAGE % 1024 == 0, "every stage starts a swizzle phase");
};

// One unit of the persistent grid: row tile, column tile and split, the
// tiles along the shorter side fastest (so the blocks in flight share the
// larger operand's tiles in L2: the weight of Mixtral's M = 640 products,
// the patches of AlexNet's tall ones), then the split; the split's run
// [c_lo, c_lo + n_c) of the chunks (conv2d/ops.py::gemm_ranges).
struct TmaUnit {
  int r0, c0, split, c_lo, n_c;
  __device__ __forceinline__ TmaUnit(int u, const Problem& s, int bn) {
    const int tiles = s.n_rt * s.n_ct, t = u % tiles;
    split = u / tiles;
    const int rt = s.cols_fast ? t / s.n_ct : t % s.n_rt;
    const int ct = s.cols_fast ? t % s.n_ct : t / s.n_rt;
    r0 = rt * TMA_BM;
    c0 = ct * bn;
    const int per = (s.chunks + s.n_split - 1) / s.n_split;
    c_lo = split * per;
    n_c = max(0, min(s.chunks, c_lo + per) - c_lo);
  }
};

// PK: P is K-major (rows of P along the reduction's storage rows: x (M,K),
// w^T (N,K)), else MN-major (x^T (K,M), w (K,N)); QK the same for Q.
template <int BN, bool PK, bool QK, bool SWAP>
__global__ void __launch_bounds__(TMA_THREADS, 1)
matmul_bias_bf16_tma(const __grid_constant__ CUtensorMap tp,
                     const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap ty,
                     const bf16* __restrict__ bias, bf16* __restrict__ y,
                     float* __restrict__ part, const Problem s) {
  using L = TmaLayout<BN, SWAP>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw_base);
  const uint32_t full0 = base + L::BAR_OFF, empty0 = full0 + 8 * STAGES;
  const int tid = threadIdx.x;
  const int n_units = s.n_rt * s.n_ct * s.n_split;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      // full: the producer's expect_tx; empty: the consumers' 8 warps
      sm90::bar_init(full0 + 8 * st, 1);
      sm90::bar_init(empty0 + 8 * st, TMA_CONSUMERS / 32);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  // the widest tiles' accumulators (BN / 2 a thread) want more than the
  // 168 registers 384 threads get: the producer warpgroup hands its spare
  // ones to the consumers
  constexpr bool REGS = !SWAP && BN >= 192;
  if (tid >= TMA_CONSUMERS) {
    if constexpr (REGS) sm90::regs_dec<40>();
    // ---- the producer warpgroup: one thread issues every load, running
    // ahead across units
    if (tid == TMA_CONSUMERS) {
      int q = 0;   // chunks this block has produced
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const TmaUnit w(u, s, BN);
        for (int c = 0; c < w.n_c; ++c, ++q) {
          const int st = q % STAGES;
          sm90::bar_wait(empty0 + 8 * st, ((q / STAGES) & 1) ^ 1);
          const uint32_t sp = base + st * L::STAGE, sq = sp + L::P_BYTES;
          const uint32_t full = full0 + 8 * st;
          const int k0 = (w.c_lo + c) * TMA_BK;
          sm90::bar_arrive_tx(full, L::STAGE);
          if (PK) {   // one box of 128 rows x 64 reduction columns
            sm90::tma_load_2d(sp, &tp, full, k0, w.r0);
          } else {    // two panels of 64 reduction rows x 64 P rows
            sm90::tma_load_2d(sp, &tp, full, w.r0, k0);
            sm90::tma_load_2d(sp + PANEL, &tp, full, w.r0 + 64, k0);
          }
          if (QK) {
            sm90::tma_load_2d(sq, &tq, full, k0, w.c0);
          } else {
#pragma unroll
            for (int p = 0; p < BN / 64; ++p)
              sm90::tma_load_2d(sq + p * PANEL, &tq, full, w.c0 + 64 * p,
                                k0);
          }
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups: tile rows 64 wg .. 64 wg + 63
  if constexpr (REGS) sm90::regs_inc<232>();
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int cq = 2 * (lane % 4);   // accumulator columns 8 j + cq, + 1
  bf16* const wtile = reinterpret_cast<bf16*>(smem + L::OUT_OFF +
                                              tid / 32 * L::OUT_WARP);
  int q = 0;        // chunks this block has consumed
  int panels = 0;   // panels this warp has handed to TMA stores
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const TmaUnit w(u, s, BN);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    sm90::pin(acc);
    for (int c = 0; c < w.n_c; ++c, ++q) {
      const int st = q % STAGES;
      sm90::bar_wait(full0 + 8 * st, (q / STAGES) & 1);
      const uint32_t sp = base + st * L::STAGE, sq = sp + L::P_BYTES;
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < TMA_BK / 16; ++kk) {
        const uint64_t da =
            PK ? sm90::kmajor(sp + wg * 64 * 128 + 32 * kk)
               : sm90::mnmajor(sp + wg * PANEL + 2048 * kk, PANEL);
        const uint64_t db = QK ? sm90::kmajor(sq + 32 * kk)
                               : sm90::mnmajor(sq + 2048 * kk, PANEL);
        sm90::WgmmaSS<BN>::template run<PK ? 0 : 1, QK ? 0 : 1>(acc, da, db,
                                                                1);
      }
      sm90::wg_commit();
      // chunk c - 1's products are done: its stage goes back to the
      // producer
      sm90::wg_wait<1>();
      if (c > 0 && lane == 0)
        sm90::bar_arrive(empty0 + 8 * ((q - 1) % STAGES));
    }
    sm90::wg_wait<0>();
    sm90::pin(acc);
    if (w.n_c > 0 && lane == 0)
      sm90::bar_arrive(empty0 + 8 * ((q - 1) % STAGES));

    // this warp's accumulator rows: rb + lane / 4 (+ 8) of the P side
    const int rb = w.r0 + wg * 64 + warp * 16;
    if (!SWAP) {
      // rows m, columns n
      if (s.n_split > 1) {
        float* out = part + (size_t)w.split * s.M * s.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = w.c0 + 8 * j + cq;
          if (n >= s.N) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int m = rb + lane / 4 + 8 * i;
            if (m < s.M)
              *reinterpret_cast<float2*>(out + (size_t)m * s.N + n) =
                  make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
          }
        }
        continue;
      }
      if (L::STORE) {
        // y = acc + bias (ReLU) in fp32, rounded once, a panel of 64
        // columns at a time into one of the warp's two swizzled buffers
        // (conflict-free: each lane of a row group names another 16-byte
        // chunk), then out by TMA, which drains while the warp goes on
#pragma unroll
        for (int p = 0; p < BN / 64; ++p, ++panels) {
          // the buffers alternate across tiles too (at BN = 192 a tile's
          // last panel and the next one's first would share one)
          uint8_t* const wb =
              reinterpret_cast<uint8_t*>(wtile) + panels % 2 * 2048;
          // the store that last read this buffer, two panels back, is done
          if (lane == 0) sm90::bulk_wait_read<1>();
          __syncwarp();
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * p + jj, n = w.c0 + 8 * j + cq;
            const bool in = bias && n < s.N;   // N % 8 == 0: n + 1 too
            const float b0 = in ? __bfloat162float(bias[n]) : 0.f;
            const float b1 = in ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float v0 = acc[4 * j + 2 * i] + b0;
              float v1 = acc[4 * j + 2 * i + 1] + b1;
              if (s.relu) {
                v0 = relu_keep_nan(v0);
                v1 = relu_keep_nan(v1);
              }
              const int r = lane / 4 + 8 * i;
              *reinterpret_cast<__nv_bfloat162*>(
                  wb + r * 128 + ((jj ^ (r % 8)) << 4) + 2 * cq) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
          sm90::fence_proxy_async();
          __syncwarp();
          if (lane == 0) {
            sm90::tma_store_2d(&ty, sm90::smem_u32(wb), w.c0 + 64 * p, rb);
            sm90::bulk_commit();
          }
        }
        continue;
      }
      // y = acc + bias (ReLU) in fp32, rounded once, staged 32 columns at
      // a time and stored 16 bytes (8 columns of one row) a lane
#pragma unroll
      for (int cb = 0; cb < BN / 32; ++cb) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * cb + jj, n = w.c0 + 8 * j + cq;
          const bool in = bias && n < s.N;   // N % 8 == 0: n + 1 too
          const float b0 = in ? __bfloat162float(bias[n]) : 0.f;
          const float b1 = in ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v0 = acc[4 * j + 2 * i] + b0;
            float v1 = acc[4 * j + 2 * i + 1] + b1;
            if (s.relu) {
              v0 = relu_keep_nan(v0);
              v1 = relu_keep_nan(v1);
            }
            *reinterpret_cast<__nv_bfloat162*>(
                wtile + (lane / 4 + 8 * i) * L::OUT_PITCH + 8 * jj + cq) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lane / 4 + 8 * h, m = rb + r;
          const int n = w.c0 + 32 * cb + 8 * (lane % 4);
          if (m < s.M && n < s.N)
            *reinterpret_cast<uint4*>(y + (size_t)m * s.N + n) =
                *reinterpret_cast<const uint4*>(wtile + r * L::OUT_PITCH +
                                                8 * (lane % 4));
        }
        __syncwarp();
      }
    } else {
      // rows n (the weight's columns), columns m (x's rows)
      if (s.n_split > 1) {
        float* out = part + (size_t)w.split * s.M * s.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = w.c0 + 8 * j + cq + e;
            if (m >= s.M) continue;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int n = rb + lane / 4 + 8 * i;
              if (n < s.N) out[(size_t)m * s.N + n] = acc[4 * j + 2 * i + e];
            }
          }
        continue;
      }
      float bn[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = rb + lane / 4 + 8 * i;
        bn[i] = bias && n < s.N ? __bfloat162float(bias[n]) : 0.f;
      }
      // the warp's 16 rows of y^T, transposed into BN rows of y x 16
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = acc[4 * j + 2 * i + e] + bn[i];
            if (s.relu) v = relu_keep_nan(v);
            wtile[(8 * j + cq + e) * L::OUT_PITCH + lane / 4 + 8 * i] =
                __float2bfloat16(v);
          }
      __syncwarp();
      // two 16-byte pieces a row of y
#pragma unroll
      for (int p = lane; p < 2 * BN; p += 32) {
        const int r = p / 2, h = p % 2;
        const int m = w.c0 + r, n = rb + 8 * h;
        if (m < s.M && n < s.N)
          *reinterpret_cast<uint4*>(y + (size_t)m * s.N + n) =
              *reinterpret_cast<const uint4*>(wtile + r * L::OUT_PITCH +
                                              8 * h);
      }
      __syncwarp();
    }
  }
  if (L::STORE && lane == 0) sm90::bulk_wait<0>();
}

template <int BN, bool PK, bool QK, bool SWAP>
int launch_tma(const CUtensorMap& mp, const CUtensorMap& mq,
               const CUtensorMap& my, const bf16* bias, bf16* y,
               float* part, const Problem& s, cudaStream_t stream) {
  using L = TmaLayout<BN, SWAP>;
  const auto kernel = matmul_bias_bf16_tma<BN, PK, QK, SWAP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // a persistent grid: one block per SM, each walking the units
  const int units = s.n_rt * s.n_ct * s.n_split;
  kernel<<<units < sms ? units : sms, TMA_THREADS, L::BYTES, stream>>>(
      mp, mq, my, bias, y, part, s);
  return (int)cudaGetLastError();
}

// The body for the operands' storage orders: PK, QK as above.
template <int BN, bool SWAP>
int launch_layout(bool pk, bool qk, const CUtensorMap& mp,
                  const CUtensorMap& mq, const CUtensorMap& my,
                  const bf16* bias, bf16* y, float* part, const Problem& s,
                  cudaStream_t stream) {
  if (pk)
    return qk ? launch_tma<BN, true, true, SWAP>(mp, mq, my, bias, y, part,
                                                 s, stream)
              : launch_tma<BN, true, false, SWAP>(mp, mq, my, bias, y, part,
                                                  s, stream);
  return qk ? launch_tma<BN, false, true, SWAP>(mp, mq, my, bias, y, part, s,
                                                stream)
            : launch_tma<BN, false, false, SWAP>(mp, mq, my, bias, y, part,
                                                 s, stream);
}

// The swap_ab body reads x^T K-major only (x stored (M,K)).
template <int BN>
int launch_swap(bool pk, const CUtensorMap& mp, const CUtensorMap& mq,
                const CUtensorMap& my, const bf16* bias, bf16* y,
                float* part, const Problem& s, cudaStream_t stream) {
  return pk ? launch_tma<BN, true, true, true>(mp, mq, my, bias, y, part, s,
                                               stream)
            : launch_tma<BN, false, true, true>(mp, mq, my, bias, y, part, s,
                                                stream);
}

// A TMA body's launch: the two tensor maps, the tile grid, the body at
// width bn; then, above one split, the sum.
int run_tma(const void* a, const void* b, const bf16* bias, bf16* y,
            float* part, int M, int N, int K, bool trans_a, bool trans_b,
            int relu, int bn, int n_split, bool swap, cudaStream_t stream) {
  // P: x (wgmma) or w^T (swap_ab); Q: w or x^T.  A K-major operand's map
  // reads boxes of its tile's rows x 64 reduction columns, an MN-major
  // one's boxes of 64 reduction rows x 64 of its tile's columns.
  const bool pk = swap ? trans_b : !trans_a;
  const bool qk = swap ? true : trans_b;
  // an MN-major Q comes in panels of 64 columns
  if (!qk && bn % 64) return (int)cudaErrorInvalidValue;
  const void* p = swap ? b : a;
  const void* qp = swap ? a : b;
  const int p_rows = swap ? N : M, q_cols = swap ? M : N;
  // y's map: boxes of one warp's 16 rows x 64 columns
  CUtensorMap mp, mq, my;
  int e = pk ? sm90::matrix_map(&mp, p, p_rows, K, K, TMA_BM)
             : sm90::matrix_map(&mp, p, K, p_rows, p_rows, 64);
  if (!e)
    e = qk ? sm90::matrix_map(&mq, qp, q_cols, K, K, bn)
           : sm90::matrix_map(&mq, qp, K, q_cols, q_cols, 64);
  if (!e) e = sm90::matrix_map(&my, y, M, N, N, 16);
  if (e) return e;
  Problem s;
  s.M = M;
  s.N = N;
  s.n_rt = (p_rows + TMA_BM - 1) / TMA_BM;
  s.n_ct = (q_cols + bn - 1) / bn;
  s.chunks = (K + TMA_BK - 1) / TMA_BK;
  s.n_split = n_split;
  s.relu = relu;
  s.cols_fast = p_rows > q_cols;
  if (swap) {
    switch (bn) {
#define SWAP_CASE(W)                                                       \
  case W:                                                                  \
    e = launch_swap<W>(pk, mp, mq, my, bias, y, part, s, stream);          \
    break;
      SWAP_WIDTHS(SWAP_CASE)
#undef SWAP_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (bn) {
#define WGMMA_CASE(W)                                                      \
  case W:                                                                  \
    e = launch_layout<W, false>(pk, qk, mp, mq, my, bias, y, part, s,     \
                                stream);                                   \
    break;
      WGMMA_WIDTHS(WGMMA_CASE)
#undef WGMMA_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (e || n_split == 1) return e;
  return sum_partials(part, bias, y, M, N, n_split, relu, stream);
}

}  // namespace

// y (M,N) bf16 = a @ b + bias, optional ReLU, accumulated in fp32 and
// rounded once.  a is (M,K) row-major, or (K,M) row-major when trans_a; b
// is (K,N) row-major, or (N,K) row-major when trans_b; bias (N,) or null;
// all bf16 on the current device; M, N, K >= 1.  `body` is the body the
// caller picked (conv2d/ops.py::gemm_plan_bf16) and bn its tile width:
//  1 the wgmma body, bn one of WGMMA_WIDTHS;
//  2 the mma_sync body, bn = BN (128), N / 128 < 65536;
//  3 the swap_ab body, bn one of SWAP_WIDTHS, a not transposed;
// a width that is not a multiple of 64 (160) needs b transposed on the
// wgmma body (B K-major);
// the TMA bodies (1, 3) are refused unless a and b are TMA-mappable (a
// 16-byte aligned base, rows a multiple of 8 values apart), N % 8 == 0
// and y and part are 16-byte aligned; anything else is refused.  n_split
// >= 1 units share each output tile's reduction chunks (TMA_BK columns on
// the TMA bodies, BK on the mma_sync body); above 1, part is fp32 scratch
// of n_split * M * N and no split may be empty (conv2d/ops.py::
// gemm_ranges).  Launches on `stream` and returns cudaGetLastError() (0
// on success); no sync.
extern "C" int matmul_bias_bf16(const void* a, const void* b,
                                const void* bias, void* y, float* part, int M,
                                int N, int K, int trans_a, int trans_b,
                                int relu, int bn, int n_split, int body,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_split < 1 || (n_split > 1 && !part)) return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  const auto* pbias = static_cast<const __nv_bfloat16*>(bias);
  auto* py = static_cast<__nv_bfloat16*>(y);
  const int vec_a = aligned(a, trans_a ? M : K);
  const int vec_b = aligned(b, trans_b ? K : N);
  if (body == 1 || body == 3) {
    const bool out_ok = N % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(part) % 16 == 0;
    if (!vec_a || !vec_b || !out_ok || (body == 3 && trans_a))
      return (int)cudaErrorInvalidValue;
    return run_tma(a, b, pbias, py, part, M, N, K, trans_a, trans_b, relu,
                   bn, n_split, body == 3, s);
  }
  if (body != 2 || bn != BN) return (int)cudaErrorInvalidValue;
#define MATMUL(TA, TB)                                                       \
  launch<TA, TB>(pa, pb, pbias, py, part, M, N, K, relu, vec_a, vec_b,      \
                 n_split, s)
  int e;
  if (trans_a)
    e = trans_b ? MATMUL(true, true) : MATMUL(true, false);
  else
    e = trans_b ? MATMUL(false, true) : MATMUL(false, false);
#undef MATMUL
  if (e || n_split == 1) return e;
  return sum_partials(part, pbias, py, M, N, n_split, relu, s);
}
