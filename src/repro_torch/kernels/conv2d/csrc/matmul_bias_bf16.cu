// Blocked bf16 GEMM on the tensor cores with a fused bias + ReLU epilogue,
// sm_90a.
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
// TB/s).
//
// What the design does about it (a first, simple kernel; making it fast is
// later work):
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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
// + bias, ReLU).
__global__ void __launch_bounds__(256)
matmul_bias_bf16_sum(const float* __restrict__ part,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int M, int N, int n_split,
                     int relu) {
  const size_t n = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < n_split; ++s) v += part[s * n + i];
    if (bias) v += __bfloat162float(bias[i % N]);
    if (relu) v = relu_keep_nan(v);
    y[i] = __float2bfloat16(v);
  }
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

}  // namespace

// y (M,N) bf16 = a @ b + bias, optional ReLU, accumulated in fp32 and
// rounded once.  a is (M,K) row-major, or (K,M) row-major when trans_a; b
// is (K,N) row-major, or (N,K) row-major when trans_b; bias (N,) or null;
// all bf16 on the current device.  M, N >= 1, N / 128 < 65536.  n_split
// >= 1 blocks share each output tile's reduction; above 1, part is fp32
// scratch of n_split * M * N and no split may be empty
// (conv2d/ops.py::gemm_split).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); no sync.
extern "C" int matmul_bias_bf16(const void* a, const void* b,
                                const void* bias, void* y, float* part, int M,
                                int N, int K, int trans_a, int trans_b,
                                int relu, int n_split, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_split < 1 || (n_split > 1 && !part)) return (int)cudaErrorInvalidValue;
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  const auto* pbias = static_cast<const __nv_bfloat16*>(bias);
  auto* py = static_cast<__nv_bfloat16*>(y);
  const int vec_a = aligned(a, trans_a ? M : K);
  const int vec_b = aligned(b, trans_b ? K : N);
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
  matmul_bias_bf16_sum<<<1024, 256, 0, s>>>(part, pbias, py, M, N, n_split,
                                            relu);
  return (int)cudaGetLastError();
}
