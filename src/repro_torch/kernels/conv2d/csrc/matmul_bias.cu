// Blocked fp32 GEMM with a fused bias + ReLU epilogue, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/conv2d.py,
// _matmul_kernel (wrapper matmul_bias): Y = A(M,K) @ B(K,N) + bias(N),
// optional ReLU, fp32 operands and an fp32 accumulator carried across the
// K tiles.  It is the GEMM stage of the two-stage im2col conv, and its
// backward is two more calls of the same kernel, dx = dy @ w^T and
// dw = x^T @ dy (_matmul_bias_bwd).
//
// What bounds it on the H100: operations for the conv GEMMs (2*M*N*K
// FLOPs against 4*(M*K + K*N + M*N) bytes puts every forward and dx
// product of AlexNet far above the fp32 ridge of 20 FLOP/byte), so the
// least time is FLOPs / 67 TFLOP/s of non-tensor fp32.  It runs on the fp32
// FMA pipes (no TF32, to match the reference at 2e-4).
//
// What the design does about it:
//  * A block of 256 threads owns a 128 x 128 output tile (128 x 64 where N
//    is narrow); each thread keeps an 8 x 8 (8 x 4) register tile and reads
//    its fragments from shared memory as float4s: per 4 steps of k, 16
//    float4 loads feed 256 FMAs.  Rows of a thread are 4-row runs 64 apart
//    (ty*4 + 64h + i), so a warp's A reads are two broadcasts; its columns
//    are 4-column runs 64 apart (tx*4 + 64h + j) where B is k-major in
//    shared memory, and tx + 16j where B is n-major, so that 16
//    consecutive rows of stride 20 floats fall on distinct banks.
//  * The reduction runs in chunks of 16 through a ring of STAGES
//    shared-memory stages filled by cp.async, so three chunks are in flight
//    while the FMAs run on the fourth.  Out-of-bounds elements arrive as
//    zeros (the src-size-0 form), so ragged M, N and K need no padding in
//    device memory.  Operands whose rows are 16-byte aligned copy 16 bytes
//    at a time; others (rows of 363 or 1,200 floats) copy 4.
//  * The backward reads w^T and x^T in place: TA / TB say that A is stored
//    as (K, M) or B as (N, K), row-major.  Each operand lands in shared
//    memory in its storage order (k-major when its rows run along M or N,
//    else m- or n-major with rows padded to 20 floats), so every copy is a
//    straight run of its storage and no transposed copy is made (x^T of
//    conv2's patch matrix is 224 MB at batch 32).
//  * Split-K: the dw products have small outputs and long reductions
//    (conv1: 363 x 96 over K = 96,800 at batch 32 is 3 tiles for 132 SMs).
//    Where the tile grid leaves the card short of whole waves, the
//    wrapper's rule (conv2d/ops.py::gemm_split, a model of the run in
//    waves) deals the chunks out over n_split blocks per tile, each writing
//    its fp32 partial to scratch; a second kernel adds the partials in
//    split order and applies bias and ReLU.  No atomics: two calls agree
//    bit for bit.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// The epilogue's ReLU: max(v, 0) that keeps a NaN, as the reference's
// jnp.maximum and torch.relu do (fmaxf alone would turn it into 0 and hide a
// non-finite input from the loss-scaling skip).
__device__ __forceinline__ float relu_keep_nan(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

constexpr int BM = 128;       // output rows per block
constexpr int BK = 16;        // reduction chunk
constexpr int PAD = BK + 4;   // row stride (floats) of an m- or n-major tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int STAGES = 4;     // chunks in the ring

// Floats of one operand's chunk in shared memory: k-major [BK][R], or
// m-/n-major [R][PAD].
template <bool KMAJOR, int R>
__host__ __device__ constexpr int tile_floats() {
  return KMAJOR ? BK * R : R * PAD;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// One chunk (reduction k0 .. k0 + BK - 1, rows r0 .. r0 + R - 1 of the
// output side) of an operand stored k-major (element (k, r) at
// src[k * RT + r]) or r-major (at src[r * K + k]), into shared memory at
// dst in the same order; elements past RT or K arrive as zeros.  vec: the
// storage's rows are 16-byte aligned, so copies move float4s.
template <bool KMAJOR, int R>
__device__ __forceinline__ void load_chunk(uint32_t dst,
                                           const float* __restrict__ src,
                                           int r0, int k0, int RT, int K,
                                           bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int it = 0; it < BK * R / 4 / THREADS; ++it) {
      const int e = tid + it * THREADS;
      int r, k;
      if (KMAJOR) {
        k = e / (R / 4);
        r = e % (R / 4) * 4;
      } else {
        r = e / (BK / 4);
        k = e % (BK / 4) * 4;
      }
      const int gr = r0 + r, gk = k0 + k;
      const bool in = gr < RT && gk < K;
      const float* g =
          in ? src + (KMAJOR ? (size_t)gk * RT + gr : (size_t)gr * K + gk)
             : src;
      cp_async16(dst + 4 * (KMAJOR ? k * R + r : r * PAD + k), g,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int it = 0; it < BK * R / THREADS; ++it) {
      const int e = tid + it * THREADS;
      int r, k;
      if (KMAJOR) {
        k = e / R;
        r = e % R;
      } else {
        r = e / BK;
        k = e % BK;
      }
      const int gr = r0 + r, gk = k0 + k;
      const bool in = gr < RT && gk < K;
      const float* g =
          in ? src + (KMAJOR ? (size_t)gk * RT + gr : (size_t)gr * K + gk)
             : src;
      cp_async4(dst + 4 * (KMAJOR ? k * R + r : r * PAD + k), g, in ? 4 : 0);
    }
  }
}

// Output row of a thread's i-th row (i < 8): 4-row runs 64 apart.
__device__ __forceinline__ int row_of(int ty, int i) {
  return (i / 4) * 64 + ty * 4 + i % 4;
}

// Output column of a thread's j-th column: 4-column runs 64 apart where B
// is k-major in shared memory (float4 reads along n), tx + 16 j where it is
// n-major (float4 reads along k of 16 consecutive rows).
template <bool TB>
__device__ __forceinline__ int col_of(int tx, int j) {
  return TB ? tx + 16 * j : (j / 4) * 64 + tx * 4 + j % 4;
}

template <bool TA, bool TB, int BN>
__global__ void __launch_bounds__(THREADS)
matmul_bias_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ bias, float* __restrict__ y,
                   float* __restrict__ part, int M, int N, int K, int relu,
                   int vec_a, int vec_b) {
  constexpr int TN = BN / 16;   // columns per thread
  constexpr int A_FLOATS = tile_floats<TA, BM>();
  constexpr int B_FLOATS = tile_floats<!TB, BN>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const uint32_t s0 = smem_u32(smem);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // this split's chunks: [c_lo, c_hi) of the ceil(K / BK) chunks
  const int n_split = gridDim.z, split = blockIdx.z;
  const int chunks = (K + BK - 1) / BK;
  const int per = (chunks + n_split - 1) / n_split;
  const int c_lo = split * per;
  const int c_hi = min(chunks, c_lo + per);
  const int n_c = max(0, c_hi - c_lo);

  auto load = [&](int c, int stage) {
    const uint32_t sa = s0 + 4 * stage * (A_FLOATS + B_FLOATS);
    const int k0 = (c_lo + c) * BK;
    load_chunk<TA, BM>(sa, a, m0, k0, M, K, vec_a);
    load_chunk<!TB, BN>(sa + 4 * A_FLOATS, b, n0, k0, N, K, vec_b);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_c) load(s, s);
    cp_commit();
  }

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < n_c; ++c) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // chunk c is in; every thread is done with c - 1
    if (c + STAGES - 1 < n_c) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_commit();
    const float* As = smem + (c % STAGES) * (A_FLOATS + B_FLOATS);
    const float* Bs = As + A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float av[8][4], bv[TN][4];
      if (TA) {   // A k-major: As[k][m]
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                As + (kq + kk) * BM + h * 64 + ty * 4);
            av[4 * h + 0][kk] = v.x;
            av[4 * h + 1][kk] = v.y;
            av[4 * h + 2][kk] = v.z;
            av[4 * h + 3][kk] = v.w;
          }
      } else {    // A m-major: As[m][k]
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + row_of(ty, i) * PAD + kq);
          av[i][0] = v.x;
          av[i][1] = v.y;
          av[i][2] = v.z;
          av[i][3] = v.w;
        }
      }
      if (!TB) {  // B k-major: Bs[k][n]
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < TN / 4; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                Bs + (kq + kk) * BN + h * 64 + tx * 4);
            bv[4 * h + 0][kk] = v.x;
            bv[4 * h + 1][kk] = v.y;
            bv[4 * h + 2][kk] = v.z;
            bv[4 * h + 3][kk] = v.w;
          }
      } else {    // B n-major: Bs[n][k]
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              Bs + col_of<TB>(tx, j) * PAD + kq);
          bv[j][0] = v.x;
          bv[j][1] = v.y;
          bv[j][2] = v.z;
          bv[j][3] = v.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i][kk], bv[j][kk], acc[i][j]);
    }
  }
  cp_wait<0>();

  // y = acc + bias (ReLU), or this split's partial
  float* out = n_split == 1 ? y : part + (size_t)split * M * N;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + col_of<TB>(tx, j);
    if (n >= N) continue;
    const float bn = n_split == 1 && bias ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + row_of(ty, i);
      if (m >= M) continue;
      float v = acc[i][j];
      if (n_split == 1) {
        v += bn;
        if (relu) v = relu_keep_nan(v);
      }
      out[(size_t)m * N + n] = v;
    }
  }
}

// y = the sum of the n_split partials, added in split order, + bias
// (ReLU).
__global__ void __launch_bounds__(256)
matmul_bias_sum(const float* __restrict__ part, const float* __restrict__ bias,
                float* __restrict__ y, int M, int N, int n_split, int relu) {
  const size_t n = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < n_split; ++s) v += part[s * n + i];
    if (bias) v += bias[i % N];
    if (relu) v = relu_keep_nan(v);
    y[i] = v;
  }
}

template <bool TA, bool TB, int BN>
int launch(const float* a, const float* b, const float* bias, float* y,
           float* part, int M, int N, int K, int relu, int vec_a, int vec_b,
           int n_split, cudaStream_t stream) {
  constexpr int BYTES =
      4 * STAGES * (tile_floats<TA, BM>() + tile_floats<!TB, BN>());
  const auto kernel = matmul_bias_kernel<TA, TB, BN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, n_split);
  kernel<<<grid, THREADS, BYTES, stream>>>(a, b, bias, y, part, M, N, K,
                                           relu, vec_a, vec_b);
  return (int)cudaGetLastError();
}

template <bool TA, bool TB>
int launch_tiles(const float* a, const float* b, const float* bias, float* y,
                 float* part, int M, int N, int K, int relu, int vec_a,
                 int vec_b, int n_split, cudaStream_t stream) {
  return N <= 64 ? launch<TA, TB, 64>(a, b, bias, y, part, M, N, K, relu,
                                      vec_a, vec_b, n_split, stream)
                 : launch<TA, TB, 128>(a, b, bias, y, part, M, N, K, relu,
                                       vec_a, vec_b, n_split, stream);
}

// Whether an operand's rows are 16-byte aligned: its base and its row
// length (`ld` floats).
bool aligned(const float* p, int ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
}

}  // namespace

// y (M,N) = a @ b + bias, optional ReLU.  a is (M,K) row-major, or (K,M)
// row-major when trans_a; b is (K,N) row-major, or (N,K) row-major when
// trans_b; bias (N,) or null; all fp32 on the current device.  M, N >= 1,
// N / 64 < 65536, and the caller checks that every offset fits in 32-bit
// sizes.  n_split >= 1 blocks share each output tile's reduction; above 1,
// part is fp32 scratch of n_split * M * N and no split may be empty
// (conv2d/ops.py::gemm_split).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); no sync.
extern "C" int matmul_bias_f32(const float* a, const float* b,
                               const float* bias, float* y, float* part,
                               int M, int N, int K, int trans_a, int trans_b,
                               int relu, int n_split, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_split < 1 || (n_split > 1 && !part)) return (int)cudaErrorInvalidValue;
  const int vec_a = aligned(a, trans_a ? M : K);
  const int vec_b = aligned(b, trans_b ? K : N);
#define MATMUL(TA, TB)                                                       \
  launch_tiles<TA, TB>(a, b, bias, y, part, M, N, K, relu, vec_a, vec_b,    \
                       n_split, s)
  int e;
  if (trans_a)
    e = trans_b ? MATMUL(true, true) : MATMUL(true, false);
  else
    e = trans_b ? MATMUL(false, true) : MATMUL(false, false);
#undef MATMUL
  if (e || n_split == 1) return e;
  matmul_bias_sum<<<1024, 256, 0, s>>>(part, bias, y, M, N, n_split, relu);
  return (int)cudaGetLastError();
}
