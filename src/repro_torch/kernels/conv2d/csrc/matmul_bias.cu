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
// least time is FLOPs / 67 TFLOP/s of non-tensor fp32.  This first kernel
// runs on the fp32 FMA pipes (no TF32, to match the reference at 2e-4).
//
// What the design does about it:
//  * A block owns one 64 x 64 output tile and walks the whole K axis in
//    chunks of 16 staged in shared memory; the next chunk's global loads
//    are issued into registers before the current chunk's FMAs.  Each of
//    the 256 threads keeps a 4 x 4 register tile (rows ty + 16 i, columns
//    tx + 16 j: conflict-free shared-memory reads, coalesced stores).
//  * The backward reads w^T and x^T in place: TA / TB say that A is
//    stored as (K, M) or B as (N, K), row-major, and each of the four
//    instantiations maps consecutive threads to consecutive addresses of
//    its own storage order, so every load coalesces and no transposed
//    copy is made (x^T of conv2's patch matrix is 224 MB at batch 32).
//  * Ragged M, N and K (363, 2400, 96, ...) are bounds-checked loads that
//    read 0 and masked stores; nothing is padded in device memory.
//  * Not done yet: the dw products have a small output and a long
//    reduction (conv1: 363 x 96 over K = 96,800 at batch 32 is 12 tiles
//    for 132 SMs), so an output-tiled grid leaves most of the card idle.
//    Split-K is later work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // reduction chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// Tile coordinates of the i-th of the 4 values a thread loads.  The fast
// thread index runs along the storage's contiguous axis.
template <bool TA>
__device__ __forceinline__ void a_coord(int tid, int i, int& m, int& k) {
  if (TA) {            // A stored (K, M): consecutive threads, consecutive m
    m = tid % BM;
    k = tid / BM + 4 * i;
  } else {             // A stored (M, K): consecutive threads, consecutive k
    k = tid % BK;
    m = tid / BK + 16 * i;
  }
}

template <bool TB>
__device__ __forceinline__ void b_coord(int tid, int i, int& k, int& n) {
  if (TB) {            // B stored (N, K): consecutive threads, consecutive k
    k = tid % BK;
    n = tid / BK + 16 * i;
  } else {             // B stored (K, N): consecutive threads, consecutive n
    n = tid % BN;
    k = tid / BN + 4 * i;
  }
}

template <bool TA, bool TB>
__global__ void __launch_bounds__(THREADS)
matmul_bias_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int M, int N, int K, int relu) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int m, k;
      a_coord<TA>(tid, i, m, k);
      const int gm = m0 + m, gk = k0 + k;
      const size_t off = TA ? (size_t)gk * M + gm : (size_t)gm * K + gk;
      ra[i] = (gm < M && gk < K) ? a[off] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int k, n;
      b_coord<TB>(tid, i, k, n);
      const int gk = k0 + k, gn = n0 + n;
      const size_t off = TB ? (size_t)gn * K + gk : (size_t)gk * N + gn;
      rb[i] = (gk < K && gn < N) ? b[off] : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int m, k, n;
      a_coord<TA>(tid, i, m, k);
      As[k][m] = ra[i];
      b_coord<TB>(tid, i, k, n);
      Bs[k][n] = rb[i];
    }
  };

  float acc[4][4] = {};
  load(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);   // in flight while the FMAs below run
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const float bn = bias ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= M) continue;
      float v = acc[i][j] + bn;
      if (relu) v = fmaxf(v, 0.f);
      y[(size_t)m * N + n] = v;
    }
  }
}

template <bool TA, bool TB>
void launch(const float* a, const float* b, const float* bias, float* y,
            int M, int N, int K, int relu, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  matmul_bias_kernel<TA, TB><<<grid, THREADS, 0, stream>>>(a, b, bias, y, M,
                                                           N, K, relu);
}

}  // namespace

// y (M,N) = a @ b + bias, optional ReLU.  a is (M,K) row-major, or (K,M)
// row-major when trans_a; b is (K,N) row-major, or (N,K) row-major when
// trans_b; bias (N,) or null; all fp32 on the current device.  M, N >= 1,
// N / 64 < 65536, and the caller checks that every offset fits in 32-bit
// sizes.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); no sync.
extern "C" int matmul_bias_f32(const float* a, const float* b,
                               const float* bias, float* y, int M, int N,
                               int K, int trans_a, int trans_b, int relu,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (trans_a) {
    if (trans_b) launch<true, true>(a, b, bias, y, M, N, K, relu, s);
    else launch<true, false>(a, b, bias, y, M, N, K, relu, s);
  } else {
    if (trans_b) launch<false, true>(a, b, bias, y, M, N, K, relu, s);
    else launch<false, false>(a, b, bias, y, M, N, K, relu, s);
  }
  return (int)cudaGetLastError();
}
