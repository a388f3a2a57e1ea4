// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Tiles live in shared memory as fp32 and transposed, X^T[d][r] with a row
// stride of R + 1 floats: a thread loads consecutive d of one row (coalesced
// in device memory), and the +1 keeps those stores on distinct banks.  The
// products then read X^T[d][ty + 16 i] (one address per half-warp, a
// broadcast) and X^T[d][tx + 16 j] (16 consecutive addresses), or, reading a
// tile as its transpose, X^T[tx + 16 c][r] (stride R + 1: distinct banks).
//
// 256 threads form a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j of every per-tile matrix, so the 16 threads that share
// a row are one half-warp and a row reduction is four xor-shuffles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace flash {

constexpr float NEG = -1e30f;   // the reference's finite mask sentinel
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [r0, r0 + R) of a row-major (S, HD) matrix into dst[d * (R + 1) + r]
// as fp32; rows at or past S read 0 (the ragged tail, nothing padded in HBM).
template <typename T, int R, int HD>
__device__ __forceinline__ void load_t(float* __restrict__ dst,
                                       const T* __restrict__ src, int r0,
                                       int S) {
  for (int e = threadIdx.x; e < R * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int gr = r0 + r;
    dst[d * (R + 1) + r] = gr < S ? to_f(src[(size_t)gr * HD + d]) : 0.f;
  }
}

// Whether the (q0.., k0..) tile holds any unmasked entry: the reference's
// _tile_visible (flash_attention.py:63).  Depends on the block's indices
// only, so a block skips a tile as a whole.
__device__ __forceinline__ bool tile_visible(int q0, int k0, int bq, int bk,
                                             int S, int causal, int window) {
  bool vis = k0 < S;
  if (causal) vis = vis && k0 <= q0 + bq - 1;
  if (window > 0) vis = vis && k0 + bk - 1 > q0 - window;
  return vis;
}

// The reference's _tile_mask for one (row, col); window <= 0 is no window.
__device__ __forceinline__ bool unmasked(int row, int col, int S, int causal,
                                         int window, bool with_rows) {
  bool m = col < S;
  if (with_rows) m = m && row < S;
  if (causal) m = m && col <= row;
  if (window > 0) m = m && col > row - window;
  return m;
}

// Max / sum over the 16 lanes of a half-warp (the threads sharing a row).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The KV row of query row bh_q: b * Hkv + h // G (GQA by index, no repeat).
__device__ __forceinline__ int kv_row(int bh_q, int n_q_heads,
                                      int n_kv_heads) {
  const int b = bh_q / n_q_heads, h = bh_q % n_q_heads;
  return b * n_kv_heads + h / (n_q_heads / n_kv_heads);
}

// Opt in to more than 48 KB of dynamic shared memory, then launch blocks of
// Threads threads.
template <int Threads = THREADS, typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, Threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash
