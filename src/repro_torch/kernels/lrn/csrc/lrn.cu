// Cross-channel local response normalization, fp32, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/lrn/lrn.py, _lrn_kernel
// (wrapper lrn_pallas):  y = x / (k + alpha * W(x^2))^beta, where W is the
// zero-padded size-n window sum over channels, channel j in the window of
// channel c iff c - n/2 <= j < c - n/2 + n (kernels/lrn/ref.py).
//
// What bounds it on the H100: bytes.  It does about n + 10 operations per
// element against 8 bytes moved (one fp32 read, one write), far below the
// card's ridge, so the least time is 8 bytes x elements / 3.35 TB/s.
//
// What the design does about it: the input is viewed as (M = B*H*W, C)
// rows.  One block stages a tile of whole rows in shared memory with
// coalesced loads (the tile is one contiguous run of x), then each output
// reads its n channel neighbours from shared memory: one device-memory
// read and one write per element, as in the Pallas kernel.  n, alpha,
// beta and k are arguments (powf), nothing assumes beta = 0.75.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_FLOATS = 2048;   // rows per block = max(1, this / C)

__global__ void __launch_bounds__(THREADS)
lrn_kernel(const float* __restrict__ x, float* __restrict__ y, int M, int C,
           int rows_per_block, int n, float alpha, float beta, float k) {
  extern __shared__ float tile[];
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, M - row0);
  const int count = rows * C;
  const float* xb = x + (size_t)row0 * C;
  float* yb = y + (size_t)row0 * C;
  for (int e = threadIdx.x; e < count; e += THREADS) tile[e] = xb[e];
  __syncthreads();
  const int half = n / 2;
  for (int e = threadIdx.x; e < count; e += THREADS) {
    const int r = e / C;
    const int c = e - r * C;
    const float* t = tile + r * C;
    const int lo = max(c - half, 0);
    const int hi = min(c - half + n, C);
    float s = 0.f;
    for (int j = lo; j < hi; ++j) s += t[j] * t[j];
    yb[e] = t[c] / powf(k + alpha * s, beta);
  }
}

}  // namespace

// x, y (M, C) fp32, contiguous, on the current device; 1 <= C <= 12288 so
// one row fits the default 48 KB of shared memory.  Launches on `stream`
// and returns cudaGetLastError() (0 on success); no sync.
extern "C" int lrn_f32(const float* x, float* y, int M, int C, int n,
                       float alpha, float beta, float k, void* stream) {
  const int rows = C >= TILE_FLOATS ? 1 : TILE_FLOATS / C;
  const dim3 grid((M + rows - 1) / rows);
  const size_t smem = (size_t)rows * C * sizeof(float);
  lrn_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, y, M, C, rows, n, alpha, beta, k);
  return (int)cudaGetLastError();
}
