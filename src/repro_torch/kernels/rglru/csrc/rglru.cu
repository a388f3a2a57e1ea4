// The RG-LRU diagonal linear recurrence from a zero state, fp32, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rglru/rglru.py, _rglru_kernel
// (wrapper rglru_pallas):  h_t = a_t h_{t-1} + b_t per channel, the
// semantics of ref.rglru_sequential (kernels/rglru/ref.py).  With
// reverse != 0 it computes the recurrence's transpose, the backward the
// reference runs through the same kernel on flipped, one-step-shifted
// coefficients (rglru.py:98-111):  g_t = b_t + a_{t+1} g_{t+1}, g_{T-1} =
// b_{T-1}, walking t downwards and reading a and b in place (no flip, no
// shift, no concatenation).
//
// What bounds it on the H100: bytes.  One FMA per element against 12
// bytes moved (a and b read, h written, fp32): 403 MB at B 4, T 2048,
// D 4096, so the least time is 0.12 ms at 3.35 TB/s.
//
// What the design does about it: one thread per (b, channel), neighbouring
// threads on neighbouring channels, so every load and store of a warp is
// one 128-byte row.  A thread walks T in runs of U steps: it issues the U
// steps' loads of a and b together, then applies them, so 2 U loads per
// thread are in flight against the memory latency.  Blocks of 64 threads
// spread B * D / 64 blocks over the SMs.  No log is taken, so any a works
// (no a > 0 precondition, no 1e-37 guard).
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 64;
constexpr int U = 16;   // steps whose loads are in flight together

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ h, int B, int T, int D, int reverse) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * D) return;
  const size_t base = (size_t)(idx / D) * T * D + idx % D;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float state = 0.f;
  float av[U], bv[U];
  if (!reverse) {
    for (int t0 = 0; t0 < T; t0 += U) {
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int t = t0 + q;
        av[q] = t < T ? ap[(size_t)t * D] : 0.f;
        bv[q] = t < T ? bp[(size_t)t * D] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int t = t0 + q;
        if (t < T) {
          state = fmaf(av[q], state, bv[q]);
          hp[(size_t)t * D] = state;
        }
      }
    }
  } else {
    float coef = 0.f;   // a_{t+1}; irrelevant at t = T - 1, where state = 0
    for (int t0 = T - 1; t0 >= 0; t0 -= U) {
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int t = t0 - q;
        av[q] = t >= 0 ? ap[(size_t)t * D] : 0.f;
        bv[q] = t >= 0 ? bp[(size_t)t * D] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int t = t0 - q;
        if (t >= 0) {
          state = fmaf(coef, state, bv[q]);
          hp[(size_t)t * D] = state;
          coef = av[q];
        }
      }
    }
  }
}

}  // namespace

// a, b, h (B, T, D) fp32, contiguous, on the current device; B * D and
// B * T * D below 2^31.  Launches on `stream` and returns cudaGetLastError()
// (0 on success); no sync.
extern "C" int rglru_fwd(const float* a, const float* b, float* h, int B,
                         int T, int D, int reverse, void* stream) {
  const int n = B * D;
  const dim3 grid((n + THREADS - 1) / THREADS);
  rglru_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a, b, h, B, T, D,
                                                            reverse);
  return (int)cudaGetLastError();
}
