// The RWKV6 (Finch) WKV recurrence from a zero state, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/rwkv6.py, _wkv_kernel
// (wrapper wkv_pallas).  Per (batch, head), with the state S (K x K fp32):
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
// the semantics of ref.wkv_sequential (kernels/rwkv6/ref.py).  It emits y in
// r's dtype and the final state, as the TPU kernel does.
//
// What bounds it on the H100: bytes, on paper.  It does about 4 K^2
// operations per (b, t, h) against 12 K bytes moved at bf16 r, k, v, y and
// fp32 w: 8.6 GFLOP and 403 MB at B 4, T 2048, H 64, K 64, so the least time
// is the 0.12 ms the bytes take at 3.35 TB/s.  In practice the T dependent
// steps set the time: each step is a short chain of FMAs per thread.
//
// What the design does about it: it takes no log (the TPU form's chunked
// (C, C, K) decay tiles exist to feed the MXU), so it runs step by step and
// stays finite where w underflows to 0.  Columns of S are independent, so
// one block per (b, h) gives each column j to P = 4 adjacent lanes, each
// holding K / P of its rows (rows p, p + P, ...: the four lanes read four
// neighbouring banks) in registers; the partial sums of y_t[j] meet in two
// xor-shuffles.  That is K * P threads per block (16 warps per SM at the
// training shape) to hide the FMA latency.  The block stages TS steps of
// r, k, v, w at a time in shared memory, reading the model's (B, T, H, K)
// layout in place (each step's K values are one contiguous run); the next
// TS steps are fetched into registers while these are walked, and y goes
// out through shared memory in coalesced rows.  Any T: no padding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int P = 4;   // lanes per state column

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

// This thread's PER elements of steps [t0, t0 + TS) of r, k, v, w into
// registers: element e = tid + q * K * P is step e / K, column e % K.  Steps
// at or past Tn read as inert (k = v = 0, w = 1).
template <typename T, int K, int PER>
__device__ __forceinline__ void fetch(const T* __restrict__ r,
                                      const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const float* __restrict__ w,
                                      float (&pr)[PER], float (&pk)[PER],
                                      float (&pv)[PER], float (&pw)[PER],
                                      int t0, int Tn, size_t base,
                                      size_t step) {
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int e = threadIdx.x + q * K * P;
    const int t = t0 + e / K;
    if (t < Tn) {
      const size_t off = base + (size_t)t * step + e % K;
      pr[q] = to_f(r[off]);
      pk[q] = to_f(k[off]);
      pv[q] = to_f(v[off]);
      pw[q] = w[off];
    } else {
      pr[q] = pk[q] = pv[q] = 0.f;
      pw[q] = 1.f;
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(K * P)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, T* __restrict__ y,
           float* __restrict__ s_out, int Tn, int H) {
  constexpr int TS = K >= 128 ? 16 : 32;   // steps staged at a time
  constexpr int NT = K * P;                // threads
  constexpr int PER = TS * K / NT;         // staged elements per thread
  constexpr int R = K / P;                 // state rows per thread
  __shared__ float rs[TS][K], ks[TS][K], vs[TS][K], ws[TS][K], ys[TS][K];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const int j = tid / P, p = tid % P;
  const size_t step = (size_t)H * K;                 // between timesteps
  const size_t base = ((size_t)b * Tn * H + h) * K;  // (b, 0, h, 0)

  float S[R], uu[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    S[m] = 0.f;
    uu[m] = u[h * K + p + P * m];
  }

  float pr[PER], pk[PER], pv[PER], pw[PER];
  fetch<T, K, PER>(r, k, v, w, pr, pk, pv, pw, 0, Tn, base, step);
  for (int t0 = 0; t0 < Tn; t0 += TS) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * NT;
      rs[e / K][e % K] = pr[q];
      ks[e / K][e % K] = pk[q];
      vs[e / K][e % K] = pv[q];
      ws[e / K][e % K] = pw[q];
    }
    __syncthreads();
    if (t0 + TS < Tn)
      fetch<T, K, PER>(r, k, v, w, pr, pk, pv, pw, t0 + TS, Tn, base, step);
    const int n = min(TS, Tn - t0);
    for (int st = 0; st < n; ++st) {
      const float vj = vs[st][j];
      float acc = 0.f, ruk = 0.f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int i = p + P * m;
        const float ri = rs[st][i], ki = ks[st][i];
        acc = fmaf(ri, S[m], acc);
        ruk = fmaf(ri * uu[m], ki, ruk);
        S[m] = fmaf(ws[st][i], S[m], ki * vj);
      }
      float yv = fmaf(ruk, vj, acc);
      yv += __shfl_xor_sync(0xffffffffu, yv, 1);
      yv += __shfl_xor_sync(0xffffffffu, yv, 2);
      if (p == 0) ys[st][j] = yv;
    }
    __syncthreads();
    for (int e = tid; e < n * K; e += NT)
      y[base + (size_t)(t0 + e / K) * step + e % K] =
          from_f<T>(ys[e / K][e % K]);
  }

  float* so = s_out + (size_t)blockIdx.x * K * K;
#pragma unroll
  for (int m = 0; m < R; ++m) so[(p + P * m) * K + j] = S[m];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, void* y, float* s, int B, int Tn, int H, int K,
           cudaStream_t stream) {
  const dim3 grid(B * H);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* yt = static_cast<T*>(y);
  switch (K) {
    case 16:
      wkv_kernel<T, 16><<<grid, 16 * P, 0, stream>>>(rt, kt, vt, w, u, yt, s,
                                                     Tn, H);
      break;
    case 32:
      wkv_kernel<T, 32><<<grid, 32 * P, 0, stream>>>(rt, kt, vt, w, u, yt, s,
                                                     Tn, H);
      break;
    case 64:
      wkv_kernel<T, 64><<<grid, 64 * P, 0, stream>>>(rt, kt, vt, w, u, yt, s,
                                                     Tn, H);
      break;
    case 128:
      wkv_kernel<T, 128><<<grid, 128 * P, 0, stream>>>(rt, kt, vt, w, u, yt,
                                                       s, Tn, H);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, y (B, T, H, K) fp32 or bf16 (bf16 != 0), w (B, T, H, K) fp32,
// u (H, K) fp32, s (B, H, K, K) fp32; contiguous, on the current device;
// K in {16, 32, 64, 128}, T >= 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); no sync.
extern "C" int wkv_fwd(const void* r, const void* k, const void* v,
                       const float* w, const float* u, void* y, float* s,
                       int B, int T, int H, int K, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(r, k, v, w, u, y, s, B, T, H, K, st)
              : launch<float>(r, k, v, w, u, y, s, B, T, H, K, st);
}
