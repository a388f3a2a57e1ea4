// Cross-channel local response normalization, fp32 or bf16, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/lrn/lrn.py, _lrn_kernel
// (wrapper lrn_pallas):  y = x / (k + alpha * W(x^2))^beta, where W is the
// zero-padded size-n window sum over channels, channel j in the window of
// channel c iff c - n/2 <= j < c - n/2 + n (kernels/lrn/ref.py).
//
// What bounds it on the H100: bytes.  It does about n + 10 operations per
// element against 8 bytes moved (one fp32 read, one write), far below the
// card's ridge, so the least time is 8 bytes x elements / 3.35 TB/s: 0.0346
// ms for AlexNet's lrn1 + lrn2 at batch 128 (14.5 M elements).  This
// kernel takes 0.049 ms there, 70 % of the bound (2.4 TB/s, H100 80GB
// HBM3 at 700 W, chip_smoke.py's lrn_phase): a kernel this short spends
// the rest in its launch's ramp and its tail at about two waves.
//
// What the design does about it: the input is viewed as (M = B*H*W, C)
// rows.  Where C % 4 == 0, C <= 1024 and n <= 9 (lrn_vec_kernel, the
// main path: C = 96 and 256), a thread owns 4 neighbouring channels of a
// row, one 16-byte load and one 16-byte store, and U rows of a block's
// run, all loaded before any arithmetic so U loads a thread are in flight.
// Its (row, channel group) is computed once.  The window's halo (n/2
// channels below, n - 1 - n/2 above, at most 4 each) comes from the
// neighbouring threads' squares by warp shuffle; where the neighbour sits
// in another warp (lane 0 or 31 of a row that straddles two warps) the
// thread loads the neighbour's 16 bytes itself, which the other warp's
// load has brought into L1 or L2.  The window is summed from registers, n
// terms in ascending channel order, the plain version's order, with no
// sliding subtraction; n is a template argument (1..9), alpha, beta and k
// are arguments.  The power is x * exp2(-beta * log2(d)) (full-accuracy
// exp2f and log2f), since d >= k > 0 where k > 0 and alpha >= 0; any other
// d takes powf.  Other shapes (lrn_generic_kernel: C % 4 != 0, wider rows,
// wider windows) read each window straight from device memory, one element
// a thread.
//
// bf16 (lrn_bf16, the bf16 numerics preset's path): the same kernels
// templated on the storage type, as the TPU kernel computes in fp32 and
// stores in x's dtype.  The vectorized path moves 4 channels a thread in
// one 8-byte load and one 8-byte store, widens them to fp32, sums the
// window and scales in fp32 and rounds once to bf16 (round to nearest
// even).  Its bound is half the fp32 one: 4 bytes an element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;     // threads a block aims at
constexpr int U = 2;           // rows a thread has in flight
constexpr int MAX_GROUPS = BLOCK;  // channel groups of 4 in one row (C/4)
constexpr int MAX_N = 9;       // the halo on each side fits one float4
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float scale(float x, float d, float beta) {
  return d > 0.f ? x * exp2f(-beta * log2f(d)) : x / powf(d, beta);
}

// Four neighbouring channels in storage: a float4 (fp32) or a uint2 of
// four bf16 (channel 0 in the low half of .x).
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
};
template <>
struct Quad<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store_cs(float4* p, float4 v) {
  __stcs(p, v);
}
__device__ __forceinline__ void store_cs(uint2* p, float4 v) {
  __stcs(p, make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w)));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int N, typename Q>
__global__ void __launch_bounds__(BLOCK)
lrn_vec_kernel(const Q* __restrict__ x, Q* __restrict__ y, int M, int G,
               int rows_per_step, float alpha, float beta, float k) {
  constexpr int HALF = N / 2;          // channels below
  constexpr int HI = N - 1 - HALF;     // channels above
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = tid % G;               // channel group: channels 4j..4j+3
  const int ry = tid / G;
  const bool live = ry < rows_per_step;
  const int row0 = blockIdx.x * rows_per_step * U + ry;
  const bool left_far = lane == 0 && j > 0;       // neighbour in another warp
  const bool right_far = lane == 31 && j < G - 1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xv[U], lv[U], rv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int row = row0 + u * rows_per_step;
    const bool ok = live && row < M;
    const size_t at = (size_t)row * G + j;
    xv[u] = ok ? widen(__ldcs(x + at)) : zero;
    lv[u] = HALF > 0 && ok && left_far ? widen(__ldg(x + at - 1)) : zero;
    rv[u] = HI > 0 && ok && right_far ? widen(__ldg(x + at + 1)) : zero;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int row = row0 + u * rows_per_step;
    float w[12];   // squares of channels 4j-4 .. 4j+7
    w[4] = xv[u].x * xv[u].x;
    w[5] = xv[u].y * xv[u].y;
    w[6] = xv[u].z * xv[u].z;
    w[7] = xv[u].w * xv[u].w;
    const float lq[4] = {lv[u].x * lv[u].x, lv[u].y * lv[u].y,
                         lv[u].z * lv[u].z, lv[u].w * lv[u].w};
    const float rq[4] = {rv[u].x * rv[u].x, rv[u].y * rv[u].y,
                         rv[u].z * rv[u].z, rv[u].w * rv[u].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      w[c] = 0.f;
      w[8 + c] = 0.f;
    }
#pragma unroll
    for (int c = 4 - HALF; c < 4; ++c) {
      const float up = __shfl_up_sync(FULL, w[4 + c], 1);
      w[c] = j == 0 ? 0.f : (lane == 0 ? lq[c] : up);
    }
#pragma unroll
    for (int c = 0; c < HI; ++c) {
      const float down = __shfl_down_sync(FULL, w[4 + c], 1);
      w[8 + c] = j == G - 1 ? 0.f : (lane == 31 ? rq[c] : down);
    }
    float xs[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
    float out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) s += w[4 + c - HALF + m];
      out[c] = scale(xs[c], k + alpha * s, beta);
    }
    if (live && row < M)
      store_cs(y + (size_t)row * G + j,
               make_float4(out[0], out[1], out[2], out[3]));
  }
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
lrn_generic_kernel(const T* __restrict__ x, T* __restrict__ y, int total,
                   int C, int n, float alpha, float beta, float k) {
  const int half = n / 2;
  for (int e = blockIdx.x * BLOCK + threadIdx.x; e < total;
       e += gridDim.x * BLOCK) {
    const int c = e % C;
    const T* xr = x + (e - c);
    const int lo = max(c - half, 0);
    const int hi = min(c - half + n, C);
    float s = 0.f;
    for (int i = lo; i < hi; ++i) {
      const float v = to_f32(xr[i]);
      s += v * v;
    }
    store(y + e, scale(to_f32(x[e]), k + alpha * s, beta));
  }
}

template <int N, typename T>
void launch_vec(const T* x, T* y, int M, int G, float alpha, float beta,
                float k, cudaStream_t stream) {
  using Q = typename Quad<T>::type;
  // rows a block takes per step: a whole number of warps where that fits
  int rows = BLOCK / G;
  for (int r = rows; r >= 1; --r) {
    if ((G * r) % 32 == 0) {
      rows = r;
      break;
    }
  }
  const int threads = (G * rows + 31) / 32 * 32;
  const int grid = (M + rows * U - 1) / (rows * U);
  lrn_vec_kernel<N, Q><<<grid, threads, 0, stream>>>(
      reinterpret_cast<const Q*>(x), reinterpret_cast<Q*>(y), M, G, rows,
      alpha, beta, k);
}

template <typename T>
int launch(const T* x, T* y, int M, int C, int n, float alpha, float beta,
           float k, cudaStream_t st) {
  const int G = C / 4;
  const bool vec = C % 4 == 0 && G <= MAX_GROUPS && n <= MAX_N &&
                   ((uintptr_t)x | (uintptr_t)y) % sizeof(
                       typename Quad<T>::type) == 0;
  if (!vec) {
    const int total = M * C;
    const int grid = (total + BLOCK - 1) / BLOCK;
    lrn_generic_kernel<T><<<grid < 65536 ? grid : 65536, BLOCK, 0, st>>>(
        x, y, total, C, n, alpha, beta, k);
    return (int)cudaGetLastError();
  }
  switch (n) {
    case 1: launch_vec<1>(x, y, M, G, alpha, beta, k, st); break;
    case 2: launch_vec<2>(x, y, M, G, alpha, beta, k, st); break;
    case 3: launch_vec<3>(x, y, M, G, alpha, beta, k, st); break;
    case 4: launch_vec<4>(x, y, M, G, alpha, beta, k, st); break;
    case 5: launch_vec<5>(x, y, M, G, alpha, beta, k, st); break;
    case 6: launch_vec<6>(x, y, M, G, alpha, beta, k, st); break;
    case 7: launch_vec<7>(x, y, M, G, alpha, beta, k, st); break;
    case 8: launch_vec<8>(x, y, M, G, alpha, beta, k, st); break;
    default: launch_vec<9>(x, y, M, G, alpha, beta, k, st); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (M, C) fp32 (lrn_f32) or bf16 (lrn_bf16), contiguous, on the
// current device; C >= 1, n >= 1 and M * C below 2^31.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); no sync.
extern "C" int lrn_f32(const float* x, float* y, int M, int C, int n,
                       float alpha, float beta, float k, void* stream) {
  return launch(x, y, M, C, n, alpha, beta, k, (cudaStream_t)stream);
}

extern "C" int lrn_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int M,
                        int C, int n, float alpha, float beta, float k,
                        void* stream) {
  return launch(x, y, M, C, n, alpha, beta, k, (cudaStream_t)stream);
}
