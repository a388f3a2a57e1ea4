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
// bf16 (lrn_bf16, the bf16 numerics preset's path): the TPU kernel computes
// in fp32 and stores in x's dtype, so every path widens to fp32, sums the
// window and scales in fp32 and rounds once to bf16 (round to nearest even).
// Its bound is half the fp32 one: 4 bytes an element, 0.0173 ms for lrn1 +
// lrn2 at batch 128.  The fp32 layout (4 channels a thread) moves only 8
// bytes each way in bf16 and ran at 38 % of that bound, so where C % 8 ==
// 0, C <= 2048, n <= 9, k >= FLT_MIN and alpha >= 0 (lrn_vec8_kernel:
// AlexNet's C = 96 and 256, k = 2) a thread owns 8 neighbouring channels
// of a row, one 16-byte load and one 16-byte store, U8 rows in flight, so
// the bytes in flight a thread match the fp32 path's; 12 threads a row at
// C = 96, 32 at C = 256.  The halo (at most 4 channels each side) comes
// from the neighbours' squares by warp shuffle, or, where the neighbour
// sits in another warp, from the thread's own 16-byte load of it, as in
// lrn_vec_kernel; the window is summed from registers in ascending channel
// order.  At 8 channels a thread the full-accuracy exp2f and log2f bound
// the kernel, not the bytes (at AlexNet's shapes it ran barely faster
// than 4 channels a thread), so it takes the power through the SFU's
// approximations, flushing forms, no branch (scale_sfu): d = k + alpha *
// (a sum of squares) >= k is a normal number under the path's rule.  The
// approximations move the fp32 result by a few fp32 ulps, so an output
// whose exact value lies that close to a bf16 rounding boundary rounds
// the other way: a one-ulp flip, which chip_smoke.py counts against the
// full-accuracy form.  Other bf16 shapes keep the paths above (C % 4 ==
// 0: lrn_vec_kernel on 8-byte loads; else lrn_generic_kernel), picked by
// shape before the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;     // threads a block aims at
constexpr int U = 2;           // rows a thread has in flight
constexpr int U8 = 2;          // rows of 8 bf16 channels a thread has in flight
constexpr int MAX_GROUPS = BLOCK;  // channel groups in one row (C/4; C/8)
constexpr int MAX_N = 9;       // the halo on each side fits one float4
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float scale(float x, float d, float beta) {
  return d > 0.f ? x * exp2f(-beta * log2f(d)) : x / powf(d, beta);
}

// The same power through the SFU's lg2 and ex2 approximations, one
// instruction each, relative errors near 2^-22 (a bf16 ulp is 2^-8).  The
// full-accuracy exp2f and log2f cost several times more and bound the bf16
// 8-channel path.  For d a normal number only (d >= k when k is one and
// alpha >= 0: the host takes that path only then), so the forms that
// flush subnormals to zero give the same result and no branch is needed.
__device__ __forceinline__ float scale_sfu(float x, float d, float beta) {
  float l, e;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(d));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-beta * l));
  return x * e;
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

// Eight bf16 channels, widened (channel 0 in the low half of .x).
__device__ __forceinline__ void widen8(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// bf16 rows of C = 8 G channels: thread (row, j) owns channels 8j..8j+7;
// the power by scale_sfu (d is normal).
template <int N>
__global__ void __launch_bounds__(BLOCK)
lrn_vec8_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int M,
                int G, int rows_per_step, float alpha, float beta, float k) {
  constexpr int HALF = N / 2;          // channels below
  constexpr int HI = N - 1 - HALF;     // channels above
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = tid % G;               // channels 8j..8j+7
  const int ry = tid / G;
  const bool live = ry < rows_per_step;
  const int row0 = blockIdx.x * rows_per_step * U8 + ry;
  const bool left_far = lane == 0 && j > 0;       // neighbour in another warp
  const bool right_far = lane == 31 && j < G - 1;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xv[U8], lv[U8], rv[U8];
#pragma unroll
  for (int u = 0; u < U8; ++u) {
    const int row = row0 + u * rows_per_step;
    const bool ok = live && row < M;
    const size_t at = (size_t)row * G + j;
    xv[u] = ok ? __ldcs(x + at) : zero;
    lv[u] = HALF > 0 && ok && left_far ? __ldg(x + at - 1) : zero;
    rv[u] = HI > 0 && ok && right_far ? __ldg(x + at + 1) : zero;
  }
#pragma unroll
  for (int u = 0; u < U8; ++u) {
    const int row = row0 + u * rows_per_step;
    float xs[8], lf[8], rf[8];
    widen8(xv[u], xs);
    widen8(lv[u], lf);
    widen8(rv[u], rf);
    float w[24];   // squares of channels 8j-8 .. 8j+15
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      w[c] = 0.f;
      w[8 + c] = xs[c] * xs[c];
      w[16 + c] = 0.f;
    }
#pragma unroll
    for (int c = 8 - HALF; c < 8; ++c) {
      const float up = __shfl_up_sync(FULL, w[8 + c], 1);
      w[c] = j == 0 ? 0.f : (lane == 0 ? lf[c] * lf[c] : up);
    }
#pragma unroll
    for (int c = 0; c < HI; ++c) {
      const float down = __shfl_down_sync(FULL, w[8 + c], 1);
      w[16 + c] = j == G - 1 ? 0.f : (lane == 31 ? rf[c] * rf[c] : down);
    }
    uint32_t out[4];
#pragma unroll
    for (int c = 0; c < 8; c += 2) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        s0 += w[8 + c - HALF + m];
        s1 += w[9 + c - HALF + m];
      }
      const float d0 = k + alpha * s0, d1 = k + alpha * s1;
      out[c / 2] = pack_bf16(scale_sfu(xs[c], d0, beta),
                             scale_sfu(xs[c + 1], d1, beta));
    }
    if (live && row < M)
      __stcs(y + (size_t)row * G + j,
             make_uint4(out[0], out[1], out[2], out[3]));
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

// Rows a block takes per step for G threads a row: a whole number of warps
// where that fits.
int block_rows(int G) {
  int rows = BLOCK / G;
  for (int r = rows; r >= 1; --r) {
    if ((G * r) % 32 == 0) {
      rows = r;
      break;
    }
  }
  return rows;
}

template <int N>
void launch_vec8(const __nv_bfloat16* x, __nv_bfloat16* y, int M, int G,
                 float alpha, float beta, float k, cudaStream_t stream) {
  const int rows = block_rows(G);
  const int threads = (G * rows + 31) / 32 * 32;
  const int grid = (M + rows * U8 - 1) / (rows * U8);
  lrn_vec8_kernel<N><<<grid, threads, 0, stream>>>(
      reinterpret_cast<const uint4*>(x), reinterpret_cast<uint4*>(y), M, G,
      rows, alpha, beta, k);
}


template <int N, typename T>
void launch_vec(const T* x, T* y, int M, int G, float alpha, float beta,
                float k, cudaStream_t stream) {
  using Q = typename Quad<T>::type;
  const int rows = block_rows(G);
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
  const cudaStream_t st = (cudaStream_t)stream;
  const int G = C / 8;
  // d = k + alpha * (a sum of squares) >= k: a normal number wherever k
  // is one and alpha >= 0 (AlexNet's k = 2, alpha = 1e-4)
  const bool vec8 = C % 8 == 0 && G <= MAX_GROUPS && n <= MAX_N &&
                    k >= FLT_MIN && alpha >= 0.f &&
                    ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
  if (!vec8) return launch(x, y, M, C, n, alpha, beta, k, st);
  switch (n) {
    case 1: launch_vec8<1>(x, y, M, G, alpha, beta, k, st); break;
    case 2: launch_vec8<2>(x, y, M, G, alpha, beta, k, st); break;
    case 3: launch_vec8<3>(x, y, M, G, alpha, beta, k, st); break;
    case 4: launch_vec8<4>(x, y, M, G, alpha, beta, k, st); break;
    case 5: launch_vec8<5>(x, y, M, G, alpha, beta, k, st); break;
    case 6: launch_vec8<6>(x, y, M, G, alpha, beta, k, st); break;
    case 7: launch_vec8<7>(x, y, M, G, alpha, beta, k, st); break;
    case 8: launch_vec8<8>(x, y, M, G, alpha, beta, k, st); break;
    default: launch_vec8<9>(x, y, M, G, alpha, beta, k, st); break;
  }
  return (int)cudaGetLastError();
}
