// The RWKV6 (Finch) WKV recurrence from a zero state, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/rwkv6.py, _wkv_kernel
// (wrapper wkv_pallas).  Per (batch, head), with the state S (K x K fp32):
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
// the semantics of ref.wkv_sequential (kernels/rwkv6/ref.py).  It emits y in
// r's dtype and the final state, as the TPU kernel does.
//
// What bounds it on the H100: on paper, operations and bytes about
// equally.  It does about 4 K^2 operations per (b, t, h) against 12 K bytes
// moved at bf16 r, k, v, y and fp32 w: 8.6 GFLOP and 403 MB at B 4, T 2048,
// H 64, K 64, 0.128 ms at 67 TFLOP/s fp32 and 0.12 ms at 3.35 TB/s.  A walk
// of the T steps one by one is bound by its chain of dependent steps
// instead: one block per (b, h) is 256 blocks, two per SM, each step a
// short chain of FMAs.  Any walk costs 3 fp32 operations per state entry
// and step (a multiply for k v^T, an FMA for the decay, an FMA for y), so
// in practice the issue slots bound this kernel.
//
// What the design does about it: it cuts the chain into chunks of C steps
// (ops.py::wkv_chunk, a pure rule) and runs them in parallel, as the TPU
// kernel's grid (B * H, T / C) does, but without its log: the decay
// products are taken by multiplication, never exp(cumsum(log w)), so the
// kernel stays finite where w underflows to 0.  Up to three launches, in
// order on one stream, with fp32 scratch between them (`part`):
//  1. wkv_chunk_kernel.  Per (b, h), one block walks chunk 0 from a zero
//     state (as in 3), which gives its y and the state S_1 after it; and
//     one block per later chunk but the last finds the chunk's own state
//     from zero, L = sum_s (k_s * prod_{s < t < C} w_t) v_s^T, and its decay
//     D = prod w.  Those stages go last to first, and one thread per column
//     of k keeps the running product of the later steps' w, so L is a
//     product of two staged matrices: one FMA per entry and step.  The
//     walks, which mostly issue FMAs, share the SMs with these blocks,
//     which mostly wait on memory.
//  2. wkv_carry_kernel, per (b, h) and slice of the K x K entries: the
//     states between the chunks, S_{c+1} = D_c * S_c + L_c from S_1 on, in
//     chunk order, written over L_c.  Entries are independent, so it runs
//     over B * H * K^2 / 512 blocks and is bound by its bytes.
//  3. wkv_chunk_kernel again, per (b, h, chunk) from chunk 1 on: walks the
//     chunk from S_c, giving y; the last chunk's block writes the final
//     state.
//  The carry is a kernel of its own and not the last block of each (b, h)
//  behind a counter (module-wide counters would race between two calls on
//  two streams, as in decode_attention.cu), nor each walk's prologue
//  (re-reading the states before it, which was slower at short chunks in
//  a development build).  Fixed orders and no atomics: two calls agree bit
//  for bit.  Blocks run chunk-major (all (b, h) of a chunk, then the next),
//  so blocks in flight together read neighbouring heads of the same steps:
//  runs of H * K elements in memory.
//
// Each thread of the chunk states' and the walks' blocks holds an R x R
// tile of a state in registers (R = 8 at K 64: 64 threads per (b, h,
// chunk)); its rows and its columns are runs of 4 neighbours, so a step's
// values for its rows and its columns come from shared memory as vector
// reads, and the lanes of a row group read neighbouring banks.  The
// partial sums of y_t meet across the K / R row groups of a column group
// (neighbouring lanes) in a reduce-scatter of xor-shuffles: R - 1 shuffles
// for R columns.  The blocks stage TS steps at a time with 16-byte cp.async
// copies, read from the model's (B, T, H, K) layout in place, into a ring
// of two stages, so the next stage's bytes fly while this one is walked.
// The walk reads r, k, v in their own type and widens them in registers:
// bf16 halves the shared-memory bytes a step reads, and the shared-memory
// pipe, not the FMA pipes, bounds a walk whose tiles are narrower (16 x 4
// tiles and fp32 stages were slower in development builds).  The chunk
// states' blocks turn their stage into fp32 once, k times the running
// decay product.  y leaves through shared memory in 16-byte stores.  Any
// T: the last chunk is short, no padding in memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TS = 16;              // steps staged at a time (divides C)
constexpr int CARRY_THREADS = 128;  // the carry: four entries a thread

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

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T x[N];
};

// The tile of a thread: R x R entries of the K x K state, rows (and
// columns) q * G * V + g * V + e (q < R / V, e < V) of its row (column)
// group g < G = K / R.  NT = G^2 threads (whole warps), row group fastest,
// so a column group's row groups are neighbouring lanes.
template <int K>
struct Tile {
  static constexpr int R = K / 8 < 8 ? K / 8 : 8;
  static constexpr int V = R < 4 ? R : 4;
  static constexpr int G = K / R;
  static constexpr int NT = G * G;
  static_assert(NT >= K, "a column of k per thread in scale_k");
  __device__ static int at(int g, int l) {   // local index l -> row / col
    return (l / V) * G * V + g * V + l % V;
  }
};

// x[0 .. R) of row (column) group g from a step's K values in shared
// memory, as fp32.
template <int K, typename X>
__device__ __forceinline__ void read_tile(const X* __restrict__ src, int g,
                                          float (&x)[Tile<K>::R]) {
  using TL = Tile<K>;
#pragma unroll
  for (int q = 0; q < TL::R / TL::V; ++q) {
    const Vec<X, TL::V> t =
        *reinterpret_cast<const Vec<X, TL::V>*>(src + TL::at(g, q * TL::V));
#pragma unroll
    for (int e = 0; e < TL::V; ++e) x[q * TL::V + e] = to_f(t.x[e]);
  }
}

// The thread's tile of a K x K fp32 matrix at m (row-major) into S, or
// S into it.
template <int K, bool STORE>
__device__ __forceinline__ void move_tile(float* m, int rg, int cg,
                                          float (&S)[Tile<K>::R][Tile<K>::R]) {
  using TL = Tile<K>;
  using VF = Vec<float, TL::V>;
#pragma unroll
  for (int i = 0; i < TL::R; ++i) {
    float* row = m + (size_t)TL::at(rg, i) * K;
#pragma unroll
    for (int q = 0; q < TL::R / TL::V; ++q) {
      VF* p = reinterpret_cast<VF*>(row + TL::at(cg, q * TL::V));
      if constexpr (STORE) {
        VF t;
#pragma unroll
        for (int e = 0; e < TL::V; ++e) t.x[e] = S[i][q * TL::V + e];
        *p = t;
      } else {
        const VF t = *p;
#pragma unroll
        for (int e = 0; e < TL::V; ++e) S[i][q * TL::V + e] = t.x[e];
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in
// flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The raw stage: TS steps of r, k, v (T) and w (fp32), each [TS][K], as
// the copies land.
template <typename T, int K>
struct Raw {
  static constexpr int bytes = TS * K * (3 * (int)sizeof(T) + 4);
  T* r;
  T* k;
  T* v;
  float* w;
  __device__ explicit Raw(unsigned char* base)
      : r(reinterpret_cast<T*>(base)),
        k(r + TS * K),
        v(k + TS * K),
        w(reinterpret_cast<float*>(v + TS * K)) {}
};

// The 16-byte copies of steps [t0, t0 + n) of x (B, T, H, K), base
// (b, 0, h, 0), into dst[n][K]; asynchronous (cp.async).
template <typename X, int K, int NT>
__device__ __forceinline__ void fetch(const X* __restrict__ x, size_t base,
                                      size_t step, int t0, int n, X* dst) {
  constexpr int PV = 16 / (int)sizeof(X);   // elements per copy
  constexpr int PR = K / PV;                // copies per step
  for (int e = threadIdx.x; e < n * PR; e += NT) {
    const int s = e / PR, i = (e % PR) * PV;
    cp_async16(dst + s * K + i, x + base + (size_t)(t0 + s) * step + i);
  }
}

// Elements [0, n) of src (T) to fp32 dst, n a multiple of 16 / sizeof(T).
template <typename T, int NT>
__device__ __forceinline__ void widen(const T* __restrict__ src, int n,
                                      float* __restrict__ dst) {
  constexpr int PV = 16 / (int)sizeof(T);
  for (int e = threadIdx.x * PV; e < n; e += NT * PV) {
    const Vec<T, PV> t = *reinterpret_cast<const Vec<T, PV>*>(src + e);
#pragma unroll
    for (int c = 0; c < PV; c += 4) {
      Vec<float, 4> f;
#pragma unroll
      for (int j = 0; j < 4; ++j) f.x[j] = to_f(t.x[c + j]);
      *reinterpret_cast<Vec<float, 4>*>(dst + e + c) = f;
    }
  }
}

// Thread i < K of a chunk state's block: k of column i times q, the
// product of the w of the chunk's later steps, for the stage's TS steps
// walked backwards, into dst; q goes on to the stage before.  The loads
// come first, so only the products wait on each other.
template <typename T, int K>
__device__ __forceinline__ void scale_k(const T* __restrict__ k,
                                        const float* __restrict__ w, int i,
                                        float& q, float* __restrict__ dst) {
  float kk[TS], ww[TS];
#pragma unroll
  for (int s = 0; s < TS; ++s) {
    kk[s] = to_f(k[s * K + i]);
    ww[s] = w[s * K + i];
  }
#pragma unroll
  for (int s = TS - 1; s >= 0; --s) {
    dst[s * K + i] = kk[s] * q;
    q *= ww[s];
  }
}

// The own state of chunk c < nc - 1 of (b, h) = bh, which is full: L
// (K x K) at part[(bh * (nc - 1) + c) * K * K], D (K) at
// part_d[(bh * (nc - 1) + c) * K].  Its stages go last to first, two in
// flight; thread i < K keeps q, the product of the w of the chunk's later
// steps in column i (scale_k).
template <typename T, int K>
__device__ __forceinline__ void chunk_state(
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, float* __restrict__ part,
    float* __restrict__ part_d, int Tn, int H, int C, int nc, int bh, int c,
    unsigned char* smem) {
  using TL = Tile<K>;
  using RS = Raw<T, K>;
  constexpr int R = TL::R;
  float* ks = reinterpret_cast<float*>(smem + 2 * RS::bytes);   // [TS][K]
  float* vs = ks + TS * K;                                       // [TS][K]
  const size_t unit = (size_t)bh * (nc - 1) + c;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int rg = tid % TL::G, cg = tid / TL::G;
  const size_t step = (size_t)H * K;
  const size_t base = ((size_t)b * Tn * H + h) * K;
  const int n_sub = C / TS;
  auto issue = [&](int i) {   // stage i: steps of sub-chunk n_sub - 1 - i
    const RS raw(smem + (i & 1) * RS::bytes);
    const int t0 = c * C + (n_sub - 1 - i) * TS;
    fetch<T, K, TL::NT>(k, base, step, t0, TS, raw.k);
    fetch<T, K, TL::NT>(v, base, step, t0, TS, raw.v);
    fetch<float, K, TL::NT>(w, base, step, t0, TS, raw.w);
  };
  float q = 1.f;   // thread i < K: the later steps' decay product, col i
  auto widen_stage = [&](int i) {
    const RS raw(smem + (i & 1) * RS::bytes);
    widen<T, TL::NT>(raw.v, TS * K, vs);
    if (tid < K) scale_k<T, K>(raw.k, raw.w, tid, q, ks);
  };

  float L[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) L[i][j] = 0.f;
  issue(0);
  cp_async_commit();
  if (n_sub > 1) issue(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  widen_stage(0);
  __syncthreads();
  for (int i = 0; i < n_sub; ++i) {
    if (i + 2 < n_sub) issue(i + 2);   // stage i's raw copy is widened
    cp_async_commit();
#pragma unroll 4
    for (int s = 0; s < TS; ++s) {
      float kk[R], vv[R];
      read_tile<K>(ks + s * K, rg, kk);
      read_tile<K>(vs + s * K, cg, vv);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int j = 0; j < R; ++j) L[a][j] = fmaf(kk[a], vv[j], L[a][j]);
    }
    cp_async_wait<1>();   // stage i + 1 is in
    __syncthreads();
    if (i + 1 < n_sub) widen_stage(i + 1);
    __syncthreads();
  }
  move_tile<K, true>(part + unit * K * K, rg, cg, L);
  if (tid < K) part_d[unit * K + tid] = q;
}

// The carry: entries [4 * (blockIdx.y * CARRY_THREADS + tid), + 4) of the
// states of (b, h) = blockIdx.x: from S_1 (slot 0, the walk of chunk 0
// leaves it there), S_{c+1} = D_c * S_c + L_c over L_c (slot c, 0 < c < n),
// written in place.
template <int K>
__global__ void __launch_bounds__(CARRY_THREADS)
wkv_carry_kernel(float* __restrict__ part, const float* __restrict__ part_d,
                 int n) {
  const int idx = 4 * (blockIdx.y * CARRY_THREADS + threadIdx.x);
  if (idx >= K * K) return;
  const size_t first = (size_t)blockIdx.x * n;
  const int row = idx / K;
  using V4 = Vec<float, 4>;
  V4 S = *reinterpret_cast<const V4*>(part + first * K * K + idx);
  V4 Lc = *reinterpret_cast<const V4*>(part + (first + 1) * K * K + idx);
  float dc = part_d[(first + 1) * K + row];
  for (int c = 1; c < n; ++c) {
    V4 Ln = Lc;
    float dn = dc;
    if (c + 1 < n) {   // the next chunk's loads, before this one's store
      Ln = *reinterpret_cast<const V4*>(part + (first + c + 1) * K * K + idx);
      dn = part_d[(first + c + 1) * K + row];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) S.x[e] = fmaf(dc, S.x[e], Lc.x[e]);
    *reinterpret_cast<V4*>(part + (first + c) * K * K + idx) = S;
    Lc = Ln;
    dc = dn;
  }
}

// The partial sums y[0 .. R) of the R columns of a column group meet across
// its G row groups (neighbouring lanes): level lv halves the columns a lane
// keeps while there are two or more, then adds whole sums.  The lane ends
// with y[0] of the column whose local index reduce_col gives.
template <int K>
__device__ __forceinline__ void reduce_cols(float (&y)[Tile<K>::R], int rg) {
  using TL = Tile<K>;
  constexpr int R = TL::R;
#pragma unroll
  for (int lv = 0; (1 << lv) < TL::G; ++lv) {
    const int o = 1 << lv;
    const int half = (R >> lv) / 2;
    if (half >= 1) {
      const bool up = (rg >> lv) & 1;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = up ? y[j] : y[j + half];
        const float keep = up ? y[j + half] : y[j];
        y[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      y[0] += __shfl_xor_sync(0xffffffffu, y[0], o);
    }
  }
}

template <int K>
__device__ __forceinline__ int reduce_col(int rg) {
  constexpr int R = Tile<K>::R;
  int lc = 0;
#pragma unroll
  for (int lv = 0; (R >> (lv + 1)) >= 1; ++lv)
    lc += ((rg >> lv) & 1) * (R >> (lv + 1));
  return lc;
}

// The walk of chunk c of (b, h) = bh from S_c (0 for c = 0, else
// part[(bh * (nc - 1) + c - 1) * K * K]); y of its steps, and for the last
// chunk the final state s_out[bh] (K x K).  Its stages run in a ring of
// two: the next one's copies fly while this one is walked.  (Walking two
// steps at a time, S <- (w_1 w_0) S + (w_1 k_0) v_0^T + k_1 v_1^T, takes
// five operations per entry where two steps take six, but ran slower in a
// development build: more live registers.)
template <typename T, int K>
__device__ __forceinline__ void walk(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    T* __restrict__ y, float* __restrict__ s_out, float* part, int Tn, int H,
    int C, int nc, int bh, int c, unsigned char* smem) {
  using TL = Tile<K>;
  using RS = Raw<T, K>;
  constexpr int R = TL::R;
  constexpr int LOG_R = R == 8 ? 3 : (R == 4 ? 2 : 1);
  float* ys = reinterpret_cast<float*>(smem + 2 * RS::bytes);   // [TS][K]
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int rg = tid % TL::G, cg = tid / TL::G;
  const size_t step = (size_t)H * K;
  const size_t base = ((size_t)b * Tn * H + h) * K;
  const int n = min(C, Tn - c * C), n_sub = (n + TS - 1) / TS;
  auto issue = [&](int i) {   // stage i: steps [i * TS, ..) of the chunk
    const RS raw(smem + (i & 1) * RS::bytes);
    const int t0 = c * C + i * TS, m = min(TS, n - i * TS);
    fetch<T, K, TL::NT>(r, base, step, t0, m, raw.r);
    fetch<T, K, TL::NT>(k, base, step, t0, m, raw.k);
    fetch<T, K, TL::NT>(v, base, step, t0, m, raw.v);
    fetch<float, K, TL::NT>(w, base, step, t0, m, raw.w);
  };
  issue(0);
  cp_async_commit();

  float S[R][R], uu[R];
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) S[i][j] = 0.f;
  } else {
    move_tile<K, false>(part + ((size_t)bh * (nc - 1) + c - 1) * K * K, rg,
                        cg, S);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) uu[i] = u[h * K + TL::at(rg, i)];
  const int col = TL::at(cg, reduce_col<K>(rg));   // the y this lane keeps
  const bool owner = (rg >> LOG_R) == 0;

  for (int i = 0; i < n_sub; ++i) {
    if (i + 1 < n_sub) issue(i + 1);   // its ring slot was walked before
    cp_async_commit();
    cp_async_wait<1>();   // stage i is in
    __syncthreads();
    const RS raw(smem + (i & 1) * RS::bytes);
    const int m = min(TS, n - i * TS), t0 = c * C + i * TS;
#pragma unroll 2
    for (int s = 0; s < m; ++s) {
      float rr[R], kk[R], ww[R], vv[R], yv[R];
      read_tile<K>(raw.r + s * K, rg, rr);
      read_tile<K>(raw.k + s * K, rg, kk);
      read_tile<K>(raw.w + s * K, rg, ww);
      read_tile<K>(raw.v + s * K, cg, vv);
      float ruk = 0.f;
#pragma unroll
      for (int a = 0; a < R; ++a) ruk = fmaf(rr[a] * uu[a], kk[a], ruk);
#pragma unroll
      for (int j = 0; j < R; ++j) yv[j] = 0.f;
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          yv[j] = fmaf(rr[a], S[a][j], yv[j]);
          S[a][j] = fmaf(ww[a], S[a][j], kk[a] * vv[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) yv[j] = fmaf(ruk, vv[j], yv[j]);
      reduce_cols<K>(yv, rg);
      if (owner) ys[s * K + col] = yv[0];
    }
    __syncthreads();
    constexpr int PV = 16 / (int)sizeof(T);
    for (int e = tid; e < m * K / PV; e += TL::NT) {
      const int st = e / (K / PV), j = (e % (K / PV)) * PV;
      Vec<T, PV> t;
#pragma unroll
      for (int q = 0; q < PV; ++q) t.x[q] = from_f<T>(ys[st * K + j + q]);
      *reinterpret_cast<Vec<T, PV>*>(y + base + (size_t)(t0 + st) * step +
                                     j) = t;
    }
  }
  if (c == nc - 1)
    move_tile<K, true>(s_out + (size_t)bh * K * K, rg, cg, S);
  else if (c == 0)   // S_1, where the later chunks' carries start
    move_tile<K, true>(part + (size_t)bh * (nc - 1) * K * K, rg, cg, S);
}

// Blocks [0, walks * BH) walk chunk c0 + x / BH of (b, h) = x % BH; block
// walks * BH + x finds the own state of chunk 1 + x / BH of x % BH.  The
// first launch walks chunk 0, which needs no carried state and leaves S_1
// where the carry starts, beside the chunk states: the walks come first,
// as they are the longest, and the others, which mostly wait on memory,
// share the SMs with them.  The last launch walks the later chunks.  One
// kernel for both, so the walk is compiled once.
template <typename T, int K>
__global__ void __launch_bounds__(Tile<K>::NT)
wkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, T* __restrict__ y,
                 float* __restrict__ s_out, float* __restrict__ part,
                 float* __restrict__ part_d, int Tn, int H, int C, int nc,
                 int bhs, int c0, int walks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int x = blockIdx.x;
  if (x < walks * bhs) {
    walk<T, K>(r, k, v, w, u, y, s_out, part, Tn, H, C, nc, x % bhs,
               c0 + x / bhs, smem);
  } else {
    const int z = x - walks * bhs;
    chunk_state<T, K>(k, v, w, part, part_d, Tn, H, C, nc, z % bhs,
                      1 + z / bhs, smem);
  }
}

// Dynamic shared memory above the default 48 KB needs the attribute.
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, void* y, float* s, float* part, int B, int Tn,
           int H, int C, cudaStream_t stream) {
  using TL = Tile<K>;
  // the raw ring, then a chunk state's fp32 k and v (a walk's y in the
  // first of them)
  constexpr int SMEM = 2 * Raw<T, K>::bytes + 2 * TS * K * (int)sizeof(float);
  const int nc = (Tn + C - 1) / C, bh = B * H;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  float* part_d = part + (size_t)bh * (nc - 1) * K * K;
  cudaError_t e = allow_smem(wkv_chunk_kernel<T, K>, SMEM);
  if (e != cudaSuccess) return (int)e;
  T* yt = static_cast<T*>(y);
  if (nc > 1) {   // chunk 0's walk and the later chunks' own states
    wkv_chunk_kernel<T, K><<<bh * (nc - 1), TL::NT, SMEM, stream>>>(
        rt, kt, vt, w, u, yt, s, part, part_d, Tn, H, C, nc, bh, 0, 1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (nc > 2) {
      const dim3 grid(bh, (K * K / 4 + CARRY_THREADS - 1) / CARRY_THREADS);
      wkv_carry_kernel<K><<<grid, CARRY_THREADS, 0, stream>>>(part, part_d,
                                                              nc - 1);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  const int c0 = nc > 1 ? 1 : 0;   // the walks left
  wkv_chunk_kernel<T, K><<<bh * (nc - c0), TL::NT, SMEM, stream>>>(
      rt, kt, vt, w, u, yt, s, part, part_d, Tn, H, C, nc, bh, c0, nc - c0);
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(const void* r, const void* k, const void* v, const float* w,
                const float* u, void* y, float* s, float* part, int B,
                int Tn, int H, int K, int C, cudaStream_t st) {
  switch (K) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, y, s, part, B, Tn, H, C, st);
    case 32:
      return launch<T, 32>(r, k, v, w, u, y, s, part, B, Tn, H, C, st);
    case 64:
      return launch<T, 64>(r, k, v, w, u, y, s, part, B, Tn, H, C, st);
    case 128:
      return launch<T, 128>(r, k, v, w, u, y, s, part, B, Tn, H, C, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, y (B, T, H, K) fp32 or bf16 (bf16 != 0), w (B, T, H, K) fp32,
// u (H, K) fp32, s (B, H, K, K) fp32; contiguous, 16-byte aligned, on the
// current device; K in {16, 32, 64, 128}, T >= 1.  The steps run in
// nc = ceil(T / chunk) chunks of `chunk` steps, a multiple of 16; above one
// chunk, part is fp32 scratch of B * H * (nc - 1) * (K * K + K) floats
// (ops.py::wkv_chunk): the states between the chunks, then their decays.
// Launches on `stream` and returns cudaGetLastError() (0 on success); no
// sync.
extern "C" int wkv_fwd(const void* r, const void* k, const void* v,
                       const float* w, const float* u, void* y, float* s,
                       float* part, int B, int T, int H, int K, int chunk,
                       int bf16, void* stream) {
  if (chunk < TS || chunk % TS || T < 1) return (int)cudaErrorInvalidValue;
  if (T > chunk && !part) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? by_head_dim<__nv_bfloat16>(r, k, v, w, u, y, s, part, B, T,
                                           H, K, chunk, st)
              : by_head_dim<float>(r, k, v, w, u, y, s, part, B, T, H, K,
                                   chunk, st);
}
