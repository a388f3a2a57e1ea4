// The RG-LRU diagonal linear recurrence from a zero state, fp32, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/rglru/rglru.py, _rglru_kernel
// (wrapper rglru_pallas):  h_t = a_t h_{t-1} + b_t per channel, the
// semantics of ref.rglru_sequential (kernels/rglru/ref.py).  With a
// reversed mode it computes the recurrence's transpose, the backward the
// reference runs through the same kernel on flipped, one-step-shifted
// coefficients (rglru.py:98-111):  g_t = b_t + a_{t+1} g_{t+1}, g_{T-1} =
// b_{T-1}, reading a and b in place (a one step later; no flip, no shift in
// memory, no concatenation).  Given h as well, the reversed launch also
// writes the backward's da_t = g_t h_{t-1} (h_{-1} = 0) in the same pass,
// ref.rglru_transpose_grads.
//
// What bounds it on the H100: bytes.  One FMA per element against 12
// bytes moved forward (a and b read, h written, fp32) and 20 reversed with
// da (a, b, h read, g and da written): at B 2, T 2048, D 4096, 201 MB and
// 336 MB, so the least times are 0.0601 and 0.1002 ms at 3.35 TB/s.  A
// walk of T steps by one thread per (b, channel) is bound instead by
// latency: 8,192 threads are 2 warps an SM, too few loads in flight, and
// every run of steps costs a memory round trip.
//
// What the design does about it: it runs in parallel over T as well.  A
// block owns a tile of TILE = 32 channels of one batch row and a chunk of C
// steps (ops.py::rglru_chunk, a pure rule, picks C).  Its 256 threads sit
// in R rows of TILE / VEC threads: a thread owns VEC neighbouring channels
// (16-byte loads and stores where D % 4 == 0, else one) and one sub-chunk
// of S = C / R steps, so each warp load is whole 128-byte rows.  Single
// pass, in three stages:
//  1. a thread loads its S steps of a and b into registers (all of them in
//     flight together) and walks them from zero, keeping the end state E
//     and the product P of its coefficients;
//  2. one warp, a lane a channel, waits for the state that enters the
//     chunk (the end of the chunk before it in walk order, published by
//     that chunk's block), then folds the rows' (P, E) in walk order,
//     state = P state + E, leaving each row's entering state in shared
//     memory, and publishes the chunk's end state for the next chunk;
//  3. each thread walks its sub-chunk again from its entering state, as
//     the sequential loop does (fmaf(a, h, b)), and writes h (or g and
//     da) once.
//  The chain between chunks is fixed-order: a block waits only on its one
//  predecessor's end state and folds it in one order, so two calls agree
//  bit for bit (no look-back over a varying number of predecessors).
//  Blocks take their (tile, chunk) from an atomic ticket, chunk-major in
//  walk order, so a waiting block's predecessor has always started before
//  it: nothing can deadlock, and a tile's predecessor ran a wave earlier.
//  The flag wait is an acquire load by one lane; the publish is the lanes'
//  stores, a warp barrier, a release fence and a relaxed store of the flag
//  (CUTLASS's barrier pattern).  The wrapper allocates the ticket and the
//  flags zeroed, and the carried states, per call: two calls on two
//  streams share nothing.  No log is taken and no chunk-wide product is
//  formed (the fold multiplies a state by one sub-chunk's product at a
//  time), so any a works: a = 0, strong decay (P underflows to 0) and
//  a > 1 stay finite wherever the sequential loop does.  Any T and D: the
//  last chunk and the last tile are masked, no padding in memory.
//
// At B 2, T 2048, D 4096 with 256-step chunks (8 chunks of 256 tiles,
// 2,048 blocks, two an SM at 103-109 registers): 0.079 ms forward (76 %
// of its bound, 2.56 TB/s) and 0.125 ms reversed with da (80 %), H100
// 80GB HBM3 at 700 W (chip_smoke.py's recurrence phase).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 32;          // channels per block

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void release_flag(int* p) {
  asm volatile("fence.acq_rel.gpu;\n\tst.relaxed.gpu.b32 [%0], %1;"
               :: "l"(p), "r"(1) : "memory");
}

// A predecessor that never publishes is a fault of the kernel: trap, so
// that the launch fails, rather than hang the card.
__device__ __forceinline__ void wait_flag(const int* p) {
  unsigned n = 0;
  while (ld_acquire(p) == 0) {
    __nanosleep(64);
    if (++n == (1u << 24)) __trap();
  }
}

template <int VEC>
__device__ __forceinline__ void load(float (&v)[VEC], const float* p,
                                     bool ok) {
  if constexpr (VEC == 4) {
    const float4 q = ok ? __ldcs(reinterpret_cast<const float4*>(p))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = ok ? __ldcs(p) : 0.f;
  }
}

// An async copy of VEC floats into shared memory, zeros where !ok.
template <int VEC>
__device__ __forceinline__ void copy_async(float* smem, const float* p,
                                           bool ok) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(p), "r"(ok ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(dst), "l"(p), "r"(ok ? 4 : 0) : "memory");
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// MODE 0: forward h.  MODE 1: reversed g.  MODE 2: reversed g and da.
// sync: [0] the ticket, [1 + tile * n_chunks + chunk] the flags (zeroed);
// carry: n_tiles * n_chunks * TILE end states.
template <int VEC, int S, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ hf, float* __restrict__ out,
                  float* __restrict__ da, float* __restrict__ carry,
                  int* __restrict__ sync, int T, int D, int tiles_per_row,
                  int n_tiles, int n_chunks) {
  constexpr int TPR = TILE / VEC;   // threads per row
  constexpr int R = THREADS / TPR;  // rows: sub-chunks of a chunk
  constexpr int C = R * S;
  constexpr bool REV = MODE != 0;
  __shared__ __align__(16) float s_p[R][TILE];
  __shared__ __align__(16) float s_e[R][TILE];
  // MODE 2: h_{t-1} of this thread's steps, staged by cp.async (registers
  // hold a and b; a third set would spill)
  __shared__ __align__(16) float s_h[MODE == 2 ? S : 1][THREADS * VEC];
  __shared__ int s_ticket;

  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int rank = ticket / n_tiles;          // place in the walk order
  const int tile = ticket - rank * n_tiles;
  const int chunk = REV ? n_chunks - 1 - rank : rank;
  const int row = tile / tiles_per_row;
  const int q = tid % TPR, r = tid / TPR;
  const int d = (tile - row * tiles_per_row) * TILE + q * VEC;
  const bool col = d < D;                    // VEC divides D
  const int t0 = chunk * C + r * S;
  const size_t base = (size_t)row * T * D + d;

  // 1. this thread's steps, in flight together; its walk from zero
  float av[S][VEC], bv[S][VEC];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int t = t0 + s;
    const int ta = REV ? t + 1 : t;          // g_t takes a_{t+1}
    load<VEC>(av[s], a + base + (size_t)ta * D, col && ta < T);
    load<VEC>(bv[s], b + base + (size_t)t * D, col && t < T);
  }
  if constexpr (MODE == 2) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int t = t0 + s;
      const bool ok = col && t >= 1 && t < T;
      copy_async<VEC>(&s_h[s][tid * VEC],
                      ok ? hf + base + (size_t)(t - 1) * D : hf, ok);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  float p[VEC], e[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    p[v] = 1.f;
    e[v] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int s = REV ? S - 1 - i : i;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      p[v] *= av[s][v];
      e[v] = fmaf(av[s][v], e[v], bv[s][v]);
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    s_p[r][q * VEC + v] = p[v];
    s_e[r][q * VEC + v] = e[v];
  }
  __syncthreads();

  // 2. the chain and the fold: one warp, a lane per channel
  if (tid < TILE) {
    const size_t link = (size_t)tile * n_chunks;
    float state = 0.f;
    if (rank > 0) {
      const int prev = REV ? chunk + 1 : chunk - 1;
      if (tid == 0) wait_flag(sync + 1 + link + prev);
      __syncwarp();
      state = __ldcg(carry + (link + prev) * TILE + tid);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int rr = REV ? R - 1 - i : i;
      const float pp = s_p[rr][tid], ee = s_e[rr][tid];
      s_e[rr][tid] = state;                  // the row's entering state
      state = fmaf(pp, state, ee);
    }
    if (rank < n_chunks - 1) {
      __stcg(carry + (link + chunk) * TILE + tid, state);
      __syncwarp();
      if (tid == 0) release_flag(sync + 1 + link + chunk);
    }
  }
  __syncthreads();

  // 3. the walk again from the entering state, writing once
  if constexpr (MODE == 2) asm volatile("cp.async.wait_all;" ::: "memory");
  float h[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) h[v] = s_e[r][q * VEC + v];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int s = REV ? S - 1 - i : i;
    const int t = t0 + s;
#pragma unroll
    for (int v = 0; v < VEC; ++v) h[v] = fmaf(av[s][v], h[v], bv[s][v]);
    if (col && t < T) {
      store<VEC>(out + base + (size_t)t * D, h);
      if constexpr (MODE == 2) {
        float g[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) g[v] = h[v] * s_h[s][tid * VEC + v];
        store<VEC>(da + base + (size_t)t * D, g);
      }
    }
  }
}

template <int VEC, int S, int MODE>
int launch(const float* a, const float* b, const float* h, float* out,
           float* da, float* carry, int* sync, int B, int T, int D,
           cudaStream_t stream) {
  constexpr int R = THREADS / (TILE / VEC);
  const int tiles_per_row = (D + TILE - 1) / TILE;
  const int n_tiles = B * tiles_per_row;
  const int n_chunks = (T + R * S - 1) / (R * S);
  rglru_scan_kernel<VEC, S, MODE><<<n_tiles * n_chunks, THREADS, 0,
                                    stream>>>(
      a, b, h, out, da, carry, sync, T, D, tiles_per_row, n_tiles, n_chunks);
  return (int)cudaGetLastError();
}

template <int VEC, int MODE>
int by_chunk(int chunk, const float* a, const float* b, const float* h,
             float* out, float* da, float* carry, int* sync, int B, int T,
             int D, cudaStream_t stream) {
  constexpr int R = THREADS / (TILE / VEC);
  switch (chunk) {
    case 64:
      return launch<VEC, 64 / R, MODE>(a, b, h, out, da, carry, sync, B, T,
                                       D, stream);
    case 128:
      return launch<VEC, 128 / R, MODE>(a, b, h, out, da, carry, sync, B, T,
                                        D, stream);
    case 256:
      return launch<VEC, 256 / R, MODE>(a, b, h, out, da, carry, sync, B, T,
                                        D, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int MODE>
int by_vec(int chunk, const float* a, const float* b, const float* h,
           float* out, float* da, float* carry, int* sync, int B, int T,
           int D, cudaStream_t stream) {
  const bool vec = D % 4 == 0 &&
                   ((uintptr_t)a | (uintptr_t)b | (uintptr_t)h |
                    (uintptr_t)out | (uintptr_t)da) % 16 == 0;
  return vec ? by_chunk<4, MODE>(chunk, a, b, h, out, da, carry, sync, B, T,
                                 D, stream)
             : by_chunk<1, MODE>(chunk, a, b, h, out, da, carry, sync, B, T,
                                 D, stream);
}

}  // namespace

// a, b (B, T, D) fp32, contiguous, on the current device; B * T * D below
// 2^31; chunk one of 64, 128, 256 (ops.py::RGLRU_CHUNKS).  out (B, T, D)
// gets h, or g with reverse != 0.  With reverse and h non-null, da (B, T,
// D) gets g_t h_{t-1}.  sync: 1 + n_tiles * n_chunks int32 zeros; carry:
// n_tiles * n_chunks * TILE fp32, where n_tiles = B * ceil(D / TILE) and
// n_chunks = ceil(T / chunk) (ops.py::rglru_grid).  Launches on `stream`
// and returns cudaGetLastError() (0 on success); no sync.
extern "C" int rglru_fwd(const float* a, const float* b, const float* h,
                         float* out, float* da, float* carry, int* sync,
                         int B, int T, int D, int chunk, int reverse,
                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!reverse)
    return by_vec<0>(chunk, a, b, nullptr, out, nullptr, carry, sync, B, T, D,
                     st);
  if (h == nullptr)
    return by_vec<1>(chunk, a, b, nullptr, out, nullptr, carry, sync, B, T, D,
                     st);
  return by_vec<2>(chunk, a, b, h, out, da, carry, sync, B, T, D, st);
}
