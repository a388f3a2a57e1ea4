// Flash-decode attention over the ring KV cache and the block pool, sm_90a.
//
// Replaces the TPU kernels of src/repro/kernels/decode_attention/
// decode_attention.py: _decode_kernel (ring cache, _decode_impl) and
// _decode_kernel_table (block-table pool, _decode_impl_table), wrapper
// decode_attention_pallas.  One query token per row: q (B, Hkv, G, hd), the
// G query heads of a KV head together; K/V either a ring (B, cap, Hkv, hd)
// or a pool (NB, bs, Hkv, hd) indirected by a (B, cap / bs) block table;
// per-row pos (B,) int32; an optional window; fp32, bf16 or int8 K/V (int8
// with fp32 (.., Hkv) scales per slot).  fp32 online softmax, out
// (B, Hkv, G, hd) in q's type.  Both entry points run one templated body.
//
// What bounds it on the H100: bytes.  Each valid slot costs 4 * hd FLOPs
// per query head against 2 * hd elements of K and V read once, so at G <= 8
// the least time is the visible K/V (plus scales, q and o) over 3.35 TB/s.
//
// What the design does about it:
//  * A block owns one (row, KV head) (and one chunk of 8 query heads when
//    G > 8): q of all G heads sits in registers and every K/V row is read
//    once for the whole group.
//  * Split-KV, ring and table alike: one block per (row, KV head) is 128
//    blocks for 132 SMs at the serving shape, and rows are ragged (101 to
//    2,048 visible slots), so most SMs would idle while a few stream a
//    whole row.  Each row's slots are dealt out in chunks of `chunk` slots
//    over n_split blocks; the wrapper's rule (decode_attention/ops.py::
//    decode_chunk, no device sync) picks chunks of unit * 2^j slots (unit:
//    bs for the table, so a chunk's block ids are one run of the table;
//    the warps' step for the ring, so a chunk is whole steps) that give
//    about four blocks per SM.  A block whose chunk starts past the row's
//    visible slots exits at once.  Each block writes its fp32 partial
//    (m, l, acc[hd]) and a second kernel, decode_merge, folds the partials
//    of the splits that hold visible slots in split order, so two calls
//    agree bit for bit.  The merge is a second launch and not the last
//    block of each row behind a counter: a development build of that (a
//    module-wide counter array that the last block resets) was a few
//    percent faster at the serving shape and slower with int8 K/V, and its
//    counters would race between two calls on two streams.  With
//    n_split = 1 the block writes o itself.
//  * The valid slots of a row are one arc of the ring: the nv slots ending
//    at the one p was written to, pm = p mod cap, which hold positions
//    p, p - 1, .., p - nv + 1 (nv = min(p + 1, cap, window)).  A block cuts
//    its chunk to the part the arc covers, so with a window most chunks of
//    a wrapped ring are empty: such a block writes an empty partial
//    (m = NEG, l = 0) without touching the cache, since the merge reads
//    every split below the visible slots.  A visited slot c is valid iff
//    (pm - c) mod cap < nv, one compare and no division: the reference's
//    test (position >= 0, inside the window) on slot_positions' floor mod.
//    A slot that fails it reads no bytes and adds nothing, as the
//    reference's masked entries add exp(NEG - m) = 0 once a real score is
//    seen.  m starts at the reference's finite NEG = -1e30, so a warp or
//    a split that saw no valid slot merges with weight exp(NEG - M) = 0.
//  * The cache is read in place with strides, (row * Hkv + h) * hd, in the
//    model's layout: no fold or transpose of the cache, no padding of cap.
//  * Warps stride over the slots, a few slots per warp per step (about
//    2 KB of K and V) with all their loads issued before any use, so
//    bytes in flight hide the latency; each lane holds hd / 32 consecutive
//    elements of a row (one vector load, kept packed until used), q.k is a
//    warp reduction of xor-shuffles, and each warp keeps its own online
//    softmax (m, l, acc) in registers.  The warps merge in shared memory
//    at the end.
//  * int8 dequantizes in the score domain: s *= ks[c] and p *= vs[c], as
//    the reference does; no cache tile is dequantized.
//  * Table mode: slot c of row b lives at pool[table[b, c / bs], c % bs];
//    the block stages its chunk's block ids in shared memory first, so no
//    load of K or V waits on a load of the table.  Retired rows point at
//    block 0 (the trash block), which no live row reads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float NEG = -1e30f;   // the reference's finite mask sentinel
constexpr int MERGE_THREADS = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// E consecutive elements of T, read as one vector load.
template <typename T, int E>
struct alignas(sizeof(T) * E) Pack {
  T x[E];
};

template <typename T, int E>
__device__ __forceinline__ Pack<T, E> load_pack(const T* __restrict__ src) {
  return *reinterpret_cast<const Pack<T, E>*>(src);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's shape.  warps: 16 hide more load latency; once q and the
// accumulator take 32 registers each per thread (GT * hd / 32), 8 keep
// them out of local memory.  unroll: slots per warp per step, about 2 KB of
// K and V (the step's loads are all issued before any is used), at most 32
// scores per thread, between 2 and 16.  The table kernel runs the same
// shape: at the serving shape on the H100, blocks of 8 warps, steps of
// 4 KB, and the next step's loads issued before this step's reductions
// were each slower (development builds timed by kernel_sweep.py).
template <typename TKV, int HD, int GT>
struct Shape {
  static constexpr int warps = GT * HD / 32 >= 32 ? 8 : 16;
  static constexpr int threads = 32 * warps;
  static constexpr int by_bytes = 2048 / (2 * HD * (int)sizeof(TKV));
  static constexpr int u = by_bytes < 32 / GT ? by_bytes : 32 / GT;
  static constexpr int unroll = u < 2 ? 2 : (u > 16 ? 16 : u);
};

// Slots of a row at position p that can hold a position: c <= p until the
// ring has wrapped.
__device__ __forceinline__ int visible(int p, int cap) {
  return p < cap ? p + 1 : cap;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* pos;
  const int* table;
  void* o;
  float* part;
  int B, n_kv_heads, G, cap, bs, n_k, window;
  float scale;
  int chunk, n_split;
  cudaStream_t stream;
};

// Block (bh * n_split + z, y): row b, KV head h, query heads y * GT ..,
// the valid slots of [z * chunk, (z + 1) * chunk).  With n_split = 1 it
// writes o; else its partial: m and l at
// part_ml[((bh * n_split + z) * G + g) * 2 + {0, 1}], acc at
// part_acc[((bh * n_split + z) * G + g) * HD + d].
template <typename TQ, typename TKV, int HD, int GT, bool TABLE>
__global__ void __launch_bounds__(Shape<TKV, HD, GT>::threads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ pos,
              const int* __restrict__ table, TQ* __restrict__ o,
              float* __restrict__ part_acc, float* __restrict__ part_ml,
              int G, int n_kv_heads, int cap, int bs, int n_k, int window,
              float scale, int chunk, int n_split) {
  constexpr int E = HD / 32;
  constexpr int WARPS = Shape<TKV, HD, GT>::warps;
  constexpr int THREADS = Shape<TKV, HD, GT>::threads;
  constexpr int U = Shape<TKV, HD, GT>::unroll;
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  extern __shared__ float smem[];
  float* sm_m = smem;                   // WARPS x GT
  float* sm_l = sm_m + WARPS * GT;      // WARPS x GT
  float* sm_acc = sm_l + WARPS * GT;    // WARPS x GT x HD
  int* sm_tab = reinterpret_cast<int*>(sm_acc + WARPS * GT * HD);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bh = blockIdx.x / n_split;   // b * Hkv + h
  const int z = blockIdx.x % n_split;
  const int b = bh / n_kv_heads, h = bh % n_kv_heads;
  const int g0 = blockIdx.y * GT;
  const int ng = min(GT, G - g0);
  const int p = pos[b];
  int lo = z * chunk;
  // decode_merge reads only the splits that hold visible slots
  if (n_split > 1 && lo >= visible(p, cap)) return;
  int hi = min(cap, lo + chunk);
  // the arc of valid slots: [first, pm] when first >= 0, else
  // [0, pm] and [first + cap, cap)
  const int pm = p % cap;
  const int nv = min(min(p + 1, cap), window > 0 ? window : cap);
  const int first = pm - nv + 1;
  if (nv <= 0) {
    hi = lo;
  } else if (first >= 0) {
    lo = max(lo, first);
    hi = min(hi, pm + 1);
  } else {
    if (lo > pm) lo = max(lo, first + cap);
    if (hi <= first + cap) hi = min(hi, pm + 1);
  }
  if (n_split > 1 && lo >= hi) {   // no valid slot: the empty partial
    for (int i = threadIdx.x; i < ng * HD; i += THREADS) {
      const size_t pg = ((size_t)bh * n_split + z) * G + g0 + i / HD;
      part_acc[pg * HD + i % HD] = 0.f;
      if (i % HD == 0) {
        part_ml[2 * pg] = NEG;
        part_ml[2 * pg + 1] = 0.f;
      }
    }
    return;
  }
  int t0 = 0;
  if constexpr (TABLE) {
    // the chunk's block ids, so a slot's address costs no dependent load
    t0 = lo / bs;
    const int n_t = lo < hi ? (hi - 1) / bs - t0 + 1 : 0;
    for (int i = threadIdx.x; i < n_t; i += THREADS)
      sm_tab[i] = table[(size_t)b * n_k + t0 + i];
    __syncthreads();
  }

  float qr[GT][E], m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < ng) {
      const Pack<TQ, E> qp = load_pack<TQ, E>(
          q + ((size_t)bh * G + g0 + g) * HD + lane * E);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = to_f(qp.x[e]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = 0.f;
    }
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int c0 = lo + warp * U; c0 < hi; c0 += WARPS * U) {
    bool ok[U];
    Pack<TKV, E> kp[U], vp[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      ok[u] = c < hi && pm - c + (c > pm ? cap : 0) < nv;
      ksc[u] = vsc[u] = 1.f;
      if (ok[u]) {
        size_t row;
        if constexpr (TABLE)
          row = (size_t)sm_tab[c / bs - t0] * bs + c % bs;
        else
          row = (size_t)b * cap + c;
        const size_t off = (row * n_kv_heads + h) * HD + lane * E;
        kp[u] = load_pack<TKV, E>(k + off);
        vp[u] = load_pack<TKV, E>(v + off);
        if constexpr (QUANT) {
          ksc[u] = ks[row * n_kv_heads + h];
          vsc[u] = vs[row * n_kv_heads + h];
        }
      }
    }

    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], to_f(kp[u].x[e]), d);
        s[u][g] = warp_sum(d) * scale * ksc[u];
      }
    }

#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        const float pe = expf(s[u][g] - mx);
        l[g] += pe;
        const float pv = pe * vsc[u];
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = fmaf(pv, to_f(vp[u].x[e]), acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // merge the warps' softmax states
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      sm_m[warp * GT + g] = m[g];
      sm_l[warp * GT + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      sm_acc[(warp * GT + g) * HD + lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w * GT + g]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_m[w * GT + g] - mx);
      lsum = fmaf(sm_l[w * GT + g], f, lsum);
      osum = fmaf(sm_acc[(w * GT + g) * HD + d], f, osum);
    }
    if (n_split == 1) {
      o[((size_t)bh * G + g0 + g) * HD + d] =
          from_f<TQ>(osum / fmaxf(lsum, 1e-30f));
    } else {
      const size_t pg = ((size_t)bh * n_split + z) * G + g0 + g;
      part_acc[pg * HD + d] = osum;
      if (d == 0) {
        part_ml[2 * pg] = mx;
        part_ml[2 * pg + 1] = lsum;
      }
    }
  }
}

// o of row b, KV head h (block bh) from the partials of the splits that
// hold visible slots, folded in split order.
template <typename TQ>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_merge(const float* __restrict__ part_acc,
             const float* __restrict__ part_ml, const int* __restrict__ pos,
             TQ* __restrict__ o, int n_kv_heads, int G, int hd, int cap,
             int chunk, int n_split) {
  const int bh = blockIdx.x;
  const int n_used = (visible(pos[bh / n_kv_heads], cap) + chunk - 1) / chunk;
  for (int i = threadIdx.x; i < G * hd; i += MERGE_THREADS) {
    const int g = i / hd, d = i % hd;
    const size_t p0 = (size_t)bh * n_split * G + g;   // split 0's (row, g)
    float mx = NEG;
    for (int z = 0; z < n_used; ++z)
      mx = fmaxf(mx, part_ml[2 * (p0 + (size_t)z * G)]);
    float lsum = 0.f, osum = 0.f;
    for (int z = 0; z < n_used; ++z) {
      const size_t pz = p0 + (size_t)z * G;
      const float f = expf(part_ml[2 * pz] - mx);
      lsum = fmaf(part_ml[2 * pz + 1], f, lsum);
      osum = fmaf(part_acc[pz * hd + d], f, osum);
    }
    o[((size_t)bh * G + g) * hd + d] = from_f<TQ>(osum / fmaxf(lsum, 1e-30f));
  }
}

template <typename TQ, typename TKV, int HD, int GT, bool TABLE>
int run(const Args& a) {
  using S = Shape<TKV, HD, GT>;
  const int n_tab = TABLE ? (a.chunk + a.bs - 1) / a.bs + 1 : 0;
  const size_t smem =
      sizeof(float) * S::warps * GT * (HD + 2) + sizeof(int) * n_tab;
  auto kernel = decode_kernel<TQ, TKV, HD, GT, TABLE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = a.B * a.n_kv_heads;
  float* part_acc = a.part;
  float* part_ml =
      a.part ? a.part + (size_t)rows * a.n_split * a.G * HD : nullptr;
  const dim3 grid(rows * a.n_split, (a.G + GT - 1) / GT);
  kernel<<<grid, S::threads, smem, a.stream>>>(
      (const TQ*)a.q, (const TKV*)a.k, (const TKV*)a.v, a.ks, a.vs, a.pos,
      a.table, (TQ*)a.o, part_acc, part_ml, a.G, a.n_kv_heads, a.cap, a.bs,
      a.n_k, a.window, a.scale, a.chunk, a.n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  decode_merge<TQ><<<rows, MERGE_THREADS, 0, a.stream>>>(
      part_acc, part_ml, a.pos, (TQ*)a.o, a.n_kv_heads, a.G, HD, a.cap,
      a.chunk, a.n_split);
  return (int)cudaGetLastError();
}

// GT = the query heads a block holds: the group size rounded up to 1, 2, 4
// or 8; larger groups take several blocks of 8.
template <typename TQ, typename TKV, int HD, bool TABLE>
int by_group(const Args& a) {
  if (a.G <= 1) return run<TQ, TKV, HD, 1, TABLE>(a);
  if (a.G <= 2) return run<TQ, TKV, HD, 2, TABLE>(a);
  if (a.G <= 4) return run<TQ, TKV, HD, 4, TABLE>(a);
  return run<TQ, TKV, HD, 8, TABLE>(a);
}

template <typename TQ, typename TKV, bool TABLE>
int by_head_dim(const Args& a, int hd) {
  switch (hd) {
    case 64:
      return by_group<TQ, TKV, 64, TABLE>(a);
    case 128:
      return by_group<TQ, TKV, 128, TABLE>(a);
    case 256:
      return by_group<TQ, TKV, 256, TABLE>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q_type: 0 fp32, 1 bf16; kv_type: 0 fp32, 1 bf16, 2 int8.
template <bool TABLE>
int dispatch(const Args& a, int hd, int q_type, int kv_type) {
  if (q_type == 0) {
    if (kv_type == 0) return by_head_dim<float, float, TABLE>(a, hd);
    if (kv_type == 1) return by_head_dim<float, __nv_bfloat16, TABLE>(a, hd);
    if (kv_type == 2) return by_head_dim<float, int8_t, TABLE>(a, hd);
  } else if (q_type == 1) {
    if (kv_type == 0) return by_head_dim<__nv_bfloat16, float, TABLE>(a, hd);
    if (kv_type == 1)
      return by_head_dim<__nv_bfloat16, __nv_bfloat16, TABLE>(a, hd);
    if (kv_type == 2) return by_head_dim<__nv_bfloat16, int8_t, TABLE>(a, hd);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// o (B, Hkv, G, hd) in q's type for q (B, Hkv, G, hd) against the ring
// k, v (B, cap, Hkv, hd) at positions pos (B,) int32; ks, vs (B, cap, Hkv)
// fp32 for an int8 cache, else null.  All contiguous; hd is 64, 128 or 256;
// window <= 0 means none.  The slots are dealt out in
// n_split = ceil(cap / chunk) chunks of `chunk` slots; above one split,
// part is fp32 scratch of B * Hkv * n_split * G * (hd + 2) floats
// (ops.py::decode_chunk).  Launches on `stream`; returns the launch's
// cudaError_t (0 on success); no sync.
extern "C" int decode_ring(const void* q, const void* k, const void* v,
                           const float* ks, const float* vs, const int* pos,
                           void* o, float* part, int B, int n_kv_heads,
                           int G, int cap, int hd, int window, float scale,
                           int chunk, int q_type, int kv_type,
                           void* stream) {
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int n_split = (cap + chunk - 1) / chunk;
  if (n_split > 1 && !part) return (int)cudaErrorInvalidValue;
  const Args a{q,     k,       v,     ks,  vs, pos, nullptr, o,     part,
               B,     n_kv_heads, G,  cap, 1,  0,   window,  scale,
               chunk, n_split, (cudaStream_t)stream};
  return dispatch<false>(a, hd, q_type, kv_type);
}

// The same against the pool k, v (NB, bs, Hkv, hd) (ks, vs (NB, bs, Hkv))
// through the block table (B, n_k) int32: the ring has cap = n_k * bs slots
// and row b's slot c lives at pool[table[b, c / bs], c % bs].  The slots
// are dealt out in n_split = ceil(cap / chunk) chunks of `chunk` slots, a
// multiple of bs; above one split, part is fp32 scratch of
// B * Hkv * n_split * G * (hd + 2) floats (ops.py::decode_chunk).
extern "C" int decode_table(const void* q, const void* k, const void* v,
                            const float* ks, const float* vs, const int* pos,
                            const int* table, void* o, float* part, int B,
                            int n_kv_heads, int G, int n_k, int bs, int hd,
                            int window, float scale, int chunk, int q_type,
                            int kv_type, void* stream) {
  const int cap = n_k * bs;
  if (bs < 1 || chunk < bs || chunk % bs) return (int)cudaErrorInvalidValue;
  const int n_split = (cap + chunk - 1) / chunk;
  if (n_split > 1 && !part) return (int)cudaErrorInvalidValue;
  const Args a{q,     k,       v,     ks,  vs, pos, table,  o,     part,
               B,     n_kv_heads, G,  cap, bs, n_k, window, scale,
               chunk, n_split, (cudaStream_t)stream};
  return dispatch<true>(a, hd, q_type, kv_type);
}
