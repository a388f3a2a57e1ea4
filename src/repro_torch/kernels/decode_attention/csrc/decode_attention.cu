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
//  * Ring mode at G > 8 with bf16 q and bf16 or int8 K/V (RecurrentGemma's
//    16 query heads on one KV head): decode_mma_kernel.  The SIMT body
//    would take G in blocks of 8 heads, reading every K/V row once per
//    block, and spend a five-shuffle reduction per (slot, head).  Here one
//    block holds 16 query heads, one m16 tile of mma.sync.m16n8k16 (bf16
//    in, fp32 accumulate), so each K/V row is read once.  Q sits in
//    registers as the tile's A fragments; chunks of 32 slots of K and V
//    are staged by cp.async in a ring of 3 stages (zero-filled where a
//    slot is not valid, so P V never meets a stale non-finite value);
//    each of the 4 warps computes S = Q K^T for 8 of the slots over hd in
//    k16 steps, the warps agree on each head row's running max through
//    shared memory, and P (bf16, with v_scale folded into its columns)
//    goes back to shared memory for P V, where each warp accumulates O
//    for hd / 4 of the columns: no warp holds all of O (16 x hd fp32), and
//    since all warps share m, no merge of warps is needed.  int8 K/V are
//    exact in bf16; k_scale multiplies S's column.  The split-KV, the arc
//    cut, NEG and the fixed-order merge are those of the SIMT body.
//  * decode_merge runs one thread per output element over a 2-D grid
//    (row, element slice), so G * hd elements (4,096 at G 16, hd 256) do
//    not queue behind one block per row.
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

// Cut the chunk [lo, hi) of a row at position p to the arc of its valid
// slots: [first, pm] when first >= 0, else [0, pm] and [first + cap, cap).
// pm = p mod cap and nv = min(p + 1, cap, window) come back for the slot
// test slot_ok.
__device__ __forceinline__ void cut_to_arc(int p, int cap, int window,
                                           int& lo, int& hi, int& pm,
                                           int& nv) {
  pm = p % cap;
  nv = min(min(p + 1, cap), window > 0 ? window : cap);
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
}

// Slot c holds one of the nv positions ending at slot pm: (pm - c) mod
// cap < nv, one compare and no division.
__device__ __forceinline__ bool slot_ok(int c, int pm, int cap, int nv) {
  return pm - c + (c > pm ? cap : 0) < nv;
}

// The partial of a split with no valid slot: m = NEG, l = 0, acc = 0 for
// query heads g0 .. g0 + ng - 1.
template <int HD, int THREADS>
__device__ __forceinline__ void write_empty(float* __restrict__ part_acc,
                                            float* __restrict__ part_ml,
                                            size_t pg0, int ng) {
  for (int i = threadIdx.x; i < ng * HD; i += THREADS) {
    const size_t pg = pg0 + i / HD;
    part_acc[pg * HD + i % HD] = 0.f;
    if (i % HD == 0) {
      part_ml[2 * pg] = NEG;
      part_ml[2 * pg + 1] = 0.f;
    }
  }
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
  int pm, nv;
  cut_to_arc(p, cap, window, lo, hi, pm, nv);
  if (n_split > 1 && lo >= hi) {   // no valid slot: the empty partial
    write_empty<HD, THREADS>(part_acc, part_ml,
                             ((size_t)bh * n_split + z) * G + g0, ng);
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
      ok[u] = c < hi && slot_ok(c, pm, cap, nv);
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

// o of row b, KV head h (blocks (bh, ..)) from the partials of the splits
// that hold visible slots, folded in split order.
template <typename TQ>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_merge(const float* __restrict__ part_acc,
             const float* __restrict__ part_ml, const int* __restrict__ pos,
             TQ* __restrict__ o, int n_kv_heads, int G, int hd, int cap,
             int chunk, int n_split) {
  const int bh = blockIdx.x;
  const int n_used = (visible(pos[bh / n_kv_heads], cap) + chunk - 1) / chunk;
  for (int i = blockIdx.y * MERGE_THREADS + threadIdx.x; i < G * hd;
       i += gridDim.y * MERGE_THREADS) {
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

// ---- The ring body at G > 8 on the tensor cores (decode_mma_kernel) ----

constexpr int MMA_WARPS = 4;
constexpr int MMA_M = 16;                // query heads a block holds
constexpr int MMA_TILE = 8 * MMA_WARPS;  // slots a stage holds: n8 a warp
constexpr int MMA_STAGES = 3;

// Shared memory of decode_mma_kernel: MMA_STAGES stages of K then V
// (MMA_TILE rows each, padded by 16 bytes so the fragments' loads hit 32
// distinct banks), P (MMA_M x p_row bf16) and the warps' row maxima and
// sums (MMA_WARPS x MMA_M floats).
template <typename TKV, int HD>
struct MmaShape {
  static constexpr int row = HD * (int)sizeof(TKV) + 16;    // bytes
  static constexpr int pieces = HD * (int)sizeof(TKV) / 16;  // 16-B copies
  static constexpr int stage = 2 * MMA_TILE * row;
  static constexpr int p_row = MMA_TILE + 8;                 // bf16s
  static constexpr size_t smem = (size_t)MMA_STAGES * stage +
                                 2 * MMA_M * p_row +
                                 sizeof(float) * MMA_WARPS * MMA_M;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (lo, hi) as one bf16 pair, lo in the low half: an mma operand register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// Elements d and d + 1 of a row (bf16 or int8, which bf16 holds exactly).
__device__ __forceinline__ uint32_t row_pair(const __nv_bfloat16* r, int d) {
  return *reinterpret_cast<const uint32_t*>(r + d);
}
__device__ __forceinline__ uint32_t row_pair(const int8_t* r, int d) {
  const char2 x = *reinterpret_cast<const char2*>(r + d);
  return pack_bf16((float)x.x, (float)x.y);
}

// Element c of rows r and r + 1 (stride elements apart).
__device__ __forceinline__ uint32_t col_pair(const __nv_bfloat16* c,
                                             int stride) {
  return as_u32(__halves2bfloat162(c[0], c[stride]));
}
__device__ __forceinline__ uint32_t col_pair(const int8_t* c, int stride) {
  return pack_bf16((float)c[0], (float)c[stride]);
}

// acc += A (16 x 16, row-major fragments) B (16 x 8, column fragments),
// bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (bh * n_split + z, y): row b, KV head h, query heads y * MMA_M ..,
// the valid slots of [z * chunk, (z + 1) * chunk), as decode_kernel (the
// same outputs and partials).  Fragment layout of m16n8k16 (PTX ISA): lane
// = 4 * gid + tig; A holds rows gid and gid + 8, B and C column gid and
// columns 2 tig, 2 tig + 1.
template <typename TKV, int HD>
__global__ void __launch_bounds__(32 * MMA_WARPS)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const TKV* __restrict__ k, const TKV* __restrict__ v,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  const int* __restrict__ pos, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int G, int n_kv_heads, int cap, int window, float scale,
                  int chunk, int n_split) {
  using S = MmaShape<TKV, HD>;
  constexpr int THREADS = 32 * MMA_WARPS;
  constexpr int KSTEPS = HD / 16;                // k16 steps of Q K^T
  constexpr int OCOLS = HD / MMA_WARPS;          // O's columns per warp
  constexpr int OT = OCOLS / 8;                  // their n8 tiles
  constexpr int RS = S::row / (int)sizeof(TKV);  // stage row, elements
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  extern __shared__ float smem[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(smem);
  __nv_bfloat16* sm_p = reinterpret_cast<__nv_bfloat16*>(
      stages + MMA_STAGES * S::stage);                 // MMA_M x p_row
  float* sm_red = reinterpret_cast<float*>(sm_p + MMA_M * S::p_row);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int bh = blockIdx.x / n_split;   // b * Hkv + h
  const int z = blockIdx.x % n_split;
  const int b = bh / n_kv_heads, h = bh % n_kv_heads;
  const int g0 = blockIdx.y * MMA_M;
  const int ng = min(MMA_M, G - g0);
  const int p = pos[b];
  int lo = z * chunk;
  // decode_merge reads only the splits that hold visible slots
  if (n_split > 1 && lo >= visible(p, cap)) return;
  int hi = min(cap, lo + chunk);
  int pm, nv;
  cut_to_arc(p, cap, window, lo, hi, pm, nv);
  if (n_split > 1 && lo >= hi) {   // no valid slot: the empty partial
    write_empty<HD, THREADS>(part_acc, part_ml,
                             ((size_t)bh * n_split + z) * G + g0, ng);
    return;
  }
  const int n_tiles = lo < hi ? (hi - lo + MMA_TILE - 1) / MMA_TILE : 0;

  // stage tile t: its valid slots' K and V rows, zeros for the others
  auto issue = [&](int t) {
    unsigned char* st = stages + (t % MMA_STAGES) * S::stage;
    for (int i = threadIdx.x; i < MMA_TILE * S::pieces; i += THREADS) {
      const int r = i / S::pieces, e = i % S::pieces;
      const int c = lo + t * MMA_TILE + r;
      const bool ok = c < hi && slot_ok(c, pm, cap, nv);
      const size_t off =
          (((size_t)b * cap + (ok ? c : 0)) * n_kv_heads + h) * HD *
              sizeof(TKV) +
          16 * e;
      cp_async16(smem_u32(st + r * S::row + 16 * e),
                 reinterpret_cast<const char*>(k) + off, ok ? 16 : 0);
      cp_async16(smem_u32(st + (MMA_TILE + r) * S::row + 16 * e),
                 reinterpret_cast<const char*>(v) + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < MMA_STAGES - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_commit();
  }

  // Q's A fragments over hd (zero rows past the group)
  uint32_t qa[KSTEPS][4];
  {
    const __nv_bfloat16* q0 = q + ((size_t)bh * G + g0) * HD;
    const bool r0 = gid < ng, r1 = gid + 8 < ng;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int d = 16 * kk + 2 * tig;
      qa[kk][0] = r0 ? row_pair(q0 + gid * HD, d) : 0u;
      qa[kk][1] = r1 ? row_pair(q0 + (gid + 8) * HD, d) : 0u;
      qa[kk][2] = r0 ? row_pair(q0 + gid * HD, d + 8) : 0u;
      qa[kk][3] = r1 ? row_pair(q0 + (gid + 8) * HD, d + 8) : 0u;
    }
  }

  // the online softmax of rows gid and gid + 8 (every warp keeps the same
  // m; l sums this thread's slots), and O's columns of this warp
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<MMA_STAGES - 2>();
    __syncthreads();   // tile t is in; tile t - 1's stage is free
    if (t + MMA_STAGES - 1 < n_tiles) issue(t + MMA_STAGES - 1);
    cp_commit();
    const TKV* sk = reinterpret_cast<const TKV*>(
        stages + (t % MMA_STAGES) * S::stage);
    const TKV* sv = sk + MMA_TILE * RS;

    // S = Q K^T for this warp's 8 slots
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    const TKV* krow = sk + (8 * warp + gid) * RS;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      mma_bf16(sc, qa[kk], row_pair(krow, 16 * kk + 2 * tig),
               row_pair(krow, 16 * kk + 2 * tig + 8));
    const int c0 = lo + t * MMA_TILE + 8 * warp + 2 * tig;
    bool ok[2];
    float vsc[2] = {1.f, 1.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + j;
      ok[j] = c < hi && slot_ok(c, pm, cap, nv);
      float ksc = 1.f;
      if (QUANT && ok[j]) {
        const size_t at = ((size_t)b * cap + c) * n_kv_heads + h;
        ksc = ks[at];
        vsc[j] = vs[at];
      }
      sc[j] = ok[j] ? sc[j] * scale * ksc : NEG;
      sc[2 + j] = ok[j] ? sc[2 + j] * scale * ksc : NEG;
    }
    float mx[2] = {fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3])};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (tig == 0) {
      sm_red[warp * MMA_M + gid] = mx[0];
      sm_red[warp * MMA_M + gid + 8] = mx[1];
    }
    __syncthreads();   // the warps' row maxima

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mn = m[r];
#pragma unroll
      for (int w = 0; w < MMA_WARPS; ++w)
        mn = fmaxf(mn, sm_red[w * MMA_M + gid + 8 * r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
    float pe[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      pe[j] = ok[j] ? expf(sc[j] - m[0]) : 0.f;
      pe[2 + j] = ok[j] ? expf(sc[2 + j] - m[1]) : 0.f;
    }
    l[0] = l[0] * alpha[0] + pe[0] + pe[1];
    l[1] = l[1] * alpha[1] + pe[2] + pe[3];
    const int pc = 8 * warp + 2 * tig;
    *reinterpret_cast<uint32_t*>(sm_p + gid * S::p_row + pc) =
        pack_bf16(pe[0] * vsc[0], pe[1] * vsc[1]);
    *reinterpret_cast<uint32_t*>(sm_p + (gid + 8) * S::p_row + pc) =
        pack_bf16(pe[2] * vsc[0], pe[3] * vsc[1]);
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    __syncthreads();   // P of all the tile's slots

    // O += P V over this warp's columns
#pragma unroll
    for (int kq = 0; kq < MMA_TILE / 16; ++kq) {
      const int pk = 16 * kq + 2 * tig;
      const uint32_t pa[4] = {
          row_pair(sm_p + gid * S::p_row, pk),
          row_pair(sm_p + (gid + 8) * S::p_row, pk),
          row_pair(sm_p + gid * S::p_row, pk + 8),
          row_pair(sm_p + (gid + 8) * S::p_row, pk + 8)};
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        const TKV* vc = sv + pk * RS + warp * OCOLS + 8 * j + gid;
        mma_bf16(acc[j], pa, col_pair(vc, RS), col_pair(vc + 8 * RS, RS));
      }
    }
  }

  // each row's l: over the group's four lanes, then over the warps in
  // warp order (every warp has passed its last read of sm_red)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (tig == 0) {
    sm_red[warp * MMA_M + gid] = l[0];
    sm_red[warp * MMA_M + gid + 8] = l[1];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = gid + 8 * r;
    if (g >= ng) continue;
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) lsum += sm_red[w * MMA_M + g];
    const size_t pg = ((size_t)bh * n_split + z) * G + g0 + g;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int d = warp * OCOLS + 8 * j + 2 * tig;
      if (n_split == 1) {
        const size_t at = ((size_t)bh * G + g0 + g) * HD + d;
        o[at] = __float2bfloat16_rn(acc[j][2 * r] / fmaxf(lsum, 1e-30f));
        o[at + 1] =
            __float2bfloat16_rn(acc[j][2 * r + 1] / fmaxf(lsum, 1e-30f));
      } else {
        part_acc[pg * HD + d] = acc[j][2 * r];
        part_acc[pg * HD + d + 1] = acc[j][2 * r + 1];
      }
    }
    if (n_split > 1 && warp == 0 && tig == 0) {
      part_ml[2 * pg] = m[r];
      part_ml[2 * pg + 1] = lsum;
    }
  }
}

// The merge of a launch's partials (above one split): one block per
// (row, KV head) and MERGE_THREADS of its G * hd elements.
template <typename TQ>
int launch_merge(const Args& a, int hd, const float* part_acc,
                 const float* part_ml) {
  const int rows = a.B * a.n_kv_heads;
  const dim3 grid(rows, (a.G * hd + MERGE_THREADS - 1) / MERGE_THREADS);
  decode_merge<TQ><<<grid, MERGE_THREADS, 0, a.stream>>>(
      part_acc, part_ml, a.pos, (TQ*)a.o, a.n_kv_heads, a.G, hd, a.cap,
      a.chunk, a.n_split);
  return (int)cudaGetLastError();
}

template <typename TKV, int HD>
int run_mma(const Args& a) {
  using S = MmaShape<TKV, HD>;
  auto kernel = decode_mma_kernel<TKV, HD>;
  if (S::smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = a.B * a.n_kv_heads;
  float* part_acc = a.part;
  float* part_ml =
      a.part ? a.part + (size_t)rows * a.n_split * a.G * HD : nullptr;
  const dim3 grid(rows * a.n_split, (a.G + MMA_M - 1) / MMA_M);
  kernel<<<grid, 32 * MMA_WARPS, S::smem, a.stream>>>(
      (const __nv_bfloat16*)a.q, (const TKV*)a.k, (const TKV*)a.v, a.ks,
      a.vs, a.pos, (__nv_bfloat16*)a.o, part_acc, part_ml, a.G,
      a.n_kv_heads, a.cap, a.window, a.scale, a.chunk, a.n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  return launch_merge<__nv_bfloat16>(a, HD, part_acc, part_ml);
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
  return launch_merge<TQ>(a, HD, part_acc, part_ml);
}

// GT = the query heads a block holds: the group size rounded up to 1, 2, 4
// or 8; larger groups take several blocks of 8, except on the ring with
// bf16 q and bf16 or int8 K/V, where blocks of MMA_M heads run the
// tensor-core body.
template <typename TQ, typename TKV, int HD, bool TABLE>
int by_group(const Args& a) {
  if constexpr (!TABLE && std::is_same<TQ, __nv_bfloat16>::value &&
                !std::is_same<TKV, float>::value) {
    if (a.G > 8) return run_mma<TKV, HD>(a);
  }
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
