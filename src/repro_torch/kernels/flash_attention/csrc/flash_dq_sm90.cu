// Flash-attention dq for bf16 on Hopper's tensor cores, sm_90a.
//
// Replaces, for bf16 inputs, the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py, _flash_dq_kernel
// (fp32 inputs keep the FMA kernel of flash_bwd.cu, which the fp32 parity
// tests rest on).  For one q tile of one query head it walks the KV tiles
// that _tile_visible admits and forms
//
//   S = Q K^T,  dP = dO V^T                      (wgmma, both operands in
//                                                 shared memory, K-major)
//   p   = exp(s * scale - lse)  (0 where masked and in columns at or past S)
//   ds  = p (dp - delta)
//   dQ += dS K                                   (wgmma, A = dS from
//                                                 registers, B = K MN-major)
//
// and writes dq = scale * dQ, rows below S only.  S and dP come out in the
// accumulator layout, whose 16-column blocks are the register A operand of
// the next product (flash_sm90.cuh), so dS never leaves registers.  Each dq
// element is written once, by the block that owns its q tile: no atomics,
// and two calls agree bit for bit.
//
// Rounding.  S and dP are exact up to the order of their fp32 sums; p, ds
// and dQ are fp32.  The one rounding the fp32 kernel does not make: dS is
// rounded to bf16 as the A operand of dQ += dS K (dk/dv rounds it the same
// way for dK).
//
// What bounds it on the H100: operations, 6 * hd FLOPs per unmasked (q, k)
// pair against 989 TFLOP/s of dense bf16 tensor-core math.
//
// The design:
//  * A block is one consumer warpgroup of 64 query rows and a producer
//    warp.  Q and dO of the block's rows are loaded once by TMA and stay
//    in shared memory; each thread keeps the lse (times log2 e) and delta
//    of its two rows in registers.
//  * The producer walks the KV tiles that _tile_visible admits and streams
//    K and V through a ring of stages with TMA, completing a `full`
//    mbarrier per stage; the consumers release a stage on its `empty`
//    mbarrier once the three products have read it.
//  * Masks select rather than branch, and only in tiles that the mask or
//    the end of S cuts, so the exponentials of a thread overlap.
//  * GQA and MQA by index (flash::kv_row): the query heads of a group read
//    the same K and V through L2.
//  * Blocks take the q tiles last to first: under a causal mask the last
//    tiles walk the most KV tiles, so the longest blocks start first.
//  * Registers and shared memory set the shapes.  dQ is hd / 2 fp32
//    registers a thread, S and dP 32 each at 64-row KV tiles; ptxas gives
//    124, 158 and 219 registers a thread at hd 64, 128 and 256, no spills.
//    KV tiles of 64 rows in 2 stages: 48, 96 and 192 KB of shared memory,
//    so two or more blocks share an SM up to hd 128, and their warpgroups
//    run apart.  On the H100 this beat, at hd 64 and 128, two consumer
//    warpgroups a block (128 query rows, at most 168 registers a thread,
//    both on one ring), 128-row KV tiles, and a third stage.
//    chip_smoke.py's flash phase times it (bf16, causal): 0.2131 ms at B 4
//    x 16 heads, S 2048, hd 128; 0.2362 ms at B 2, G 16 on one KV head,
//    hd 256, window 2048.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

constexpr int BQ = 64;       // query rows per block: one warpgroup's
constexpr int BK = 64;       // KV rows per tile: one TMA box
constexpr int STAGES = 2;    // K/V ring depth
constexpr int THREADS = 128 + 32;

// A block is one consumer warpgroup and a producer warp.
template <int HD>
struct Layout {
  static constexpr int Q_BYTES = BQ * HD * 2;    // the Q or the dO tile
  static constexpr int KV_BYTES = BK * HD * 2;   // one K or V tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;      // + stage * KV_BYTES
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q, full[STAGES], empty[STAGES]; + 1 KB to align the base to 1024
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int S, int n_q_heads,
                     int n_kv_heads, int causal, int window, float scale) {
  using L = Layout<HD>;
  constexpr int PANELS = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_bar = base + L::BAR_OFF;
  const uint32_t full0 = q_bar + 8, empty0 = q_bar + 8 * (1 + STAGES);

  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int kvh = flash::kv_row(bh, n_q_heads, n_kv_heads);
  const int n_k = (S + BK - 1) / BK;

  if (threadIdx.x == 0) {
    sm90::bar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::bar_init(full0 + 8 * s, 1);
      sm90::bar_init(empty0 + 8 * s, 128);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer warp: one thread issues every copy
    if (threadIdx.x != 128) return;
    sm90::bar_arrive_tx(q_bar, 2 * L::Q_BYTES);
    for (int p = 0; p < PANELS; ++p) {
      sm90::tma_load(base + p * BQ * 128, &tq, q_bar, p * 64, q0, bh);
      sm90::tma_load(base + L::DO_OFF + p * BQ * 128, &tdo, q_bar, p * 64,
                     q0, bh);
    }
    int st = 0, ph = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      const int k0 = kt * BK;
      if (!flash::tile_visible(q0, k0, BQ, BK, S, causal, window)) continue;
      sm90::bar_wait(empty0 + 8 * st, ph ^ 1);
      sm90::bar_arrive_tx(full0 + 8 * st, 2 * L::KV_BYTES);
      for (int p = 0; p < PANELS; ++p) {
        const uint32_t off = st * L::KV_BYTES + p * BK * 128;
        sm90::tma_load(base + L::K_OFF + off, &tk, full0 + 8 * st, p * 64,
                       k0, kvh);
        sm90::tma_load(base + L::V_OFF + off, &tv, full0 + 8 * st, p * 64,
                       k0, kvh);
      }
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // the consumer warpgroup: rows row0 and row0 + 8 of this thread
  const int w = threadIdx.x / 32;
  const int g = threadIdx.x % 32 / 4, t4 = threadIdx.x % 4;
  const int row0 = q0 + 16 * w + g;
  const float sl2 = scale * LOG2E;            // scores in log2 units
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lr[i] = row < S ? lse[(size_t)bh * S + row] * LOG2E : 0.f;
    dr[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  const uint32_t q_tile = base;
  const uint32_t do_tile = base + L::DO_OFF;

  sm90::bar_wait(q_bar, 0);
  int st = 0, ph = 0;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    if (!flash::tile_visible(q0, k0, BQ, BK, S, causal, window)) continue;
    sm90::bar_wait(full0 + 8 * st, ph);
    const uint32_t k_tile = base + L::K_OFF + st * L::KV_BYTES;
    const uint32_t v_tile = base + L::V_OFF + st * L::KV_BYTES;

    // S and dP; their first step overwrites them, so no other
    // instruction writes an accumulator while products are in flight
    float s[BK / 2], dp[BK / 2];
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * BK * 128 + (kk % 4) * 32;
      sm90::Wgmma<BK>::ss(s, sm90::kmajor(q_tile + a_off),
                          sm90::kmajor(k_tile + b_off), kk);
      sm90::Wgmma<BK>::ss(dp, sm90::kmajor(do_tile + a_off),
                          sm90::kmajor(v_tile + b_off), kk);
    }
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(s);
    sm90::pin(dp);

    // p and ds on the accumulator fragments: rows are query rows,
    // columns KV rows.  Every exponential is taken and the mask selects;
    // tiles that do not cut the mask or S skip it.
    const bool whole = k0 + BK <= S && (!causal || k0 + BK - 1 <= q0) &&
                       (window <= 0 || k0 > q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)   // p over s, in place
      s[i] = exp2f(s[i] * sl2 - lr[i % 4 / 2]);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int row = row0 + 8 * (i % 4 / 2);
        const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        s[i] = flash::unmasked(row, col, S, causal, window, false) ? s[i]
                                                                   : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      dp[i] = s[i] * (dp[i] - dr[i % 4 / 2]);

    // dQ += dS K, dS rounded to bf16
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) sm90::a_frag(da[kk], dp, kk);
    sm90::pin(da);
    sm90::pin(acc);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::Wgmma<HD>::rs(acc, da[kk],
                          sm90::mnmajor(k_tile + kk * 2048, BK * 128), 1);
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(acc);
    sm90::bar_arrive(empty0 + 8 * st);
    if (++st == STAGES) {
      st = 0;
      ph ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    __nv_bfloat16* drow = dq + ((size_t)bh * S + row) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                acc[4 * j + 2 * i + 1] * scale);
  }
}

template <int HD>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, int bh_q, int S,
        int n_q_heads, int n_kv_heads, int causal, int window, float scale,
        cudaStream_t stream) {
  const int bh_kv = bh_q / (n_q_heads / n_kv_heads);
  CUtensorMap mq, mk, mv, mdo;
  int e = sm90::tile_map(&mq, q, bh_q, S, HD);
  if (!e) e = sm90::tile_map(&mk, k, bh_kv, S, HD);
  if (!e) e = sm90::tile_map(&mv, v, bh_kv, S, HD);
  if (!e) e = sm90::tile_map(&mdo, dout, bh_q, S, HD);
  if (e) return e;
  const dim3 grid((S + BQ - 1) / BQ, bh_q);
  return flash::launch<THREADS>(flash_dq_kernel_sm90<HD>, grid,
                                Layout<HD>::BYTES, stream, mq, mk, mv, mdo,
                                lse, delta, (__nv_bfloat16*)dq, S, n_q_heads,
                                n_kv_heads, causal, window, scale);
}

}  // namespace

// The bf16 route of flash_dq (flash_bwd.cu), same arguments: dq (bh_q, S,
// hd) bf16 for bf16 q, do (bh_q, S, hd) and k, v (bh_q / G, S, hd),
// contiguous and 16-byte aligned, and fp32 lse, delta (bh_q, S); hd 64, 128
// or 256; window <= 0 means none.  Launches on `stream`; returns a
// cudaError_t; no sync.
extern "C" int flash_dq_sm90(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, int bh_q, int S,
                             int hd, int n_q_heads, int n_kv_heads,
                             int causal, int window, float scale,
                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define DQ_RUN(HD)                                                           \
  run<HD>(q, k, v, dout, lse, delta, dq, bh_q, S, n_q_heads, n_kv_heads,    \
          causal, window, scale, s)
  switch (hd) {
    case 64:
      return DQ_RUN(64);
    case 128:
      return DQ_RUN(128);
    case 256:
      return DQ_RUN(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DQ_RUN
}
