// Flash-attention forward for bf16 on Hopper's tensor cores, sm_90a.
//
// Replaces, for bf16 inputs, the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py, _flash_kernel (fp32
// inputs keep the FMA kernel of flash_fwd.cu, which the fp32 parity tests
// rest on).  It computes what that kernel computes: causal / sliding-window
// attention with an online softmax, GQA by index, o in bf16 and the per-row
// lse = m + log(max(l, 1e-30)) in fp32, with masked scores at the finite
// NEG = -1e30, so a row whose first visited tile is all masked behaves as
// in the reference (flash_fwd.cu says how).
//
// Rounding.  q, k and v are bf16, so S = Q K^T on the tensor cores is exact
// up to the order of its fp32 sums.  The one rounding the fp32 kernel does
// not make is P's: the probabilities are rounded to bf16 for P V.  The row
// max, the row sum and the accumulator O stay fp32.
//
// What bounds it on the H100: operations, 4 * hd FLOPs per unmasked (q, k)
// pair against 989 TFLOP/s of dense bf16 tensor-core math.
//
// The design:
//  * A block is one or two consumer warpgroups and a producer warp.  Each
//    warpgroup owns 64 query rows; Q is loaded once and stays in shared
//    memory.
//  * The producer walks the KV tiles that _tile_visible admits and streams
//    K and V through a ring of stages with TMA, completing a `full`
//    mbarrier per stage; the consumers release a stage on its `empty`
//    mbarrier once both products have read it, so the next tiles' loads
//    overlap this tile's math.
//  * S = Q K^T is a wgmma with both operands in shared memory (K-major).  The
//    online softmax runs on the fp32 accumulator fragments: the four lanes
//    that share a row reduce its max with two shuffles; each lane keeps its
//    own part of the row sum, reduced once at the end.  P, packed to bf16 in
//    registers, is the register A operand of P V, a wgmma with V in shared
//    memory (MN-major) into the fp32 accumulator O.
//  * Tiles are TMA boxes of 64 rows x 64 columns, 128-byte swizzled
//    (flash_sm90.cuh).  Rows at or past S arrive as 0, nothing is padded in
//    device memory, and the epilogue writes only rows below S.
//  * Registers set the shapes.  A block of more than 128 + 32 threads gets
//    at most 168 registers a thread from ptxas, and wgmma wants each
//    accumulator in one run of registers (a kernel that runs short
//    serializes its wgmmas or spills):
//    - hd 64 and 128: two warpgroups (128 query rows), O 32 or 64
//      registers, KV tiles of 128 rows in 2 stages (160 KB of shared
//      memory at hd 128);
//    - hd 256: O alone is 128 registers, so one warpgroup (64 query rows,
//      up to 255 registers), KV tiles of 64 rows in 2 stages (160 KB).
//    Tile size and ring depth were chosen on the H100: at hd 128, 128-row
//    KV tiles ran 8 % faster than 64-row tiles in 4 stages; depths of 2-6
//    stages moved times by under 4 %.
//  * Blocks take the q tiles last to first: under a causal mask the last
//    tiles walk the most KV tiles, so the longest blocks start first.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using flash::NEG;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// A block is NWG consumer warpgroups of 64 query rows each and a producer
// warp; BK KV rows per tile (a multiple of the 64-row TMA box), STAGES
// tiles in the ring.
template <int HD, int BK, int NWG, int STAGES>
struct Layout {
  static_assert(BK % 64 == 0, "K and V tiles are whole TMA boxes");
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int BQ = NWG * 64;             // query rows per block
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;   // one K or V tile
  static constexpr int K_OFF = Q_BYTES;          // + stage * KV_BYTES
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q, full[STAGES], empty[STAGES]; + 1 KB to align the base to 1024
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int HD, int BK, int NWG, int STAGES>
__global__ void __launch_bounds__(Layout<HD, BK, NWG, STAGES>::THREADS, 1)
flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, int n_q_heads, int n_kv_heads, int causal,
                      int window, float scale) {
  using L = Layout<HD, BK, NWG, STAGES>;
  constexpr int PANELS = HD / 64, BQ = L::BQ;
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
      sm90::bar_init(empty0 + 8 * s, NWG * 128);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {
    // the producer warp: one thread issues every copy
    if (threadIdx.x != NWG * 128) return;
    sm90::bar_arrive_tx(q_bar, L::Q_BYTES);
    for (int r = 0; r < BQ; r += 64)
      for (int p = 0; p < PANELS; ++p)
        sm90::tma_load(base + p * BQ * 128 + r * 128, &tq, q_bar, p * 64,
                       q0 + r, bh);
    int st = 0, ph = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      const int k0 = kt * BK;
      if (!flash::tile_visible(q0, k0, BQ, BK, S, causal, window)) continue;
      sm90::bar_wait(empty0 + 8 * st, ph ^ 1);
      sm90::bar_arrive_tx(full0 + 8 * st, 2 * L::KV_BYTES);
      for (int r = 0; r < BK; r += 64)
        for (int p = 0; p < PANELS; ++p) {
          const uint32_t off = st * L::KV_BYTES + p * BK * 128 + r * 128;
          sm90::tma_load(base + L::K_OFF + off, &tk, full0 + 8 * st, p * 64,
                         k0 + r, kvh);
          sm90::tma_load(base + L::V_OFF + off, &tv, full0 + 8 * st, p * 64,
                         k0 + r, kvh);
        }
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // a consumer warpgroup: rows row0 and row0 + 8 of this thread
  const int wg = threadIdx.x / 128, w = threadIdx.x % 128 / 32;
  const int g = threadIdx.x % 32 / 4, t4 = threadIdx.x % 4;
  const int wq0 = q0 + wg * 64;               // the warpgroup's first row
  const int row0 = wq0 + 16 * w + g;
  const float sl2 = scale * LOG2E;            // scores in log2 units
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const uint32_t q_tile = base + wg * 64 * 128;

  sm90::bar_wait(q_bar, 0);
  int st = 0, ph = 0;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    if (!flash::tile_visible(q0, k0, BQ, BK, S, causal, window)) continue;
    sm90::bar_wait(full0 + 8 * st, ph);
    const uint32_t k_tile = base + L::K_OFF + st * L::KV_BYTES;
    const uint32_t v_tile = base + L::V_OFF + st * L::KV_BYTES;

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    sm90::pin(s);   // zeroed before the products start, not among them
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::Wgmma<BK>::ss(
          s, sm90::kmajor(q_tile + (kk / 4) * BQ * 128 + (kk % 4) * 32),
          sm90::kmajor(k_tile + (kk / 4) * BK * 128 + (kk % 4) * 32), kk);
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::pin(s);

    // mask (only tiles that cut the mask or the end of S need it, and it
    // selects rather than branches), then the online-softmax update of this
    // thread's two rows
    const bool whole = k0 + BK <= S && (!causal || k0 + BK - 1 <= wq0) &&
                       (window <= 0 || k0 > wq0 + 63 - window);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= sl2;
    if (!whole) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int row = row0 + 8 * (i % 4 / 2);
        const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        s[i] = flash::unmasked(row, col, S, causal, window, false) ? s[i]
                                                                   : NEG;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], s[i]);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - m[e / 2]);
        s[4 * j + e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];

    // O += P V, P rounded to bf16 in registers
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) sm90::a_frag(pa[kk], s, kk);
    sm90::pin(pa);
    sm90::pin(acc);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::Wgmma<HD>::rs(acc, pa[kk],
                          sm90::mnmajor(v_tile + kk * 2048, BK * 128), 1);
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
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f), inv = 1.f / lc;
    __nv_bfloat16* orow = o + ((size_t)bh * S + row) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                acc[4 * j + 2 * i + 1] * inv);
    if (t4 == 0) lse[(size_t)bh * S + row] = m[i] * LN2 + logf(lc);
  }
}

template <int HD, int BK, int NWG, int STAGES>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int bh_q, int S, int n_q_heads, int n_kv_heads, int causal,
        int window, float scale, cudaStream_t stream) {
  const int bh_kv = bh_q / (n_q_heads / n_kv_heads);
  CUtensorMap mq, mk, mv;
  using L = Layout<HD, BK, NWG, STAGES>;
  int e = sm90::tile_map(&mq, q, bh_q, S, HD);
  if (!e) e = sm90::tile_map(&mk, k, bh_kv, S, HD);
  if (!e) e = sm90::tile_map(&mv, v, bh_kv, S, HD);
  if (e) return e;
  const dim3 grid((S + L::BQ - 1) / L::BQ, bh_q);
  return flash::launch<L::THREADS>(
      flash_fwd_kernel_sm90<HD, BK, NWG, STAGES>, grid, L::BYTES, stream, mq,
      mk, mv, (__nv_bfloat16*)o, lse, S, n_q_heads, n_kv_heads, causal,
      window, scale);
}

}  // namespace

// The bf16 route of flash_fwd (flash_fwd.cu), same arguments: o (bh_q, S, hd)
// bf16 and lse (bh_q, S) fp32 for bf16 q (bh_q, S, hd) and k, v (bh_q / G,
// S, hd), contiguous and 16-byte aligned; hd 64, 128 or 256; window <= 0
// means none.  Launches on `stream`; returns a cudaError_t; no sync.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bh_q, int S, int hd,
                              int n_q_heads, int n_kv_heads, int causal,
                              int window, float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define FWD_RUN(HD, BK, NWG, STAGES)                                         \
  run<HD, BK, NWG, STAGES>(q, k, v, o, lse, bh_q, S, n_q_heads, n_kv_heads, \
                           causal, window, scale, s)
  switch (hd) {
    case 64:
      return FWD_RUN(64, 128, 2, 2);
    case 128:
      return FWD_RUN(128, 128, 2, 2);
    case 256:
      return FWD_RUN(256, 64, 1, 2);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FWD_RUN
}
