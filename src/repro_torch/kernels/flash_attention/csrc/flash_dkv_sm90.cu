// Flash-attention dk/dv for bf16 on Hopper's tensor cores, sm_90a.
//
// Replaces, for bf16 inputs, the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py, _flash_dkv_kernel,
// with its group sum (fp32 inputs keep the FMA kernel of flash_bwd.cu).  For
// one KV tile it rebuilds, for every visible q tile of every query head of
// the KV head's group,
//
//   S^T = K Q^T,  dP^T = V dO^T                  (wgmma, both operands in
//                                                 shared memory, K-major)
//   p   = exp(s * scale - lse)  (0 where masked and in rows at or past S)
//   ds  = p (dp - delta)
//   dV += P^T dO,  dK += dS^T Q                  (wgmma, A = P^T, dS^T from
//                                                 registers, B MN-major)
//
// and writes dk = scale * dK and dv = dV.  S^T and dP^T come out in the
// accumulator layout, whose 16-column blocks are the register A operand of
// the next products (flash_sm90.cuh), so P and dS never leave registers.
//
// Rounding.  S^T and dP^T are exact up to the order of their fp32 sums; p,
// ds, dK and dV are fp32.  The two roundings the fp32 kernel does not make:
// P and dS are rounded to bf16 as the A operands of dV and dK.
//
// What bounds it on the H100: operations, 8 * hd FLOPs per unmasked (q, k)
// pair against 989 TFLOP/s of dense bf16 tensor-core math.
//
// The design:
//  * A block is NWG consumer warpgroups, each owning 64 KV rows of the
//    block's tile, whose K and V stay in shared memory, and a producer
//    warp.  Q and dO tiles of 64 rows, with their lse (times log2 e) and
//    delta, stream through a ring of stages: lane 0 issues the TMA copies,
//    the warp reads lse and delta ahead and stores them, and its 32 lanes
//    arrive on the stage's `full` mbarrier; the consumers release the stage
//    on its `empty` mbarrier once the four products have read it.
//  * Registers set the shapes.  A block of more than 128 + 32 threads gets
//    at most 168 registers a thread from ptxas, and wgmma wants each
//    accumulator in one run of registers (a kernel that runs short
//    serializes its wgmmas or spills); dK and dV stay live across the walk.
//    - hd 64: two warpgroups (128 KV rows), one pass: S^T, dP^T, dK and dV
//      are 32 registers each (ptxas spills 36 bytes; one warpgroup, with
//      no spill, ran 14 % slower on the H100).
//    - hd 128: dK and dV are 128 registers, so one warpgroup (up to 255),
//      one pass, 2 stages (96 KB of shared memory).  Two warpgroups with
//      two passes (dV, then dK) ran 6-10 % slower on the H100; 32-row q
//      tiles spilled.
//    - hd 256: dK and dV together would be 256 registers, so one warpgroup
//      runs two passes, dV first (S^T only), then dK (S^T and dP^T), 2
//      stages (192 KB).
#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int DV = 1, DK = 2;   // the products a pass forms (MODE bits)
constexpr int BQ = 64;          // query rows per streamed tile
constexpr int STAGES = 2;       // Q/dO ring depth

// A block is NWG consumer warpgroups of 64 KV rows each and a producer warp.
template <int HD, int NWG>
struct Layout {
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int BK = NWG * 64;            // KV rows per block
  static constexpr int KV_BYTES = BK * HD * 2;   // the K or the V tile
  static constexpr int QT_BYTES = BQ * HD * 2;   // one Q or dO tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;     // + stage * QT_BYTES
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;
  static constexpr int LSE_OFF = DO_OFF + STAGES * QT_BYTES;   // fp32
  static constexpr int DL_OFF = LSE_OFF + STAGES * BQ * 4;
  static constexpr int BAR_OFF = DL_OFF + STAGES * BQ * 4;
  // kv, full[STAGES], empty[STAGES]; + 1 KB to align the base to 1024
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int HD, int NWG, int MODE>
__global__ void __launch_bounds__(Layout<HD, NWG>::THREADS, 1)
flash_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv,
                      float* __restrict__ part, int S, int n_q_heads,
                      int n_kv_heads, int causal, int window, float scale) {
  using L = Layout<HD, NWG>;
  constexpr int BK = L::BK, PANELS = HD / 64;
  constexpr bool WITH_DK = (MODE & DK) != 0, WITH_DV = (MODE & DV) != 0;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* lse_s =
      reinterpret_cast<float*>(smem_raw + (base - raw) + L::LSE_OFF);
  float* dl_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::DL_OFF);
  const uint32_t kv_bar = base + L::BAR_OFF;
  const uint32_t full0 = kv_bar + 8, empty0 = kv_bar + 8 * (1 + STAGES);

  const int k0 = blockIdx.x * BK;
  const int bhkv = blockIdx.y;
  const int n_split = gridDim.z, split = blockIdx.z;
  const int group = n_q_heads / n_kv_heads;
  const int b = bhkv / n_kv_heads, hk = bhkv % n_kv_heads;
  const int g_lo = split * group / n_split;
  const int g_hi = (split + 1) * group / n_split;
  const int n_q = (S + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    sm90::bar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::bar_init(full0 + 8 * s, 32);
      sm90::bar_init(empty0 + 8 * s, NWG * 128);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {   // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      sm90::bar_arrive_tx(kv_bar, (WITH_DK ? 2 : 1) * L::KV_BYTES);
      for (int r = 0; r < BK; r += 64)
        for (int p = 0; p < PANELS; ++p) {
          const uint32_t off = p * BK * 128 + r * 128;
          sm90::tma_load(base + off, &tk, kv_bar, p * 64, k0 + r, bhkv);
          if constexpr (WITH_DK)
            sm90::tma_load(base + L::V_OFF + off, &tv, kv_bar, p * 64, k0 + r,
                           bhkv);
        }
    }
    int st = 0, ph = 0;
    for (int g = g_lo; g < g_hi; ++g) {
      const int bh = b * n_q_heads + hk * group + g;
      for (int qt = 0; qt < n_q; ++qt) {
        const int q0 = qt * BQ;
        if (!flash::tile_visible(q0, k0, BQ, BK, S, causal, window)) continue;
        // the tile's lse and delta are read before the wait for its stage,
        // so their latency hides behind it
        float lr[BQ / 32], dr[BQ / 32];
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          const int row = q0 + lane + 32 * i;
          lr[i] = row < S ? lse[(size_t)bh * S + row] * LOG2E : 0.f;
          dr[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
        }
        sm90::bar_wait(empty0 + 8 * st, ph ^ 1);
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          lse_s[st * BQ + lane + 32 * i] = lr[i];
          dl_s[st * BQ + lane + 32 * i] = dr[i];
        }
        if (lane == 0) {
          sm90::bar_arrive_tx(full0 + 8 * st, 2 * L::QT_BYTES);
          for (int p = 0; p < PANELS; ++p) {
            const uint32_t off = st * L::QT_BYTES + p * BQ * 128;
            sm90::tma_load(base + L::Q_OFF + off, &tq, full0 + 8 * st,
                           p * 64, q0, bh);
            sm90::tma_load(base + L::DO_OFF + off, &tdo, full0 + 8 * st,
                           p * 64, q0, bh);
          }
        } else {
          sm90::bar_arrive(full0 + 8 * st);
        }
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: KV rows kv0 and kv0 + 8 of this thread
  const int wg = threadIdx.x / 128, w = threadIdx.x % 128 / 32;
  const int gq = threadIdx.x % 32 / 4, t4 = threadIdx.x % 4;
  const int wk0 = k0 + wg * 64;               // the warpgroup's first KV row
  const int kv0 = wk0 + 16 * w + gq;
  const float sl2 = scale * LOG2E;
  float dka[WITH_DK ? HD / 2 : 1], dva[WITH_DV ? HD / 2 : 1];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    if constexpr (WITH_DK) dka[i] = 0.f;
    if constexpr (WITH_DV) dva[i] = 0.f;
  }
  const uint32_t k_tile = base + wg * 64 * 128;
  const uint32_t v_tile = base + L::V_OFF + wg * 64 * 128;

  sm90::bar_wait(kv_bar, 0);
  int st = 0, ph = 0;
  for (int g = g_lo; g < g_hi; ++g) {
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      if (!flash::tile_visible(q0, k0, BQ, BK, S, causal, window)) continue;
      sm90::bar_wait(full0 + 8 * st, ph);
      const uint32_t q_tile = base + L::Q_OFF + st * L::QT_BYTES;
      const uint32_t do_tile = base + L::DO_OFF + st * L::QT_BYTES;
      const float* lse_t = lse_s + st * BQ;
      const float* dl_t = dl_s + st * BQ;

      // S^T and dP^T; their first step overwrites them, so no other
      // instruction writes an accumulator while products are in flight
      float sa[BQ / 2], dp[WITH_DK ? BQ / 2 : 1];
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * BK * 128 + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        if constexpr (WITH_DK)
          sm90::Wgmma<BQ>::ss(dp, sm90::kmajor(v_tile + a_off),
                              sm90::kmajor(do_tile + b_off), kk);
        sm90::Wgmma<BQ>::ss(sa, sm90::kmajor(k_tile + a_off),
                            sm90::kmajor(q_tile + b_off), kk);
      }
      sm90::wg_commit();
      sm90::wg_wait_all();
      sm90::pin(sa);
      if constexpr (WITH_DK) sm90::pin(dp);

      // p and ds on the accumulator fragments: rows are KV rows, columns
      // query rows.  Every exponential is taken and the mask selects, so
      // the 32 of a thread have no branch between them and their latencies
      // overlap; tiles that do not cut the mask or S skip it.
      const bool whole = q0 + BQ <= S && wk0 + 63 < S &&
                         (!causal || wk0 + 63 <= q0) &&
                         (window <= 0 || wk0 > q0 + BQ - 1 - window);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)   // p over s, in place
        sa[i] = exp2f(sa[i] * sl2 - lse_t[8 * (i / 4) + 2 * t4 + (i & 1)]);
      if (!whole) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int kv = kv0 + 8 * (i % 4 / 2);
          const int c = 8 * (i / 4) + 2 * t4 + (i & 1);
          sa[i] = flash::unmasked(q0 + c, kv, S, causal, window, true) ? sa[i]
                                                                       : 0.f;
        }
      }
      if constexpr (WITH_DK) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i)
          dp[i] = sa[i] * (dp[i] - dl_t[8 * (i / 4) + 2 * t4 + (i & 1)]);
      }

      // dV += P^T dO and dK += dS^T Q, P and dS rounded to bf16
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr (WITH_DV) sm90::a_frag(pa[kk], sa, kk);
        if constexpr (WITH_DK) sm90::a_frag(da[kk], dp, kk);
      }
      if constexpr (WITH_DV) {
        sm90::pin(pa);
        sm90::pin(dva);
      }
      if constexpr (WITH_DK) {
        sm90::pin(da);
        sm90::pin(dka);
      }
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr (WITH_DV)
          sm90::Wgmma<HD>::rs(dva, pa[kk],
                              sm90::mnmajor(do_tile + kk * 2048, BQ * 128),
                              1);
        if constexpr (WITH_DK)
          sm90::Wgmma<HD>::rs(dka, da[kk],
                              sm90::mnmajor(q_tile + kk * 2048, BQ * 128), 1);
      }
      sm90::wg_commit();
      sm90::wg_wait_all();
      if constexpr (WITH_DV) sm90::pin(dva);
      if constexpr (WITH_DK) sm90::pin(dka);
      sm90::bar_arrive(empty0 + 8 * st);
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
  }

  // dk = scale * dK and dv = dV: bf16 outputs, or this split's fp32 partial
  const size_t n = (size_t)gridDim.y * S * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kv = kv0 + 8 * i;
    if (kv >= S) continue;
    const size_t at = ((size_t)bhkv * S + kv) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int r = 4 * j + 2 * i;
      if (n_split == 1) {
        if constexpr (WITH_DK)
          *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
              __floats2bfloat162_rn(dka[r] * scale, dka[r + 1] * scale);
        if constexpr (WITH_DV)
          *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
              __floats2bfloat162_rn(dva[r], dva[r + 1]);
      } else {
        if constexpr (WITH_DK)
          *reinterpret_cast<float2*>(part + split * n + at + 8 * j) =
              make_float2(dka[r] * scale, dka[r + 1] * scale);
        if constexpr (WITH_DV)
          *reinterpret_cast<float2*>(part + (n_split + split) * n + at +
                                     8 * j) = make_float2(dva[r], dva[r + 1]);
      }
    }
  }
}

// dk, dv = the sums of the n_split partials (part[s], part[n_split + s]),
// added in split order, cast to bf16.
__global__ void __launch_bounds__(256)
flash_dkv_kernel_sum(const float* __restrict__ part,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, size_t n, int n_split) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < n_split; ++s) {
      a += part[s * n + i];
      c += part[(n_split + s) * n + i];
    }
    dk[i] = __float2bfloat16_rn(a);
    dv[i] = __float2bfloat16_rn(c);
  }
}

template <int HD, int NWG, int MODE>
int pass(const CUtensorMap* maps, const float* lse, const float* delta,
         void* dk, void* dv, float* part, int bh_kv, int S, int n_q_heads,
         int n_kv_heads, int causal, int window, float scale, int n_split,
         cudaStream_t stream) {
  using L = Layout<HD, NWG>;
  const dim3 grid((S + L::BK - 1) / L::BK, bh_kv, n_split);
  return flash::launch<L::THREADS>(
      flash_dkv_kernel_sm90<HD, NWG, MODE>, grid, L::BYTES, stream, maps[0],
      maps[1], maps[2], maps[3], lse, delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, part, S, n_q_heads, n_kv_heads, causal, window,
      scale);
}

}  // namespace

// The bf16 route of flash_dkv (flash_bwd.cu): dk, dv (bh_kv, S, hd) bf16,
// each summed over the G query heads of its KV head, for bf16 q, do (bh_kv *
// G, S, hd), k, v (bh_kv, S, hd), contiguous and 16-byte aligned, and fp32
// lse, delta (bh_kv * G, S).  n_split (1 <= n_split <= G) splits each group's
// heads over blocks; above 1, part is fp32 scratch of 2 * n_split * bh_kv *
// S * hd.  hd 64, 128 or 256; window <= 0 means none.  Launches on `stream`;
// returns a cudaError_t; no sync.
extern "C" int flash_dkv_sm90(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv,
                              float* part, int n_split, int bh_kv, int S,
                              int hd, int n_q_heads, int n_kv_heads,
                              int causal, int window, float scale,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int group = n_q_heads / n_kv_heads;
  if (n_split < 1 || n_split > group || (n_split > 1 && !part))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];   // q, k, v, do
  int e = sm90::tile_map(&maps[0], q, bh_kv * group, S, hd);
  if (!e) e = sm90::tile_map(&maps[1], k, bh_kv, S, hd);
  if (!e) e = sm90::tile_map(&maps[2], v, bh_kv, S, hd);
  if (!e) e = sm90::tile_map(&maps[3], dout, bh_kv * group, S, hd);
  if (e) return e;
#define DKV_PASS(HD, NWG, MODE)                                              \
  pass<HD, NWG, MODE>(maps, lse, delta, dk, dv, part, bh_kv, S, n_q_heads,  \
                      n_kv_heads, causal, window, scale, n_split, s)
  switch (hd) {
    case 64:
      e = DKV_PASS(64, 2, DV | DK);
      break;
    case 128:
      e = DKV_PASS(128, 1, DV | DK);
      break;
    case 256:
      e = DKV_PASS(256, 1, DV);
      if (!e) e = DKV_PASS(256, 1, DK);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DKV_PASS
  if (e || n_split == 1) return e;
  const size_t n = (size_t)bh_kv * S * hd;
  flash_dkv_kernel_sum<<<1024, 256, 0, s>>>(part, (__nv_bfloat16*)dk,
                                            (__nv_bfloat16*)dv, n, n_split);
  return (int)cudaGetLastError();
}
