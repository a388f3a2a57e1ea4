// Flash-attention forward, sm_90a: the fp32 kernel (bf16 inputs go to the
// tensor-core kernel of flash_fwd_sm90.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py,
// _flash_kernel (wrapper flash_attention_folded): causal / sliding-window
// attention with an online softmax over (BQ, BK) tiles, GQA by index, fp32
// math whatever the input type, writing o in q's type and the per-row
// log-sum-exp lse = m + log(max(l, 1e-30)) in fp32 for the backward.
//
// What bounds it on the H100: operations.  Per unmasked (q, k) pair it does
// 4 * hd FLOPs (q.k and p.v) against 4 * hd bytes of q, k, v and o per row,
// so at S = 2048 it is far above the fp32 ridge; the least time is the
// unmasked pairs' FLOPs over 67 TFLOP/s of non-tensor fp32 (the FMA pipes:
// the fp32 parity tests and loss traces rest on this kernel's full-fp32
// products).
//
// What the design does about it:
//  * One block per (B*Hq row, BQ-row q tile) walks only the KV tiles that
//    _tile_visible admits: about half of them under a causal mask, O(window)
//    under a sliding window.  Nothing of size S x S exists anywhere.
//  * Q stays in shared memory for the whole walk; K and V tiles are staged
//    once per tile (fp32, transposed, see flash_common.cuh) and each thread
//    keeps a (BQ/16) x (BK/16) block of scores and a (BQ/16) x (HD/16) block
//    of the output accumulator in registers.  P overwrites K's tile once the
//    scores are formed, so hd = 128 needs 100 KB and two blocks fit an SM.
//  * Masked entries are the finite NEG = -1e30, as in the reference: a row
//    whose first visited tile is all masked sums exp(NEG - NEG) = 1 terms
//    until its first real score, whose alpha = exp(NEG - m) = 0 wipes them
//    (with -inf that case would be NaN).
//  * Ragged S is bounds-checked loads that read 0 and masked stores; nothing
//    is padded in device memory.
#include "flash_common.cuh"

namespace {

using flash::NEG;
using flash::THREADS;

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int n_q_heads,
                 int n_kv_heads, int causal, int window, float scale) {
  constexpr int RI = BQ / 16, CJ = BK / 16, CD = HD / 16;
  static_assert(HD * (BK + 1) >= BK * (BQ + 1), "P must fit in K's tile");
  extern __shared__ float smem[];
  float* Qt = smem;                    // HD x (BQ + 1)
  float* Kt = Qt + HD * (BQ + 1);      // HD x (BK + 1)
  float* Vt = Kt + HD * (BK + 1);      // HD x (BK + 1)
  float* Pt = Kt;                      // BK x (BQ + 1), after the scores

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = flash::kv_row(bh, n_q_heads, n_kv_heads);
  const T* kp = k + (size_t)kvh * S * HD;
  const T* vp = v + (size_t)kvh * S * HD;

  flash::load_t<T, BQ, HD>(Qt, q + (size_t)bh * S * HD, q0, S);

  float m[RI], l[RI], acc[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int n_k = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    if (!flash::tile_visible(q0, k0, BQ, BK, S, causal, window)) continue;
    __syncthreads();   // the previous tile's P and V are read
    flash::load_t<T, BK, HD>(Kt, kp, k0, S);
    flash::load_t<T, BK, HD>(Vt, vp, k0, S);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RI], b[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = Qt[d * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = Kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // mask, then the online-softmax update of this thread's rows
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = flash::unmasked(row, col, S, causal, window, false)
                      ? s[i][j] * scale
                      : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], flash::half_warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + flash::half_warp_sum(psum);
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();   // every thread is done reading K's tile
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        Pt[(tx + 16 * j) * (BQ + 1) + ty + 16 * i] = s[i][j];
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      float a[RI], b[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = Pt[jj * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CD; ++c) b[c] = Vt[(tx + 16 * c) * (BK + 1) + jj];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

  T* op = o + (size_t)bh * S * HD;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CD; ++c)
      op[(size_t)row * HD + tx + 16 * c] = flash::from_f<T>(acc[i][c] / lc);
    if (tx == 0) lse[(size_t)bh * S + row] = m[i] + logf(lc);
  }
}

template <typename T, int HD, int BQ, int BK>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int bh_q, int S, int n_q_heads, int n_kv_heads, int causal,
        int window, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (HD * (BQ + 1) + 2 * HD * (BK + 1));
  const dim3 grid((S + BQ - 1) / BQ, bh_q);
  return flash::launch(flash_fwd_kernel<T, HD, BQ, BK>, grid, smem, stream,
                       (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S,
                       n_q_heads, n_kv_heads, causal, window, scale);
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             float* lse, int bh_q, int S, int n_q_heads, int n_kv_heads,
             int causal, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return run<T, 64, 64, 64>(q, k, v, o, lse, bh_q, S, n_q_heads,
                                n_kv_heads, causal, window, scale, stream);
    case 128:
      return run<T, 128, 64, 64>(q, k, v, o, lse, bh_q, S, n_q_heads,
                                 n_kv_heads, causal, window, scale, stream);
    case 256:   // K and V tiles of 32 rows keep the block at 134 KB
      return run<T, 256, 64, 32>(q, k, v, o, lse, bh_q, S, n_q_heads,
                                 n_kv_heads, causal, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* o, float* lse, int bh_q, int S, int hd,
                              int n_q_heads, int n_kv_heads, int causal,
                              int window, float scale, void* stream);

// o (bh_q, S, hd) in q's type and lse (bh_q, S) fp32 for q (bh_q, S, hd) and
// k, v (bh_q / G, S, hd), G = n_q_heads / n_kv_heads, all contiguous and of
// one type: fp32 (bf16 == 0) or bf16 (bf16 == 1, flash_fwd_sm90).  hd is 64,
// 128 or 256; window <= 0 means none.  Launches on `stream`; returns the
// launch's cudaError_t (0 on success); no sync.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, int bh_q, int S, int hd,
                         int n_q_heads, int n_kv_heads, int causal,
                         int window, float scale, int bf16, void* stream) {
  if (bf16)
    return flash_fwd_sm90(q, k, v, o, lse, bh_q, S, hd, n_q_heads,
                          n_kv_heads, causal, window, scale, stream);
  return dispatch<float>(hd, q, k, v, o, lse, bh_q, S, n_q_heads, n_kv_heads,
                         causal, window, scale, (cudaStream_t)stream);
}
