// Flash-attention backward for fp32, sm_90a: the dq and dk/dv kernels on
// the FMA pipes (bf16 runs on the tensor cores: dq in flash_dq_sm90.cu,
// dk/dv in flash_dkv_sm90.cu; the C entries below route it there).
//
// Replaces the TPU kernels src/repro/kernels/flash_attention/flash_attention.py,
// _flash_dq_kernel and _flash_dkv_kernel (the custom_vjp backward of
// flash_attention_folded).  Both rebuild the probabilities tile by tile from
// the forward's fp32 lse, p = exp(s * scale - lse) (0 where masked), with
// ds = p * (dp - delta), dp = do v^T and delta = rowsum(do * o) (formed by
// the wrapper, as the reference forms it outside Pallas):
//
//   dq kernel:   one block per (B*Hq row, q tile) walks the visible KV tiles,
//                dq = scale * sum_k ds k.
//   dk/dv kernel: one block per (B*Hkv row, KV tile) walks the G query heads
//                of its group and their visible q tiles,
//                dv = sum_q p^T do,  dk = scale * sum_q ds^T q,
//                so the reference's per-query-head buffers and their group
//                sum (:356-362) fold into the block's registers.
//
// Neither kernel uses atomics: every output element is written once by the
// block that owns it, so the backward is deterministic and a resumed run
// repeats an uninterrupted one bit for bit.
//
// What bounds them on the H100: operations, 6 * hd FLOPs per unmasked
// (q, k) pair for dq (q.k, do.v, ds.k) and 8 * hd for dk/dv (q.k, do.v,
// p^T do, ds^T q), against the fp32 non-tensor peak of 67 TFLOP/s.  The
// design is the forward's: fp32 tiles staged transposed in shared memory
// (flash_common.cuh), register blocks of (16 x 16)-strided rows and columns
// per thread, fully masked tiles skipped, ragged S bounds-checked.
#include "flash_common.cuh"

namespace {

using flash::THREADS;

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S,
                int n_q_heads, int n_kv_heads, int causal, int window,
                float scale) {
  constexpr int RI = BQ / 16, CJ = BK / 16, CD = HD / 16;
  static_assert(HD * (BK + 1) >= BK * (BQ + 1), "dS must fit in V's tile");
  extern __shared__ float smem[];
  float* Qt = smem;                    // HD x (BQ + 1)
  float* dOt = Qt + HD * (BQ + 1);     // HD x (BQ + 1)
  float* Kt = dOt + HD * (BQ + 1);     // HD x (BK + 1)
  float* Vt = Kt + HD * (BK + 1);      // HD x (BK + 1)
  float* dSt = Vt;                     // BK x (BQ + 1), after dp is formed

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = flash::kv_row(bh, n_q_heads, n_kv_heads);
  const T* kp = k + (size_t)kvh * S * HD;
  const T* vp = v + (size_t)kvh * S * HD;

  flash::load_t<T, BQ, HD>(Qt, q + (size_t)bh * S * HD, q0, S);
  flash::load_t<T, BQ, HD>(dOt, dout + (size_t)bh * S * HD, q0, S);
  float lse_r[RI], dl_r[RI], acc[RI][CD];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < S ? lse[(size_t)bh * S + row] : 0.f;
    dl_r[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int n_k = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    if (!flash::tile_visible(q0, k0, BQ, BK, S, causal, window)) continue;
    __syncthreads();   // the previous tile's dS and K are read
    flash::load_t<T, BK, HD>(Kt, kp, k0, S);
    flash::load_t<T, BK, HD>(Vt, vp, k0, S);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float a[RI], ad[RI], bk[CJ], bv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        a[i] = Qt[d * (BQ + 1) + ty + 16 * i];
        ad[i] = dOt[d * (BQ + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        bk[j] = Kt[d * (BK + 1) + tx + 16 * j];
        bv[j] = Vt[d * (BK + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(ad[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = flash::unmasked(row, col, S, causal, window, true)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;   // exp(NEG)
        s[i][j] = p * (dp[i][j] - dl_r[i]);
      }
    }
    __syncthreads();   // every thread is done reading V's tile
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        dSt[(tx + 16 * j) * (BQ + 1) + ty + 16 * i] = s[i][j];
    __syncthreads();

    // acc += dS K
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      float a[RI], b[CD];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = dSt[jj * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CD; ++c) b[c] = Kt[(tx + 16 * c) * (BK + 1) + jj];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

  T* dqp = dq + (size_t)bh * S * HD;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      dqp[(size_t)row * HD + tx + 16 * c] =
          flash::from_f<T>(acc[i][c] * scale);
  }
}

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int n_q_heads, int n_kv_heads,
                 int causal, int window, float scale) {
  // this thread's KV rows j = ty + 16 i (RJ of them), query columns
  // r = tx + 16 c (CR), head-dim columns tx + 16 c (CD)
  constexpr int RJ = BK / 16, CR = BQ / 16, CD = HD / 16;
  extern __shared__ float smem[];
  float* Kt = smem;                    // HD x (BK + 1)
  float* Vt = Kt + HD * (BK + 1);      // HD x (BK + 1)
  float* Qt = Vt + HD * (BK + 1);      // HD x (BQ + 1)
  float* dOt = Qt + HD * (BQ + 1);     // HD x (BQ + 1)
  float* Ps = dOt + HD * (BQ + 1);     // BQ x (BK + 1): P^T read as rows
  float* dSs = Ps + BQ * (BK + 1);     // BQ x (BK + 1)
  float* lse_s = dSs + BQ * (BK + 1);  // BQ
  float* dl_s = lse_s + BQ;            // BQ

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int group = n_q_heads / n_kv_heads;
  const int b = kvh / n_kv_heads, hk = kvh % n_kv_heads;

  flash::load_t<T, BK, HD>(Kt, k + (size_t)kvh * S * HD, k0, S);
  flash::load_t<T, BK, HD>(Vt, v + (size_t)kvh * S * HD, k0, S);
  float dk_acc[RJ][CD], dv_acc[RJ][CD];
#pragma unroll
  for (int i = 0; i < RJ; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (S + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {
    const int bh = b * n_q_heads + hk * group + g;
    const T* qp = q + (size_t)bh * S * HD;
    const T* dop = dout + (size_t)bh * S * HD;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      if (!flash::tile_visible(q0, k0, BQ, BK, S, causal, window)) continue;
      __syncthreads();   // the previous q tile's P, dS, Q and dO are read
      flash::load_t<T, BQ, HD>(Qt, qp, q0, S);
      flash::load_t<T, BQ, HD>(dOt, dop, q0, S);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        const int row = q0 + r;
        lse_s[r] = row < S ? lse[(size_t)bh * S + row] : 0.f;
        dl_s[r] = row < S ? delta[(size_t)bh * S + row] : 0.f;
      }
      __syncthreads();

      // S^T (KV rows x query columns) and dP^T
      float st[RJ][CR], dpt[RJ][CR];
#pragma unroll
      for (int i = 0; i < RJ; ++i)
#pragma unroll
        for (int c = 0; c < CR; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; ++d) {
        float ak[RJ], av[RJ], bq[CR], bo[CR];
#pragma unroll
        for (int i = 0; i < RJ; ++i) {
          ak[i] = Kt[d * (BK + 1) + ty + 16 * i];
          av[i] = Vt[d * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CR; ++c) {
          bq[c] = Qt[d * (BQ + 1) + tx + 16 * c];
          bo[c] = dOt[d * (BQ + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RJ; ++i)
#pragma unroll
          for (int c = 0; c < CR; ++c) {
            st[i][c] = fmaf(ak[i], bq[c], st[i][c]);
            dpt[i][c] = fmaf(av[i], bo[c], dpt[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < RJ; ++i) {
        const int col = k0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < CR; ++c) {
          const int r = tx + 16 * c;
          const float p =
              flash::unmasked(q0 + r, col, S, causal, window, true)
                  ? expf(st[i][c] * scale - lse_s[r])
                  : 0.f;   // exp(NEG)
          Ps[r * (BK + 1) + ty + 16 * i] = p;
          dSs[r * (BK + 1) + ty + 16 * i] = p * (dpt[i][c] - dl_s[r]);
        }
      }
      __syncthreads();

      // dv += P^T dO, dk += dS^T Q
#pragma unroll 2
      for (int rr = 0; rr < BQ; ++rr) {
        float ap[RJ], as[RJ], bo[CD], bq[CD];
#pragma unroll
        for (int i = 0; i < RJ; ++i) {
          ap[i] = Ps[rr * (BK + 1) + ty + 16 * i];
          as[i] = dSs[rr * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          bo[c] = dOt[(tx + 16 * c) * (BQ + 1) + rr];
          bq[c] = Qt[(tx + 16 * c) * (BQ + 1) + rr];
        }
#pragma unroll
        for (int i = 0; i < RJ; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dv_acc[i][c] = fmaf(ap[i], bo[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(as[i], bq[c], dk_acc[i][c]);
          }
      }
    }
  }

  T* dkp = dk + (size_t)kvh * S * HD;
  T* dvp = dv + (size_t)kvh * S * HD;
#pragma unroll
  for (int i = 0; i < RJ; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dkp[(size_t)row * HD + tx + 16 * c] =
          flash::from_f<T>(dk_acc[i][c] * scale);
      dvp[(size_t)row * HD + tx + 16 * c] = flash::from_f<T>(dv_acc[i][c]);
    }
  }
}

// fp32 tile sizes by head dim: 64 x 64 up to hd = 128; 32 x 32 at hd = 256
// keeps each block within the 227 KB of opt-in shared memory.
template <int HD>
struct Tiles {
  static constexpr int BQ = HD == 256 ? 32 : 64;
  static constexpr int BK = HD == 256 ? 32 : 64;
};

template <typename T, int HD>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int bh_q, int S,
           int n_q_heads, int n_kv_heads, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  const size_t smem = sizeof(float) * (2 * HD * (BQ + 1) + 2 * HD * (BK + 1));
  const dim3 grid((S + BQ - 1) / BQ, bh_q);
  return flash::launch(flash_dq_kernel<T, HD, BQ, BK>, grid, smem, stream,
                       (const T*)q, (const T*)k, (const T*)v,
                       (const T*)dout, lse, delta, (T*)dq, S, n_q_heads,
                       n_kv_heads, causal, window, scale);
}

template <typename T, int HD>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv,
            int bh_kv, int S, int n_q_heads, int n_kv_heads, int causal,
            int window, float scale, cudaStream_t stream) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  const size_t smem = sizeof(float) * (2 * HD * (BK + 1) + 2 * HD * (BQ + 1) +
                                       2 * BQ * (BK + 1) + 2 * BQ);
  const dim3 grid((S + BK - 1) / BK, bh_kv);
  return flash::launch(flash_dkv_kernel<T, HD, BQ, BK>, grid, smem, stream,
                       (const T*)q, (const T*)k, (const T*)v,
                       (const T*)dout, lse, delta, (T*)dk, (T*)dv, S,
                       n_q_heads, n_kv_heads, causal, window, scale);
}

}  // namespace

extern "C" int flash_dq_sm90(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, int bh_q, int S,
                             int hd, int n_q_heads, int n_kv_heads,
                             int causal, int window, float scale,
                             void* stream);

// dq (bh_q, S, hd) in q's type for q, do (bh_q, S, hd), k, v (bh_q / G, S,
// hd), lse and delta (bh_q, S) fp32; one input type, fp32 (bf16 == 0) or
// bf16 (bf16 == 1, routed to flash_dq_sm90); hd 64, 128 or 256; window <= 0
// means none.  Launches on `stream`, returns the launch's cudaError_t; no
// sync.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, int bh_q, int S, int hd,
                        int n_q_heads, int n_kv_heads, int causal, int window,
                        float scale, int bf16, void* stream) {
  if (bf16)
    return flash_dq_sm90(q, k, v, dout, lse, delta, dq, bh_q, S, hd,
                         n_q_heads, n_kv_heads, causal, window, scale,
                         stream);
  const cudaStream_t s = (cudaStream_t)stream;
#define FLASH_DQ(HD)                                                         \
  run_dq<float, HD>(q, k, v, dout, lse, delta, dq, bh_q, S, n_q_heads,      \
                    n_kv_heads, causal, window, scale, s)
  switch (hd) {
    case 64:
      return FLASH_DQ(64);
    case 128:
      return FLASH_DQ(128);
    case 256:
      return FLASH_DQ(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_DQ
}

extern "C" int flash_dkv_sm90(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv,
                              float* part, int n_split, int bh_kv, int S,
                              int hd, int n_q_heads, int n_kv_heads,
                              int causal, int window, float scale,
                              void* stream);

// dk, dv (bh_kv, S, hd) in k's type, summed over the G query heads of each
// KV head; bh_kv = bh_q / G; other arguments as flash_dq.  bf16 goes to
// flash_dkv_sm90, with its split of the group (part, n_split); fp32 ignores
// both.
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, float* part,
                         int n_split, int bh_kv, int S, int hd,
                         int n_q_heads, int n_kv_heads, int causal,
                         int window, float scale, int bf16, void* stream) {
  if (bf16)
    return flash_dkv_sm90(q, k, v, dout, lse, delta, dk, dv, part, n_split,
                          bh_kv, S, hd, n_q_heads, n_kv_heads, causal, window,
                          scale, stream);
  const cudaStream_t s = (cudaStream_t)stream;
#define FLASH_DKV(HD)                                                        \
  run_dkv<float, HD>(q, k, v, dout, lse, delta, dk, dv, bh_kv, S, n_q_heads, \
                     n_kv_heads, causal, window, scale, s)
  switch (hd) {
    case 64:
      return FLASH_DKV(64);
    case 128:
      return FLASH_DKV(128);
    case 256:
      return FLASH_DKV(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_DKV
}
