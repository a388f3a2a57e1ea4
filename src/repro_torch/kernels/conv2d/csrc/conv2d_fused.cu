// Grouped implicit-GEMM convolution with fused bias + ReLU, fp32, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/conv2d.py,
// _conv_fused_kernel (wrapper conv2d_fused): NHWC x HWIO grouped conv,
// fp32 accumulation, bias and ReLU in the epilogue, no im2col tensor in
// device memory.
//
// What bounds it on the H100: operations.  AlexNet's layers do 50 to 200
// FLOPs per byte they must move, far above the fp32 ridge of the card
// (67 TFLOP/s of non-tensor fp32 over 3.35 TB/s = 20 FLOP/byte), so the
// least time is FLOPs / 67 TFLOP/s.  It runs on the fp32 FMA pipes (no
// TF32, so it matches the reference at 2e-4).
//
// What the design does about it (the GEMM core is matmul_bias.cu's):
//  * Per group g the conv is a GEMM  Y_g[m, n] = sum_k A_g[m, k] W_g[k, n]
//    with m = (b, oh, ow), n in the group's Cout/G channels and
//    k = (kh, kw, c) over the group's Cg input channels.  HWIO weights
//    are already that (K*K*Cg, Cout) matrix, row-major, so group g's slab
//    is columns [g*Cout/G, (g+1)*Cout/G): no weight reshape per call.
//  * A block of 256 threads owns a 128 x BN output tile of ONE group (BN
//    64 or 96, picked per layer by conv2d/ops.py::conv_tiles, one that
//    divides the group's channels) and reads only that group's input
//    channels.  Each thread keeps an 8 x BN/16 register tile and reads its
//    fragments from shared memory as float4s (A) and float4s or float2s
//    (B): per 4 steps of k, 8 + BN/16 vector loads feed 8 * BN/4 FMAs.
//    The 64-wide tile takes 116-128 registers a thread, so two blocks
//    share an SM; the 96-wide one 181-199, one block.  On the H100 two
//    64-wide blocks did as much per SM as one 128-wide block of the same
//    design (237 registers; kernel_sweep.py in development), which was
//    dropped: the rule takes 64 wherever it divides the group's channels
//    (conv2-5) and 96 for conv1's 96.
//  * The reduction runs over the flattened K*K*Cg in chunks of 16 through
//    a ring of STAGES shared-memory stages filled by cp.async, so three
//    chunks are in flight while the FMAs run on the fourth.  The weight
//    slab goes in 16-byte copies (4-byte where the group's channels are
//    not a multiple of 4).  The implicit-GEMM A gather goes in 16-byte
//    copies of four channels where Cg and Cin are multiples of 4 (conv2-5)
//    and in 4-byte copies otherwise (conv1, Cg 3), picked per launch.
//  * Zero padding is the zero-fill form of cp.async (src-size 0) on taps
//    outside the image and rows or k past the edge: x is never padded in
//    device memory.
//  * Each thread's (kh, kw, c) of k and each of its rows' window origin
//    are computed once per block; the main loop advances (kh, kw, c) by
//    the chunk with additions only.
//  * Split-K: at serving batches conv3-5 make 22-44 tiles for 132 SMs.
//    Where the tile grid leaves the card short of whole waves,
//    conv_tiles (a model of the run in waves, as gemm_split's) deals the
//    chunks out over n_split blocks per tile, each writing its fp32
//    partial to scratch; a second kernel adds the partials in split order
//    and applies bias and ReLU.  No atomics: two calls agree bit for bit.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 128;       // output pixels per block (GEMM rows)
constexpr int BK = 16;        // reduction chunk over (kh, kw, c)
constexpr int PAD = BK + 4;   // row stride (floats) of the m-major A tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int STAGES = 4;     // chunks in the ring

struct Shape {
  int H, W, Cin;        // input (B, H, W, Cin), NHWC
  int OH, OW, Cout;     // output (B, OH, OW, Cout), NHWC
  int K, stride, pad;   // square window
  int Cg, npg;          // input / output channels per group
  int M, Kdim;          // B*OH*OW, K*K*Cg
  int n_tiles;          // BN-wide tiles per group
  int relu, vec_b;
};

// The epilogue's ReLU: max(v, 0) that keeps a NaN, as the reference's
// jnp.maximum and torch.relu do (fmaxf alone would turn it into 0 and hide a
// non-finite input from the loss-scaling skip).
__device__ __forceinline__ float relu_keep_nan(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// Output row of a thread's i-th row (i < 8): 4-row runs 64 apart.
__device__ __forceinline__ int row_of(int ty, int i) {
  return (i / 4) * 64 + ty * 4 + i % 4;
}

// Output column of a thread's j-th column: VW-column runs 16 * VW apart,
// so a warp's B reads are 16 consecutive vectors of one shared-memory row.
template <int VW>
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j / VW) * 16 * VW + tx * VW + j % VW;
}

// Where a thread's k (= (kh * K + kw) * Cg + c) stands: advanced by BK per
// chunk with additions, given BK = dtap * Cg + dc.
struct KPos {
  int kh, kw, c;
  __device__ __forceinline__ void advance(int dtap, int dc, int Cg, int K) {
    c += dc;
    int t = dtap;
    if (c >= Cg) {
      c -= Cg;
      ++t;
    }
    kw += t;
    while (kw >= K) {
      kw -= K;
      ++kh;
    }
  }
};

// VEC: A copies move four channels (16 bytes), each thread two rows
// (tid / 4 and + 64) at k offset 4 * (tid % 4); else single floats, eight
// rows (tid / 16 + 16 r) at k offset tid % 16.
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv2d_fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    float* __restrict__ part, const Shape s) {
  constexpr int TN = BN / 16;            // columns per thread
  constexpr int VW = TN % 4 == 0 ? 4 : 2;
  constexpr int A_FLOATS = BM * PAD;
  constexpr int B_FLOATS = BK * BN;
  constexpr int A_ROWS = VEC ? 2 : 8;    // rows a thread copies
  constexpr int A_STEP = VEC ? 64 : 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const uint32_t s0 = smem_u32(smem);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int g = blockIdx.y / s.n_tiles;
  const int n0 = (blockIdx.y % s.n_tiles) * BN;
  const int cin0 = g * s.Cg;          // the group's first input channel
  const int cout0 = g * s.npg;        // ... and first output channel
  // this split's chunks: [c_lo, c_hi) of the ceil(Kdim / BK) chunks
  const int n_split = gridDim.z, split = blockIdx.z;
  const int chunks = (s.Kdim + BK - 1) / BK;
  const int per = (chunks + n_split - 1) / n_split;
  const int c_lo = split * per;
  const int c_hi = min(chunks, c_lo + per);
  const int n_c = max(0, c_hi - c_lo);

  // A: this thread's rows (window origin, and the offset in x of tap
  // (0, 0), channel 0 of the group) and its k
  const int a_r0 = VEC ? tid / 4 : tid / 16;
  const int a_kk = VEC ? 4 * (tid % 4) : tid % 16;
  int a_ih0[A_ROWS], a_iw0[A_ROWS], a_off[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + a_r0 + A_STEP * i;
    const int mm = m < s.M ? m : 0;
    const int ow = mm % s.OW;
    const int t = mm / s.OW;
    const int oh = t % s.OH;
    const int b = t / s.OH;
    // a row past M fails every bounds test
    a_ih0[i] = m < s.M ? oh * s.stride - s.pad : INT_MIN / 2;
    a_iw0[i] = ow * s.stride - s.pad;
    a_off[i] = ((b * s.H + oh * s.stride - s.pad) * s.W + a_iw0[i]) * s.Cin +
               cin0;
  }
  int a_k = c_lo * BK + a_kk;
  KPos kp;
  {
    const int tap = a_k / s.Cg;
    kp.c = a_k - tap * s.Cg;
    kp.kh = tap / s.K;
    kp.kw = tap - kp.kh * s.K;
  }
  const int dtap = BK / s.Cg, dc = BK - dtap * s.Cg;
  // B: the slab's chunk rows k0 .. k0 + 15, columns n0 .. n0 + BN - 1
  const float* wg = w + cout0 + n0;
  const int b_cols = min(BN, s.npg - n0);

  auto load = [&](int c, int stage) {
    const uint32_t sa = s0 + 4 * stage * (A_FLOATS + B_FLOATS);
    const bool k_ok = a_k < s.Kdim;
    const int koff = (kp.kh * s.W + kp.kw) * s.Cin + kp.c;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int ih = a_ih0[i] + kp.kh, iw = a_iw0[i] + kp.kw;
      const bool in = k_ok && (unsigned)ih < (unsigned)s.H &&
                      (unsigned)iw < (unsigned)s.W;
      const float* src = in ? x + (a_off[i] + koff) : x;
      const uint32_t dst = sa + 4 * ((a_r0 + A_STEP * i) * PAD + a_kk);
      if (VEC)
        cp_async16(dst, src, in ? 16 : 0);
      else
        cp_async4(dst, src, in ? 4 : 0);
    }
    const int k0 = (c_lo + c) * BK;
    const uint32_t sb = sa + 4 * A_FLOATS;
    if (s.vec_b) {
#pragma unroll
      for (int it = 0; it < (B_FLOATS / 4 + THREADS - 1) / THREADS; ++it) {
        const int e = tid + it * THREADS;
        if (B_FLOATS / 4 % THREADS == 0 || e < B_FLOATS / 4) {
          const int k = e / (BN / 4), n = e % (BN / 4) * 4;
          const bool in = k0 + k < s.Kdim && n < b_cols;
          cp_async16(sb + 4 * (k * BN + n),
                     in ? wg + (size_t)(k0 + k) * s.Cout + n : w,
                     in ? 16 : 0);
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < B_FLOATS / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int k = e / BN, n = e % BN;
        const bool in = k0 + k < s.Kdim && n < b_cols;
        cp_async4(sb + 4 * (k * BN + n),
                  in ? wg + (size_t)(k0 + k) * s.Cout + n : w, in ? 4 : 0);
      }
    }
    a_k += BK;
    kp.advance(dtap, dc, s.Cg, s.K);
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_c) load(st, st);
    cp_commit();
  }

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < n_c; ++c) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // chunk c is in; every thread is done with c - 1
    if (c + STAGES - 1 < n_c) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_commit();
    const float* As = smem + (c % STAGES) * (A_FLOATS + B_FLOATS);
    const float* Bs = As + A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float av[8][4], bv[TN][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            As + row_of(ty, i) * PAD + kq);
        av[i][0] = v.x;
        av[i][1] = v.y;
        av[i][2] = v.z;
        av[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < TN / VW; ++h) {
          const float* src = Bs + (kq + kk) * BN + h * 16 * VW + tx * VW;
          if constexpr (VW == 4) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            bv[4 * h + 0][kk] = v.x;
            bv[4 * h + 1][kk] = v.y;
            bv[4 * h + 2][kk] = v.z;
            bv[4 * h + 3][kk] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(src);
            bv[2 * h + 0][kk] = v.x;
            bv[2 * h + 1][kk] = v.y;
          }
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i][kk], bv[j][kk], acc[i][j]);
    }
  }
  cp_wait<0>();

  // y = acc + bias (ReLU), or this split's partial
  float* out = n_split == 1 ? y : part + (size_t)split * s.M * s.Cout;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + col_of<VW>(tx, j);
    if (n >= s.npg) continue;
    const float bn = n_split == 1 && bias ? bias[cout0 + n] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + row_of(ty, i);
      if (m >= s.M) continue;
      float v = acc[i][j];
      if (n_split == 1) {
        v += bn;
        if (s.relu) v = relu_keep_nan(v);
      }
      out[(size_t)m * s.Cout + cout0 + n] = v;
    }
  }
}

// y = the sum of the n_split partials, added in split order, + bias
// (ReLU).
__global__ void __launch_bounds__(256)
conv2d_fused_sum(const float* __restrict__ part,
                 const float* __restrict__ bias, float* __restrict__ y,
                 int M, int N, int n_split, int relu) {
  const size_t n = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < n_split; ++s) v += part[s * n + i];
    if (bias) v += bias[i % N];
    if (relu) v = relu_keep_nan(v);
    y[i] = v;
  }
}

template <int BN, bool VEC>
int launch(const float* x, const float* w, const float* bias, float* y,
           float* part, const Shape& s, int groups, int n_split,
           cudaStream_t stream) {
  constexpr int BYTES = 4 * STAGES * (BM * PAD + BK * BN);
  const auto kernel = conv2d_fused_kernel<BN, VEC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s.M + BM - 1) / BM, groups * s.n_tiles, n_split);
  kernel<<<grid, THREADS, BYTES, stream>>>(x, w, bias, y, part, s);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_vec(const float* x, const float* w, const float* bias, float* y,
               float* part, const Shape& s, int groups, int n_split,
               bool vec_a, cudaStream_t stream) {
  return vec_a ? launch<BN, true>(x, w, bias, y, part, s, groups, n_split,
                                  stream)
               : launch<BN, false>(x, w, bias, y, part, s, groups, n_split,
                                   stream);
}

}  // namespace

// x (B,H,W,Cin), w (K,K,Cin/groups,Cout), bias (Cout,) or null,
// y (B,OH,OW,Cout); all fp32, contiguous, on the current device.  bn (64
// or 96) is the output tile's width; n_split >= 1 blocks share each
// tile's reduction, and above 1 part is fp32 scratch of n_split * B * OH *
// OW * Cout and no split may be empty (conv2d/ops.py::conv_tiles).  The
// caller checks shapes and that every offset fits in 32 bits.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); no sync.
extern "C" int conv2d_fused_f32(const float* x, const float* w,
                                const float* bias, float* y, float* part,
                                int B, int H, int W, int Cin, int OH, int OW,
                                int Cout, int K, int stride, int pad,
                                int groups, int relu, int bn, int n_split,
                                void* stream) {
  if (n_split < 1 || (n_split > 1 && !part)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Shape s;
  s.H = H; s.W = W; s.Cin = Cin;
  s.OH = OH; s.OW = OW; s.Cout = Cout;
  s.K = K; s.stride = stride; s.pad = pad;
  s.Cg = Cin / groups;
  s.npg = Cout / groups;
  s.M = B * OH * OW;
  s.Kdim = K * K * s.Cg;
  s.n_tiles = (s.npg + bn - 1) / bn;
  s.relu = relu;
  // 16-byte copies: four channels of x, four columns of w's slab
  const bool vec_a = s.Cg % 4 == 0 && Cin % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  s.vec_b = s.npg % 4 == 0 && Cout % 4 == 0 &&
            reinterpret_cast<uintptr_t>(w) % 16 == 0;
  int e;
  switch (bn) {
    case 64:
      e = launch_vec<64>(x, w, bias, y, part, s, groups, n_split, vec_a, st);
      break;
    case 96:
      e = launch_vec<96>(x, w, bias, y, part, s, groups, n_split, vec_a, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e || n_split == 1) return e;
  conv2d_fused_sum<<<1024, 256, 0, st>>>(part, bias, y, s.M, Cout, n_split,
                                         relu);
  return (int)cudaGetLastError();
}
