// Grouped implicit-GEMM convolution with fused bias + ReLU, bf16 operands
// and output, fp32 accumulation on the tensor cores, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/conv2d.py,
// _conv_fused_kernel (wrapper conv2d_fused) for bf16 operands, the ones
// the bf16 numerics preset feeds it: the TPU kernel upcasts each operand
// to fp32, dots in fp32, adds the bias in fp32, applies the ReLU and
// stores y in x's dtype.  A bf16 x bf16 product is exact in fp32, so
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) computes the same sums up
// to their order, and the epilogue is the TPU kernel's: bias and ReLU in
// fp32, one rounding to bf16.
//
// What bounds it on the H100: operations.  AlexNet's layers do 50 to 200
// FLOPs per byte of fp32 traffic and twice that in bf16, against a bf16
// tensor-core ridge of 989 TFLOP/s over 3.35 TB/s = 295 FLOP/byte: conv1
// (K*K*Cg = 363) sits near the ridge, conv2-5 above it, so the least time
// is about FLOPs / 989 TFLOP/s.
//
// What the design does about it: it is conv2d_fused.cu (the fp32 kernel)
// with its FMA body replaced by warp-level tensor-core products; the
// gather, the ring, the tile rule and the split are that kernel's, so
// conv2d/ops.py::conv_tiles and conv_ranges pick for both.
//  * A block of 256 threads (8 warps, 4 along M x 2 along N) owns a
//    128 x BN output tile of one group (BN 64 or 96); a warp owns 32 rows
//    x BN/2 columns: 2 m16 tiles x BN/16 n8 tiles of fp32 accumulators.
//  * The reduction runs over the flattened K*K*Cg in chunks of 16 (one
//    k16 step of the mma) through a ring of STAGES shared-memory stages
//    filled by cp.async.  A rows are 24 bf16 apart and B rows BN + 8, so
//    the fragments load with ldmatrix (B transposed) free of bank
//    conflicts.
//  * The A gather goes in 16-byte copies of eight channels where Cg and
//    Cin are multiples of 8 (conv2-5; Cg 48 on conv2), and element by
//    element otherwise (conv1, Cin 3), with plain loads into shared
//    memory, since cp.async moves no fewer than 4 bytes.  The weight slab
//    goes in 16-byte copies of eight columns where the group's channels
//    allow (every AlexNet layer), element by element otherwise.
//  * Zero padding: taps outside the image, rows past M and the k tail past
//    K*K*Cg (conv1's 363 is not a multiple of 16) are zero-filled in
//    shared memory, in both A and B, so the mma adds exact zeros.
//  * Split-K as the fp32 kernel: each split writes its fp32 partial; a
//    second kernel adds them in split order, adds the bias, applies the
//    ReLU and rounds once to bf16.  No atomics: two calls agree bit for
//    bit.
// A simple kernel: no wgmma, TMA or warp specialisation yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;        // output pixels per block (GEMM rows)
constexpr int BK = 16;         // reduction chunk over (kh, kw, c): one k16
constexpr int A_STRIDE = 24;   // bf16 per A row in shared memory (48 bytes)
constexpr int THREADS = 256;   // 8 warps: 4 along M x 2 along N
constexpr int STAGES = 4;      // chunks in the ring

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

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed on the way into the registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// VEC: A copies move eight channels (16 bytes), one a thread (row tid / 2,
// k offset 8 * (tid % 2)); else single elements, eight rows a thread
// (tid / 16 + 16 r) at k offset tid % 16.
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv2d_fused_bf16_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w,
                         const bf16* __restrict__ bias, bf16* __restrict__ y,
                         float* __restrict__ part, const Shape s) {
  constexpr int B_STRIDE = BN + 8;          // bf16 per B row
  constexpr int A_ELEMS = BM * A_STRIDE;
  constexpr int STAGE = A_ELEMS + BK * B_STRIDE;
  constexpr int WN = BN / 2;                // columns per warp
  constexpr int NT = WN / 8;                // n8 tiles per warp
  constexpr int A_ROWS = VEC ? 1 : 8;       // rows a thread gathers
  constexpr int A_STEP = 16;
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const uint32_t s0 = smem_u32(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
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
  const int a_r0 = VEC ? tid / 2 : tid / 16;
  const int a_kk = VEC ? 8 * (tid % 2) : tid % 16;
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
  const bf16* wg = w + cout0 + n0;
  const int b_cols = min(BN, s.npg - n0);
  const bf16 zero = __float2bfloat16(0.f);

  auto load = [&](int c, int stage) {
    bf16* sa = smem + stage * STAGE;
    const uint32_t sa_u = s0 + 2 * stage * STAGE;
    const bool k_ok = a_k < s.Kdim;
    const int koff = (kp.kh * s.W + kp.kw) * s.Cin + kp.c;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int ih = a_ih0[i] + kp.kh, iw = a_iw0[i] + kp.kw;
      const bool in = k_ok && (unsigned)ih < (unsigned)s.H &&
                      (unsigned)iw < (unsigned)s.W;
      const int at = (a_r0 + A_STEP * i) * A_STRIDE + a_kk;
      if (VEC)
        cp_async16(sa_u + 2 * at, in ? x + (a_off[i] + koff) : x,
                   in ? 16 : 0);
      else
        sa[at] = in ? x[a_off[i] + koff] : zero;
    }
    const int k0 = (c_lo + c) * BK;
    bf16* sb = sa + A_ELEMS;
    const uint32_t sb_u = sa_u + 2 * A_ELEMS;
    if (s.vec_b) {
      constexpr int PIECES = BK * BN / 8;
      for (int e = tid; e < PIECES; e += THREADS) {
        const int k = e / (BN / 8), n = e % (BN / 8) * 8;
        const bool in = k0 + k < s.Kdim && n < b_cols;
        cp_async16(sb_u + 2 * (k * B_STRIDE + n),
                   in ? wg + (size_t)(k0 + k) * s.Cout + n : w,
                   in ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int it = 0; it < BK * BN / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int k = e / BN, n = e % BN;
        const bool in = k0 + k < s.Kdim && n < b_cols;
        sb[k * B_STRIDE + n] = in ? wg[(size_t)(k0 + k) * s.Cout + n] : zero;
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

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int c = 0; c < n_c; ++c) {
    cp_wait<STAGES - 2>();
    __syncthreads();   // chunk c is in; every thread is done with c - 1
    if (c + STAGES - 1 < n_c) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_commit();
    const uint32_t sa_u = s0 + 2 * (c % STAGES) * STAGE;
    const uint32_t sb_u = sa_u + 2 * A_ELEMS;
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = wm * 32 + mt * 16 + lane % 16;
      ldmatrix_x4(af[mt], sa_u + 2 * (row * A_STRIDE + (lane / 16) * 8));
    }
#pragma unroll
    for (int nq = 0; nq < NT / 2; ++nq) {
      uint32_t bfr[4];
      const int col = wn * WN + nq * 16 + (lane / 16) * 8;
      ldmatrix_x4_trans(bfr, sb_u + 2 * ((lane % 16) * B_STRIDE + col));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * nq], af[mt], bfr[0], bfr[1]);
        mma_bf16(acc[mt][2 * nq + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
  cp_wait<0>();

  // y = acc + bias (ReLU) in fp32, rounded once to bf16; or this split's
  // fp32 partial.  C fragment: rows gid and gid + 8, columns 2 tig, +1.
  const int gid = lane / 4, tig = lane % 4;
  float* out = n_split == 1 ? nullptr : part + (size_t)split * s.M * s.Cout;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + wn * WN + nt * 8 + 2 * tig;
    if (n >= s.npg) continue;
    const bool two = n + 1 < s.npg;
    float b0 = 0.f, b1 = 0.f;
    if (n_split == 1 && bias) {
      b0 = __bfloat162float(bias[cout0 + n]);
      if (two) b1 = __bfloat162float(bias[cout0 + n + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + gid + 8 * h;
        if (m >= s.M) continue;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        const size_t at = (size_t)m * s.Cout + cout0 + n;
        if (n_split > 1) {
          out[at] = v0;
          if (two) out[at + 1] = v1;
          continue;
        }
        v0 += b0;
        v1 += b1;
        if (s.relu) {
          v0 = relu_keep_nan(v0);
          v1 = relu_keep_nan(v1);
        }
        if (two && at % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(y + at) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          y[at] = __float2bfloat16(v0);
          if (two) y[at + 1] = __float2bfloat16(v1);
        }
      }
  }
}

// y = bf16(the sum of the n_split fp32 partials, added in split order,
// + bias (ReLU)).
__global__ void __launch_bounds__(256)
conv2d_fused_bf16_sum(const float* __restrict__ part,
                      const bf16* __restrict__ bias, bf16* __restrict__ y,
                      int M, int N, int n_split, int relu) {
  const size_t n = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < n_split; ++s) v += part[s * n + i];
    if (bias) v += __bfloat162float(bias[i % N]);
    if (relu) v = relu_keep_nan(v);
    y[i] = __float2bfloat16(v);
  }
}

template <int BN, bool VEC>
int launch(const bf16* x, const bf16* w, const bf16* bias, bf16* y,
           float* part, const Shape& s, int groups, int n_split,
           cudaStream_t stream) {
  constexpr int BYTES = 2 * STAGES * (BM * A_STRIDE + BK * (BN + 8));
  const auto kernel = conv2d_fused_bf16_kernel<BN, VEC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s.M + BM - 1) / BM, groups * s.n_tiles, n_split);
  kernel<<<grid, THREADS, BYTES, stream>>>(x, w, bias, y, part, s);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_vec(const bf16* x, const bf16* w, const bf16* bias, bf16* y,
               float* part, const Shape& s, int groups, int n_split,
               bool vec_a, cudaStream_t stream) {
  return vec_a ? launch<BN, true>(x, w, bias, y, part, s, groups, n_split,
                                  stream)
               : launch<BN, false>(x, w, bias, y, part, s, groups, n_split,
                                   stream);
}

}  // namespace

// x (B,H,W,Cin), w (K,K,Cin/groups,Cout), bias (Cout,) or null,
// y (B,OH,OW,Cout); all bf16, contiguous, on the current device.  bn (64
// or 96) is the output tile's width; n_split >= 1 blocks share each
// tile's reduction, and above 1 part is fp32 scratch of n_split * B * OH *
// OW * Cout and no split may be empty (conv2d/ops.py::conv_tiles).  The
// caller checks shapes and that every offset fits in 32 bits.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); no sync.
extern "C" int conv2d_fused_bf16(const bf16* x, const bf16* w,
                                 const bf16* bias, bf16* y, float* part,
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
  // 16-byte copies: eight channels of x, eight columns of w's slab
  const bool vec_a = s.Cg % 8 == 0 && Cin % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  s.vec_b = s.npg % 8 == 0 && Cout % 8 == 0 &&
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
  conv2d_fused_bf16_sum<<<1024, 256, 0, st>>>(part, bias, y, s.M, Cout,
                                              n_split, relu);
  return (int)cudaGetLastError();
}
