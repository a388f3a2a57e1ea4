// Grouped implicit-GEMM convolution with fused bias + ReLU, bf16 operands
// and output, fp32 accumulation on the tensor cores, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/conv2d.py,
// _conv_fused_kernel (wrapper conv2d_fused) for bf16 operands, the ones
// the bf16 numerics preset feeds it: the TPU kernel upcasts each operand
// to fp32, dots in fp32, adds the bias in fp32, applies the ReLU and
// stores y in x's dtype.  A bf16 x bf16 product is exact in fp32, so the
// tensor cores (bf16 in, fp32 accumulate) compute the same sums up to
// their order, and the epilogue is the TPU kernel's: bias and ReLU in
// fp32 (a NaN kept through the ReLU), one rounding to bf16.  Layouts: x
// NHWC, w HWIO (K*K*Cg rows of Cout columns), output channels group-major.
//
// What bounds it on the H100: operations.  AlexNet's layers do 100 to 400
// FLOPs per byte of bf16 traffic against a bf16 tensor-core ridge of 989
// TFLOP/s over 3.35 TB/s = 295 FLOP/byte: conv1 (K*K*Cg = 363) sits at the
// ridge, conv2-5 above it, so the least time is about FLOPs / 989 TFLOP/s,
// and only wgmma reaches that rate.
//
// Two bodies; the caller picks one by shape before the launch
// (conv2d/ops.py::conv_route_bf16) and names it to the entry point, which
// refuses the wgmma body for a shape wgmma_route does not take (and there
// picks its A route), never switching bodies on its own:
//
// The wgmma body, for every shape with npg % 8 == 0 (whole 16-byte output
// pieces and TMA-legal weight rows), 16-byte aligned x, w, bias and y, and
// an A route below (all five convs of both AlexNets):
//  * A persistent grid of one block of 384 threads per SM (two on conv1's
//    route) walks the work units (a 128 x BN output tile of one group, and
//    one split's run of its reduction chunks) in a fixed order.  Two
//    consumer warpgroups of
//    64 rows each run wgmma.mma_async m64nBNk16 (A and B from shared
//    memory, fp32 accumulators in registers, BN/2 a thread); one producer
//    warpgroup fills a ring of STAGES stages, each guarded by a full and an
//    empty mbarrier, so no __syncthreads stands in the reduction, and runs
//    on into the next unit while the consumers finish one: a unit's first
//    loads hide behind the last one's products and epilogue.
//  * Whole-group tiles: BN is 64, 96, 128 or 192 (conv2d/ops.py::
//    conv_tiles_bf16 picks one that divides npg, from times taken by
//    kernel_sweep.py --kernels conv_bf16), so each A row is gathered once
//    per (M tile, group) or, for conv3's 384 channels, once per 192 or 128.
//  * Deep steps: a stage holds a chunk of 64 reduction columns, A 128 rows
//    x 128 bytes 128-byte swizzled (four k16 steps of wgmma between two
//    barrier waits), B 64 rows x BN.
//  * B, the weight slab's 64 x BN window of the group's columns, comes by
//    TMA (boxes of 64 rows x 64 columns, SW128, or x 32 columns, SW64,
//    where BN is 96); TMA's zero fill covers the k tail and columns past
//    Cout.  Its wgmma descriptor is MN-major.
//  * A, the implicit im2col, goes by one of two routes (no TMA im2col mode):
//    - pieces (Cg % 8 == 0: conv2-5): 16-byte cp.async copies of 8
//      channels of one tap straight into the swizzled layout, eight
//      producer threads to a row, so a warp's copy reads four rows' 128
//      contiguous bytes; taps outside the image, rows past M and k past
//      K*K*Cg copy 0 bytes and so read as zeros.
//      cp.async.mbarrier.arrive.noinc completes each thread's share of the
//      stage's full barrier when its copies land (so every stage's copies
//      stay in flight; waiting for them in the producer ran slower), and
//      the consumers fence the async proxy before the products read them.
//    - rows (groups 1, no padding, K * Cin <= ROW_RUN = 37: conv1, Cin 3, K
//      11, stride 4): one chunk is one kh, whose K * Cin = 33 values are
//      contiguous in NHWC x for each pixel.  Producer thread r copies its
//      pixel's run raw with 8-byte cp.async from the 8-byte word it starts
//      in, RUN_AHEAD chunks ahead, into a slot of its own (a run starts on
//      any 2-byte boundary: rows of x are 1,362 bytes apart on conv1; the
//      last word reads only up to the run's end and zero-fills the rest, so
//      no copy reads past x's last value), then shifts it into tile row r (a
//      4-byte-aligned read and a funnel shift a word), zero past the run (the
//      pieces past it are zeroed once), and one lane a warp arrives; the
//      consumers fence the async proxy (a fence in the producer would wait
//      for its later copies in flight).  The weight rows of one kh are a 33 x
//      Cout plane of a 3-d tensor map whose box of 64 rows reads zeros past
//      row 33.  conv1's units are short (11 chunks), so at widths up to 96 an
//      SM holds two blocks (BLOCKS), and one block's epilogue and next unit's
//      start overlap the other's products.  (A strip of whole input rows, as
//      the TPU kernel stages a padded image in VMEM, ran 1.6 times slower on
//      the H100: its copies' addressing and the producer's named barrier cost
//      more than the bytes it saves.)
//  * Epilogue: bias, ReLU and one rounding to bf16 in registers; each
//    consumer warp stages its 16 rows 32 columns at a time in a buffer of
//    its own (the ring already holds the next unit's chunks; a whole
//    staged tile would cost the ring a stage) and stores them in 16-byte
//    pieces, full 32-byte sectors.
//  * Small grids (the serving batch): the reduction's chunks are dealt out
//    over n_split units a tile; each writes its fp32 partial from the
//    accumulators, and a second kernel adds them in split order, adds the
//    bias, applies the ReLU and rounds once.  No atomics, and each unit's
//    sums run in a fixed order: two calls agree bit for bit.
//
// The mma.sync body, for every other shape (npg not a multiple of 8, Cg
// not a multiple of 8 outside the rows route): a block of 256 threads
// owns a 128 x 64 or 128 x 96 tile; the reduction advances 16 columns a
// stage through a cp.async ring (A gathered in 16-byte copies where Cg and
// Cin are multiples of 8, element by element otherwise), each warp runs
// mma.sync.m16n8k16 on ldmatrix fragments; taps outside the image, rows
// past M and the k tail are zero-filled in shared memory; split-K as
// above.  conv2d/ops.py::conv_tiles picks its width and split.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "../../flash_attention/csrc/flash_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// --------------------------------------------------------- the mma.sync body
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
  int relu, vec_b;      // the mma.sync body's 16-byte copies of w
  int chunks, L;        // the wgmma body's chunks; its rows route's run
  int groups, n_split;  // the wgmma body's (the mma.sync body reads its grid)
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

// ---------------------------------------------------------- the wgmma body
constexpr int WG_BM = 128;        // output pixels per block: 64 a consumer
constexpr int WG_BK = 64;         // reduction columns per stage
constexpr int WG_THREADS = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int WG_CONSUMERS = 256;
constexpr int ROUTE_PIECES = 0;   // A in 16-byte cp.async pieces
constexpr int ROUTE_ROWS = 1;     // A as one contiguous run per (pixel, kh)

// The rows route: each producer thread copies its pixel's run of K * Cin
// values for one kh raw (8-byte aligned cp.async into a RUN_SLOT-byte slot
// of its own), RUN_AHEAD chunks ahead, so runs of up to ROW_RUN values
constexpr int ROW_RUN = 37;
constexpr int RUN_SLOT = 8 * ((3 + ROW_RUN + 3) / 4);   // 80

template <int BN, int ROUTE>
struct WgLayout {
  // blocks an SM holds: two on the rows route at widths up to 96 (conv1:
  // its units are short, so one block's epilogue and next unit's start
  // overlap the other's products), else one
  static constexpr int BLOCKS = ROUTE == ROUTE_ROWS && BN <= 96 ? 2 : 1;
  static constexpr int RUN_AHEAD = BLOCKS == 2 ? 2 : 4;
  static constexpr int RUN_STAGES = RUN_AHEAD + 1;
  static constexpr int BW = BN % 64 == 0 ? 64 : 32;   // B panel's columns
  static constexpr int SWIZZLE = BW == 64 ? 1 : 2;    // SW128 or SW64
  static constexpr int PANEL = WG_BK * BW * 2;        // bytes of one panel
  static constexpr int KSTEP = 16 * BW * 2;           // one k16 step down
  static constexpr int SBO = 8 * BW * 2;              // 8 rows down
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;
  static constexpr int B_BYTES = WG_BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // each consumer warp stages 16 rows x 32 columns of bf16 at a time
  static constexpr int OUT_PITCH = 32 + 8;
  static constexpr int OUT_BYTES = WG_CONSUMERS / 32 * 16 * OUT_PITCH * 2;
  // (+ 256: a run's last words may be read past its slot's end)
  static constexpr int RAW_BYTES =
      ROUTE == ROUTE_ROWS ? RUN_STAGES * WG_BM * RUN_SLOT + 256 : 0;
  static constexpr int FIT =
      (227 * 1024 / BLOCKS - 1024 - 256 - RAW_BYTES - OUT_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  // the ring, the staged output tile, full[STAGES] and empty[STAGES]
  // mbarriers, the rows route's runs; + 1 KB to align the base to 1024
  static constexpr int OUT_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = OUT_OFF + OUT_BYTES;
  static constexpr int RAW_OFF = BAR_OFF + 16 * STAGES;
  static constexpr int BYTES = RAW_OFF + RAW_BYTES + 1024;
  static_assert(BN % BW == 0 && BN % 32 == 0 && BN <= 256, "a wgmma width");
  static_assert(STAGES >= 2 && BYTES <= 227 * 1024 / BLOCKS, "the ring fits");
};

// 8 bytes into shared memory, of which the first `bytes` (1 to 8) are read
// from src and the rest zero-filled.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Byte offset of 16-byte piece j of tile row r in the 128-byte swizzled
// layout (chunk j sits at j ^ (r % 8); 8-row groups 1024 bytes apart).
__device__ __forceinline__ uint32_t swizzled(int r, int j) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((j ^ (r & 7)) << 4);
}

// B of global chunk `chunk` into the stage at sa (columns n .. n + BN - 1),
// one TMA box per panel, completing on `full` with the bytes it expects.
template <int BN, int ROUTE>
__device__ __forceinline__ void load_b(const CUtensorMap* tw, uint32_t sa,
                                       uint32_t full, int n, int chunk) {
  using L = WgLayout<BN, ROUTE>;
  sm90::bar_arrive_tx(full, L::B_BYTES);
#pragma unroll
  for (int p = 0; p < BN / L::BW; ++p) {
    const uint32_t dst = sa + L::A_BYTES + p * L::PANEL;
    if (ROUTE == ROUTE_PIECES)
      sm90::tma_load(dst, tw, full, n + p * L::BW, chunk * WG_BK, 0);
    else
      sm90::tma_load(dst, tw, full, n + p * L::BW, 0, chunk);
  }
}

// One work unit of the persistent grid: a 128-row M tile, tile nt of
// group g's output channels, and split `split`'s run [c_lo, c_lo + n_c) of
// the reduction chunks.  Units go N tile fastest, then M tile, then split.
struct Unit {
  int m0, g, nt, split, c_lo, n_c;
  __device__ __forceinline__ Unit(int u, const Shape& s) {
    const int gt = s.n_tiles * s.groups;
    const int n_mt = (s.M + WG_BM - 1) / WG_BM;
    const int t = u % gt, rest = u / gt;
    m0 = rest % n_mt * WG_BM;
    split = rest / n_mt;
    g = t / s.n_tiles;
    nt = t % s.n_tiles;
    const int per = (s.chunks + s.n_split - 1) / s.n_split;
    c_lo = split * per;
    n_c = max(0, min(s.chunks, c_lo + per) - c_lo);
  }
};

template <int BN, int ROUTE>
__global__ void __launch_bounds__(WG_THREADS, (WgLayout<BN, ROUTE>::BLOCKS))
conv2d_fused_bf16_wgmma(const __grid_constant__ CUtensorMap tw,
                        const bf16* __restrict__ x,
                        const bf16* __restrict__ bias, bf16* __restrict__ y,
                        float* __restrict__ part, const Shape s) {
  using L = WgLayout<BN, ROUTE>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw_base);
  const uint32_t full0 = base + L::BAR_OFF, empty0 = full0 + 8 * STAGES;
  const int tid = threadIdx.x;
  const int n_units =
      (s.M + WG_BM - 1) / WG_BM * s.n_tiles * s.groups * s.n_split;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      // full: the producer's 128 threads on the pieces route (each
      // arrives once its copies land) or its 4 warps on the rows route,
      // and thread 0's expect_tx for B; empty: the consumers' 8 warps
      sm90::bar_init(full0 + 8 * st,
                     (ROUTE == ROUTE_PIECES ? 128 : 4) + 1);
      sm90::bar_init(empty0 + 8 * st, WG_CONSUMERS / 32);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (tid >= WG_CONSUMERS) {
    // ---- the producer warpgroup: it runs ahead across work units, so a
    // unit's first chunks load while the consumers finish the last one
    const int pt = tid - WG_CONSUMERS;
    int q = 0;   // chunks this block has produced
    // rows route: chunk p's A is written; one arrival a warp.  (No proxy
    // fence here: with later chunks' copies in flight, a fence in this
    // thread waits for them, a chunk's whole latency; the consumers fence.)
    auto landed = [&](int p) {
      __syncwarp();
      if ((pt & 31) == 0) sm90::bar_arrive(full0 + 8 * (p % STAGES));
    };
    if (ROUTE == ROUTE_ROWS) {
      // columns past the run (pieces P..7 of every row) stay zero
      const int P = (s.L + 7) / 8;
      for (int st = 0; st < STAGES; ++st)
        for (int j = P; j < WG_BK / 8; ++j)
          st_shared_v4(base + st * L::STAGE + swizzled(pt, j), 0u, 0u, 0u,
                       0u);
    }
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const Unit w(u, s);
      const int n0 = w.nt * BN, cout0 = w.g * s.npg;
      if (ROUTE == ROUTE_PIECES) {
        // thread pt copies piece j = pt % 8 of tile rows pt / 8 + 16 i: one
        // warp's copy covers four rows' 128 contiguous bytes of a tap
        const int j = pt & 7, rb = pt >> 3;
        // each row's window origin and the offset in x of its tap (0, 0),
        // channel 0 of the group; a row past M fails every bounds test
        int ih0[8], iw0[8], off[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = w.m0 + rb + 16 * i;
          int oh = 0, ow = 0, b = 0;
          if (m < s.M) {
            ow = m % s.OW;
            const int t = m / s.OW;
            oh = t % s.OH;
            b = t / s.OH;
          }
          ih0[i] = m < s.M ? oh * s.stride - s.pad : INT_MIN / 2;
          iw0[i] = ow * s.stride - s.pad;
          off[i] = ((b * s.H + oh * s.stride - s.pad) * s.W + iw0[i]) *
                       s.Cin + w.g * s.Cg;
        }
        // this thread's k (= (kh * K + kw) * Cg + c), advanced a chunk at
        // a time; Cg % 8 == 0, so a piece never straddles two taps
        int k = w.c_lo * WG_BK + 8 * j;
        KPos kp;
        {
          const int tap = k / s.Cg;
          kp.c = k - tap * s.Cg;
          kp.kh = tap / s.K;
          kp.kw = tap - kp.kh * s.K;
        }
        const int dtap = WG_BK / s.Cg, dc = WG_BK - dtap * s.Cg;
        for (int c = 0; c < w.n_c; ++c, ++q) {
          const int st = q % STAGES;
          sm90::bar_wait(empty0 + 8 * st, ((q / STAGES) & 1) ^ 1);
          const uint32_t sa = base + st * L::STAGE, full = full0 + 8 * st;
          if (pt == 0)
            load_b<BN, ROUTE>(&tw, sa, full, cout0 + n0, w.c_lo + c);
          const bool k_ok = k < s.Kdim;
          const int koff = (kp.kh * s.W + kp.kw) * s.Cin + kp.c;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int ih = ih0[i] + kp.kh, iw = iw0[i] + kp.kw;
            const bool in = k_ok && (unsigned)ih < (unsigned)s.H &&
                            (unsigned)iw < (unsigned)s.W;
            cp_async16(sa + swizzled(rb + 16 * i, j),
                       in ? x + (off[i] + koff) : x, in ? 16 : 0);
          }
          // this thread's share of the stage arrives once its copies land
          sm90::cp_async_arrive_noinc(full);
          k += WG_BK;
          kp.advance(dtap, dc, s.Cg, s.K);
        }
      } else {
        // thread pt builds tile row pt from its pixel's run of s.L values
        // for one kh, copied raw with 8-byte cp.async from the word it
        // starts in (a run starts on any 2-byte boundary: rows of x are
        // 1,362 bytes apart on conv1), RUN_AHEAD chunks ahead into a slot
        // of its own, then shifted into place: a 4-byte-aligned read and a
        // funnel shift a word
        const int m = w.m0 + pt;
        const bool live = m < s.M;
        int oh = 0, ow = 0, b = 0;
        if (live) {
          ow = m % s.OW;
          const int t = m / s.OW;
          oh = t % s.OH;
          b = t / s.OH;
        }
        // element offset of (kh = c_lo, kw = 0, c = 0) of this pixel's
        // window, and one kh down
        const int e0 =
            ((b * s.H + oh * s.stride + w.c_lo) * s.W + ow * s.stride) *
            s.Cin;
        const int step = s.W * s.Cin;
        const uint32_t slot0 = base + L::RAW_OFF + pt * RUN_SLOT;
        const int P = (s.L + 7) / 8;          // pieces that hold the run
        const int last = (s.L - 1) / 2;       // the word with value L - 1
        const uint32_t keep = s.L & 1 ? 0xffffu : 0xffffffffu;
        auto issue = [=](int c) {
          const int e = e0 + c * step;
          // bytes from the word the run starts in to the run's end: the
          // last word stops there (the run may end at x's last value)
          const int end = 2 * ((e & 3) + s.L);
          const bf16* src = x + (e & ~3);
          const uint32_t dst = slot0 + (c % L::RUN_STAGES) * (WG_BM * RUN_SLOT);
#pragma unroll
          for (int i = 0; i < RUN_SLOT / 8; ++i)
            if (live && 8 * i < end)
              cp_async8(dst + 8 * i, src + 4 * i, min(8, end - 8 * i));
        };
#pragma unroll
        for (int c = 0; c < L::RUN_AHEAD; ++c) {
          if (c < w.n_c) issue(c);
          cp_commit();
        }
        for (int c = 0; c < w.n_c; ++c, ++q) {
          if (c + L::RUN_AHEAD < w.n_c) issue(c + L::RUN_AHEAD);
          cp_commit();
          cp_wait<L::RUN_AHEAD>();   // chunk c's run has landed
          // the run's 4-byte words from the one it starts in, shifted by a
          // value where it starts on an odd one
          const int sh = (e0 + c * step) & 3;
          const uint32_t at = slot0 + (c % L::RUN_STAGES) * (WG_BM * RUN_SLOT) +
                              4 * (sh >> 1);
          const int shift = 16 * (sh & 1);
          uint32_t v[4 * (WG_BK / 8) + 1];
#pragma unroll
          for (int i = 0; i <= 4 * (WG_BK / 8); ++i)
            v[i] = live && i <= 4 * P ? ld_shared_b32(at + 4 * i) : 0u;
          const int st = q % STAGES;
          sm90::bar_wait(empty0 + 8 * st, ((q / STAGES) & 1) ^ 1);
          const uint32_t sa = base + st * L::STAGE, full = full0 + 8 * st;
          if (pt == 0)
            load_b<BN, ROUTE>(&tw, sa, full, cout0 + n0, w.c_lo + c);
#pragma unroll
          for (int j = 0; j < WG_BK / 8; ++j) {
            if (j >= P) break;
            uint32_t qv[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              // values 2i, 2i + 1; zeros past the run's last value
              const int i = 4 * j + t;
              const uint32_t val = __funnelshift_r(v[i], v[i + 1], shift);
              qv[t] = i < last ? val : (i == last ? val & keep : 0u);
            }
            st_shared_v4(sa + swizzled(pt, j), qv[0], qv[1], qv[2], qv[3]);
          }
          landed(q);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups: tile rows 64 wg .. 64 wg + 63
  const int wg = tid / 128, lane = tid % 32;
  // accumulator (flash_sm90.cuh): rows r0, r0 + 8, columns 8 j + cq, + 1
  const int r0 = wg * 64 + (tid % 128 / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // this warp's staging buffer and its first tile row
  bf16* const wtile = reinterpret_cast<bf16*>(smem + L::OUT_OFF) +
                      tid / 32 * 16 * L::OUT_PITCH;
  const int wrow = wg * 64 + tid % 128 / 32 * 16;
  int q = 0;   // chunks this block has consumed
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const Unit w(u, s);
    const int n0 = w.nt * BN, cout0 = w.g * s.npg;
    // this thread's bias pairs, loaded now so that their latency hides
    // behind the unit's products (bf16 pairs: BN / 8 registers)
    uint32_t bpair[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + cq;   // npg % 8 == 0: n + 1 is in too
      bpair[j] = bias && s.n_split == 1 && n < s.npg
                     ? *reinterpret_cast<const uint32_t*>(bias + cout0 + n)
                     : 0u;
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    sm90::pin(acc);
    for (int c = 0; c < w.n_c; ++c, ++q) {
      const int st = q % STAGES;
      sm90::bar_wait(full0 + 8 * st, (q / STAGES) & 1);
      // the producer's writes (cp.async, or its shifted runs) were made by
      // other threads in the generic proxy: order them before this
      // thread's wgmma reads
      sm90::fence_proxy_async();
      const uint32_t sa = base + st * L::STAGE + wg * (WG_BM / 2) * 128;
      const uint32_t sb = base + st * L::STAGE + L::A_BYTES;
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        sm90::WgmmaT<BN>::ss(
            acc, sm90::kmajor(sa + 32 * kk),
            sm90::desc(sb + kk * L::KSTEP, L::PANEL, L::SBO, L::SWIZZLE), 1);
      sm90::wg_commit();
      // chunk c - 1's products are done: its stage goes back to the
      // producer
      sm90::wg_wait<1>();
      if (c > 0 && lane == 0)
        sm90::bar_arrive(empty0 + 8 * ((q - 1) % STAGES));
    }
    sm90::wg_wait<0>();
    sm90::pin(acc);
    if (w.n_c > 0 && lane == 0)
      sm90::bar_arrive(empty0 + 8 * ((q - 1) % STAGES));

    if (s.n_split > 1) {
      // this split's fp32 partial, straight from the accumulators
      float* out = part + (size_t)w.split * s.M * s.Cout + cout0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + cq;
        if (n >= s.npg) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = w.m0 + r0 + 8 * i;
          if (m < s.M)
            *reinterpret_cast<float2*>(out + (size_t)m * s.Cout + n) =
                make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
      continue;
    }
    // y = acc + bias (ReLU) in fp32, rounded once to bf16; each warp
    // stages its 16 rows 32 columns at a time in its own buffer and stores
    // them 16 bytes (8 columns of one row) a lane: full 32-byte sectors,
    // and no barrier beyond the warp
#pragma unroll
    for (int cb = 0; cb < BN / 32; ++cb) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * cb + jj;
        const float b0 = __uint_as_float(bpair[j] << 16);
        const float b1 = __uint_as_float(bpair[j] & 0xffff0000u);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v0 = acc[4 * j + 2 * i] + b0;
          float v1 = acc[4 * j + 2 * i + 1] + b1;
          if (s.relu) {
            v0 = relu_keep_nan(v0);
            v1 = relu_keep_nan(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              wtile + (lane / 4 + 8 * i) * L::OUT_PITCH + 8 * jj + cq) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane / 4 + 8 * h, m = w.m0 + wrow + r;
        const int n = n0 + 32 * cb + 8 * (lane % 4);
        if (m < s.M && n < s.npg)
          *reinterpret_cast<uint4*>(y + (size_t)m * s.Cout + cout0 + n) =
              *reinterpret_cast<const uint4*>(wtile + r * L::OUT_PITCH +
                                              8 * (lane % 4));
      }
      __syncwarp();
    }
  }
}

// How the wgmma body gathers A for this shape (ROUTE_PIECES or ROUTE_ROWS),
// or -1 where it takes none (conv2d/ops.py::conv_route_bf16 then picks the
// mma.sync body).
int wgmma_route(int Cin, int Cout, int K, int pad, int groups, const void* x,
                const void* w, const void* bias, const void* y,
                const void* part) {
  const int Cg = Cin / groups, npg = Cout / groups;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(y) |
      reinterpret_cast<uintptr_t>(part);
  if (npg % 8 != 0 || addr % 16 != 0) return -1;
  if (Cg % 8 == 0) return ROUTE_PIECES;
  if (groups == 1 && pad == 0 && K * Cin <= ROW_RUN) return ROUTE_ROWS;
  return -1;
}

template <int BN, int ROUTE>
int launch_wg(const bf16* x, const bf16* w, const bf16* bias, bf16* y,
              float* part, const Shape& s, int groups, int n_split,
              cudaStream_t stream) {
  using L = WgLayout<BN, ROUTE>;
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  // w as planes of rows x Cout: one plane of K*K*Cg rows (pieces), or K
  // planes (kh) of K*Cin rows (rows); boxes of 64 rows x BW columns, and
  // rows past a plane's end read as zeros
  const bool rows = ROUTE == ROUTE_ROWS;
  const cuuint64_t n_rows = rows ? s.L : s.Kdim;
  const cuuint64_t dims[3] = {(cuuint64_t)s.Cout, n_rows,
                              (cuuint64_t)(rows ? s.K : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)s.Cout * 2,
                                 n_rows * s.Cout * 2};
  const cuuint32_t box[3] = {(cuuint32_t)L::BW, WG_BK, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(w), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::SWIZZLE == 1 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const auto kernel = conv2d_fused_bf16_wgmma<BN, ROUTE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return (int)e;
  // a persistent grid: as many blocks as the SMs hold, each walking the
  // work units
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t q = cudaGetDevice(&dev);
  if (q == cudaSuccess)
    q = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (q == cudaSuccess)
    q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      WG_THREADS, L::BYTES);
  if (q != cudaSuccess) return (int)q;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int units = (s.M + WG_BM - 1) / WG_BM * s.n_tiles * groups * n_split;
  const int blocks = per_sm * sms;
  kernel<<<units < blocks ? units : blocks, WG_THREADS, L::BYTES, stream>>>(
      map, x, bias, y, part, s);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_wg_route(const bf16* x, const bf16* w, const bf16* bias, bf16* y,
                    float* part, const Shape& s, int groups, int n_split,
                    int route, cudaStream_t stream) {
  return route == ROUTE_ROWS
             ? launch_wg<BN, ROUTE_ROWS>(x, w, bias, y, part, s, groups,
                                         n_split, stream)
             : launch_wg<BN, ROUTE_PIECES>(x, w, bias, y, part, s, groups,
                                           n_split, stream);
}

}  // namespace

// x (B,H,W,Cin), w (K,K,Cin/groups,Cout), bias (Cout,) or null,
// y (B,OH,OW,Cout); all bf16, contiguous, on the current device.  `body`
// is the body the caller picked (conv2d/ops.py::conv_plan_bf16): 1 the
// wgmma body (refused where wgmma_route gives no A route), 2 the mma.sync
// body; anything else is refused.  bn is the output tile's
// width: 64, 96, 128 or 192 for the wgmma body
// (conv2d/ops.py::conv_tiles_bf16), 64 or 96 for the mma.sync body
// (conv_tiles).  n_split >= 1 blocks share each tile's reduction chunks
// (WG_BK columns, or one kh on the rows route; BK on the mma.sync body);
// above 1 part is fp32 scratch of n_split * B * OH * OW * Cout and no
// split may be empty.  The caller checks shapes and that every offset
// fits in 32 bits.  Launches on `stream` and returns cudaGetLastError() (0
// on success); no sync.
extern "C" int conv2d_fused_bf16(const bf16* x, const bf16* w,
                                 const bf16* bias, bf16* y, float* part,
                                 int B, int H, int W, int Cin, int OH, int OW,
                                 int Cout, int K, int stride, int pad,
                                 int groups, int relu, int bn, int n_split,
                                 int body, void* stream) {
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
  s.L = K * Cin;
  s.groups = groups;
  s.n_split = n_split;
  int e;
  if (body == 1) {
    const int route =
        wgmma_route(Cin, Cout, K, pad, groups, x, w, bias, y, part);
    if (route < 0) return (int)cudaErrorInvalidValue;
    s.chunks = route == ROUTE_ROWS ? K : (s.Kdim + WG_BK - 1) / WG_BK;
    switch (bn) {
      case 64:
        e = launch_wg_route<64>(x, w, bias, y, part, s, groups, n_split,
                                route, st);
        break;
      case 96:
        e = launch_wg_route<96>(x, w, bias, y, part, s, groups, n_split,
                                route, st);
        break;
      case 128:
        e = launch_wg_route<128>(x, w, bias, y, part, s, groups, n_split,
                                 route, st);
        break;
      case 192:
        e = launch_wg_route<192>(x, w, bias, y, part, s, groups, n_split,
                                 route, st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else if (body == 2) {
    // 16-byte copies: eight channels of x, eight columns of w's slab
    const bool vec_a = s.Cg % 8 == 0 && Cin % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
    s.vec_b = s.npg % 8 == 0 && Cout % 8 == 0 &&
              reinterpret_cast<uintptr_t>(w) % 16 == 0;
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
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e || n_split == 1) return e;
  conv2d_fused_bf16_sum<<<1024, 256, 0, st>>>(part, bias, y, s.M, Cout,
                                              n_split, relu);
  return (int)cudaGetLastError();
}
