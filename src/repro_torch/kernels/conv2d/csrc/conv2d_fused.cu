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
// least time is FLOPs / 67 TFLOP/s.  This first kernel runs on the fp32
// FMA pipes (no TF32, so it matches the reference at 2e-4); wgmma / TMA /
// tensor-core variants are later work.
//
// What the design does about it:
//  * Per group g the conv is a GEMM  Y_g[m, n] = sum_k A_g[m, k] W_g[k, n]
//    with m = (b, oh, ow), n in the group's Cout/G channels and
//    k = (kh, kw, c) over the group's Cg input channels.  HWIO weights
//    are already that (K*K*Cg, Cout) matrix, row-major, so group g's slab
//    is columns [g*Cout/G, (g+1)*Cout/G): no weight reshape per call.
//  * A block owns a 64 x 64 output tile of ONE group and reads only that
//    group's input channels (the Pallas index maps' group routing).
//  * A is gathered on the fly from x into shared memory, BK = 16 values
//    of k at a time.  The reduction runs over the flattened K*K*Cg (363
//    for conv1, whose Cg = 3 would make a per-offset dot 3 deep).
//    Consecutive threads load consecutive k, which are consecutive
//    channels (or, for Cg = 3, consecutive pixels of one image row), so
//    loads coalesce.
//  * Zero padding is a bounds check on the window: out-of-image taps
//    read as 0, and x is never padded in device memory.
//  * Each of the 256 threads keeps a 4 x 4 register tile of fp32
//    accumulators (rows ty + 16 i, columns tx + 16 j: conflict-free
//    shared-memory reads, coalesced stores).  The next chunk's global
//    loads are issued into registers before the current chunk's FMAs.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output pixels per block (GEMM rows)
constexpr int BN = 64;       // output channels per block, inside a group
constexpr int BK = 16;       // reduction chunk over (kh, kw, c)
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

struct Shape {
  int H, W, Cin;        // input (B, H, W, Cin), NHWC
  int OH, OW, Cout;     // output (B, OH, OW, Cout), NHWC
  int K, stride, pad;   // square window
  int Cg, npg;          // input / output channels per group
  int M, Kdim;          // B*OH*OW, K*K*Cg
  int n_tiles;          // BN-wide tiles per group
  int relu;
};

__global__ void __launch_bounds__(THREADS)
conv2d_fused_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    const Shape s) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int g = blockIdx.y / s.n_tiles;
  const int n0 = (blockIdx.y % s.n_tiles) * BN;
  const int cin0 = g * s.Cg;          // the group's first input channel
  const int cout0 = g * s.npg;        // ... and first output channel

  // A loads: this thread's k column and its 4 output pixels
  const int a_k = tid % BK;
  int a_base[4], a_ih0[4], a_iw0[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tid / BK + 16 * i;
    a_ok[i] = m < s.M;
    const int mm = a_ok[i] ? m : 0;
    const int ow = mm % s.OW;
    const int t = mm / s.OW;
    const int oh = t % s.OH;
    const int b = t / s.OH;
    a_base[i] = b * s.H * s.W * s.Cin + cin0;
    a_ih0[i] = oh * s.stride - s.pad;
    a_iw0[i] = ow * s.stride - s.pad;
  }
  // B loads: this thread's output channel and its 4 k rows
  const int b_n = n0 + tid % BN;
  const int b_k = tid / BN;
  const bool b_ok = b_n < s.npg;

  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int k = k0 + a_k;
    int c = 0, kh = 0, kw = 0;
    const bool k_ok = k < s.Kdim;
    if (k_ok) {
      c = k % s.Cg;
      const int q = k / s.Cg;
      kh = q / s.K;
      kw = q - kh * s.K;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = a_ih0[i] + kh, iw = a_iw0[i] + kw;
      const bool ok = k_ok && a_ok[i] && ih >= 0 && ih < s.H && iw >= 0 &&
                      iw < s.W;
      ra[i] = ok ? x[a_base[i] + (ih * s.W + iw) * s.Cin + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + b_k + 4 * i;
      rb[i] = (b_ok && kr < s.Kdim) ? w[kr * s.Cout + cout0 + b_n] : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[a_k][tid / BK + 16 * i] = ra[i];
      Bs[b_k + 4 * i][tid % BN] = rb[i];
    }
  };

  float acc[4][4] = {};
  load(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < s.Kdim; k0 += BK) {
    const bool more = k0 + BK < s.Kdim;
    if (more) load(k0 + BK);   // in flight while the FMAs below run
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= s.npg) continue;
    const float bn = bias ? bias[cout0 + n] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= s.M) continue;
      float v = acc[i][j] + bn;
      if (s.relu) v = fmaxf(v, 0.f);
      y[m * s.Cout + cout0 + n] = v;
    }
  }
}

}  // namespace

// x (B,H,W,Cin), w (K,K,Cin/groups,Cout), bias (Cout,) or null,
// y (B,OH,OW,Cout); all fp32, contiguous, on the current device.  The
// caller checks shapes and that every offset fits in 32 bits.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); no sync.
extern "C" int conv2d_fused_f32(const float* x, const float* w,
                                const float* bias, float* y, int B, int H,
                                int W, int Cin, int OH, int OW, int Cout,
                                int K, int stride, int pad, int groups,
                                int relu, void* stream) {
  Shape s;
  s.H = H; s.W = W; s.Cin = Cin;
  s.OH = OH; s.OW = OW; s.Cout = Cout;
  s.K = K; s.stride = stride; s.pad = pad;
  s.Cg = Cin / groups;
  s.npg = Cout / groups;
  s.M = B * OH * OW;
  s.Kdim = K * K * s.Cg;
  s.n_tiles = (s.npg + BN - 1) / BN;
  s.relu = relu;
  const dim3 grid((s.M + BM - 1) / BM, groups * s.n_tiles);
  conv2d_fused_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, w, bias,
                                                                   y, s);
  return (int)cudaGetLastError();
}
