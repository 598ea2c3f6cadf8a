// The float32 convolutions of the descriptor net (CylindricalNet) and the
// cost-volume net (CostNet) in inference, as one implicit GEMM on the CUDA
// cores, with the epilogue of each convolution in its store.
//
// Replaces no TPU kernel.  The JAX package leaves these convolutions to XLA
// (buffer_tpu/nn/cylindrical.py:77, :131); the port had them in cuDNN, at
// about 42% of the card's float32 rate on these shapes (small outputs, 20 to
// 128 output channels, some layers sent to an FFT path).
//
// Contract: x is channels last and dense, [N, Din, Hin, Win, Cin]; w is
// PyTorch's [Cout, Cin, KD, KH, KW]; the convolution is valid (unpadded)
// with stride 1, out[n, od, oh, ow, co] = sum over ci and the taps (kd, kh,
// kw) of x[n, od + kd, oh + kh, ow + kw, ci] * w[co, ci, kd, kh, kw].  The
// GEMM's rows are the output positions (n, od, oh, ow), its columns the
// output channels, its depth Cin x taps.  Stores:
//   kPad:   v = relu((acc + bias - mean) * rsqrt(var + eps)) into the next
//           cylindrical convolution's padded input [N, Ho + 2, Wo + 2, Cout]
//           (Do = 1): interior (oh + 1, ow + 1), azimuth wrap columns 0 and
//           Wo + 1 (copies of ow = Wo - 1 and ow = 0), zero rows 0 and Ho + 1;
//   kDense: the same epilogue into [N, Do, Ho, Wo, Cout];
//   kBias:  acc + bias into [N, Cout, Do, Ho, Wo] (channels first: the last
//           convolution of each net, in the layout read after it).
// The bias is added after the sum, and the batch norm computed as PyTorch's
// CUDA kernel computes it in eval mode, each operation rounded on its own
// (--fmad=false); the sums use explicit fused multiply-adds (__fmaf_rn).
//
// Bound: float32 operations (67 TFLOP/s on an H100 SXM; every layer does
// 100 to 1000 operations a byte it must read or write).  Design:
// - a block of 256 threads owns BM output positions x BN output channels
//   (BN = 32, 64 or 128 after Cout, BM = 256 x 64 / BN), each thread an 8 x 8
//   register tile: rows 4 rg .. 4 rg + 3 and BM / 2 + the same, channels
//   4 cg .. 4 cg + 3 and BN / 2 + the same.  A depth step reads two float4s
//   of inputs and two of weights from shared memory for 64 fused
//   multiply-adds; a warp's reads touch 4 or 8 consecutive 16-byte words,
//   free of bank conflicts.  Fragments of 16 registers leave the thread
//   within 128 registers, so two blocks (16 warps) share an SM;
// - the depth advances a chunk at a time: TG taps (a group of 3 or 9, 4
//   for a 2 x 2 kernel) of 4 input channels, 4 TG deep, stored depth-major
//   ([4 TG][BM + 8] inputs, [4 TG][BN + 8] weights; the 8 floats of padding
//   keep the copies' 4 channels in distinct banks).  Both are 4-byte
//   cp.async copies: the inputs' 4 consecutive channels of a row (channels
//   last) by 4 consecutive threads, the weights' TG consecutive taps of one
//   (co, ci) (PyTorch's layout) by one thread.  Two stages: the next
//   chunk's copies are issued a tap at a time between the depth steps of
//   the current one (a burst of them at the chunk's start held the
//   multiply-adds back: 3.51 against 2.94 ms for the 128-channel layer on
//   an H100), and land while it is multiplied;
// - row coordinates come from launch-fixed divisors once a block; the
//   inner loop has no integer division;
// - no split of the depth and no atomics: every output sums in one fixed
//   order (tap group, channel block, tap, channel), so launches repeat bit
//   for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
enum Store { kPad = 0, kDense = 1, kBias = 2 };

// Division by a divisor fixed for the launch (as csrc/cyl.cu), exact for
// 0 <= n < 2^31.
struct Div {
  unsigned d, m, s;
  __host__ Div(unsigned divisor = 1) : d(divisor), s(0) {
    while ((1u << s) < d) ++s;
    m = (unsigned)((((uint64_t)1 << 32) * (((uint64_t)1 << s) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

struct ConvArgs {
  const float* x;
  const float* w;
  const float* bias;
  const float* mean;
  const float* var;
  float* out;
  float eps;
  int M;                 // output positions, N * Do * Ho * Wo
  int Cin, Cout, T;      // T = KD * KH * KW
  int Ho, Wo, Hin, Win;
  int x_batch;           // Din * Hin * Win * Cin
  Div dP, dHW, dW;       // by Do * Ho * Wo, Ho * Wo, Wo
  int tap[kMaxTaps];     // (kd * Hin * Win + kh * Win + kw) * Cin
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The input offset of output position r (its (n, od, oh, ow) at tap 0).
__device__ __forceinline__ int row_offset(const ConvArgs& a, unsigned r) {
  const unsigned n = a.dP.div(r), p = r - n * a.dP.d;
  const unsigned od = a.dHW.div(p), q = p - od * a.dHW.d;
  const unsigned oh = a.dW.div(q), ow = q - oh * a.dW.d;
  return (int)(n * a.x_batch + ((od * a.Hin + oh) * a.Win + ow) * a.Cin);
}

// relu((v - mean) * rsqrt(var + eps)), NaN kept: PyTorch's eval-mode batch
// norm as its CUDA kernel computes it, and the ReLU.
__device__ __forceinline__ float bn_relu(float v, float mean, float var,
                                         float eps) {
  const float y = (v - mean) * rsqrtf(var + eps);
  return y <= 0.0f ? 0.0f : y;
}

__device__ __forceinline__ float4 bn_relu4(float4 v, const float* m,
                                           const float* q, float eps) {
  return make_float4(bn_relu(v.x, m[0], q[0], eps),
                     bn_relu(v.y, m[1], q[1], eps),
                     bn_relu(v.z, m[2], q[2], eps),
                     bn_relu(v.w, m[3], q[3], eps));
}

// Shapes of a plan: BN channels and TG taps a chunk.
template <int BN, int TG>
struct Tile {
  static constexpr int NCG = BN / 8;            // channel groups of a block
  static constexpr int NRG = kThreads / NCG;    // row groups of a block
  static constexpr int BM = NRG * 8;
  static constexpr int KC = 4 * TG;             // a chunk's depth
  // depth-major tiles, rows of 8 mod 32 floats
  static constexpr int SA = BM + 8, SB = BN + 8;
  static constexpr int STAGE = KC * (SA + SB);
  static constexpr int SMEM = 2 * STAGE * (int)sizeof(float);
};

template <int BN, int TG, int STORE>
__global__ void __launch_bounds__(kThreads, 2)
    conv_implicit_gemm_kernel(const ConvArgs a) {
  using S = Tile<BN, TG>;
  constexpr int NCG = S::NCG, NRG = S::NRG, BM = S::BM, KC = S::KC;
  constexpr int SA = S::SA, SB = S::SB;
  constexpr int CW = NCG < 8 ? NCG : 8;    // channel groups of a warp
  constexpr int RW = 32 / CW;
  constexpr int RPT = BM / 64;             // input rows a thread copies
  constexpr int NP = BN / 64 > 0 ? BN / 64 : 1;  // weight pairs a thread
  static_assert(NCG * NRG == kThreads && RW * CW == 32 && BM % 64 == 0,
                "thread grid");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int cg = (warp % (NCG / CW)) * CW + lane % CW;
  const int rg = (warp / (NCG / CW)) * RW + lane / CW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the inputs this thread copies: channel c4 of rows r4 + 64 i, every tap
  const int c4 = tid & 3, r4 = tid >> 2;
  int xoff[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    xoff[i] = row_offset(a, (unsigned)min(m0 + r4 + 64 * i, a.M - 1)) + c4;
  const int nblk = a.Cin / 4;
  const int chunks = (a.T / TG) * nblk;
  // the weights: (channel co, input channel c) pairs q = tid + 256 p below
  // 4 BN, TG taps each
  const float* wsrc[NP];

  // chunk (g, cb): tap group g, input channels 4 cb .. 4 cb + 3; depth
  // 4 t + c is tap g TG + t, input channel 4 cb + c.  Before a chunk's
  // copies, its weights' addresses; part t copies tap t of every row and
  // every pair
  auto prepare = [&](int g, int cb) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int q = tid + p * kThreads;
      const int co = min(n0 + q / 4, a.Cout - 1), c = q % 4;
      wsrc[p] = a.w + (co * a.Cin + 4 * cb + c) * a.T + g * TG;
    }
  };
  auto load = [&](int g, int cb, int stage, int t) {
    float* As = smem + stage * S::STAGE;
    float* Bs = As + KC * SA;
    const int toff = a.tap[g * TG + t] + 4 * cb;
    float* dst = As + (4 * t + c4) * SA + r4;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      cp_async4(dst + 64 * i, a.x + (toff + xoff[i]));
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int q = tid + p * kThreads;
      if (4 * BN >= kThreads || q < 4 * BN)
        cp_async4(Bs + (4 * t + q % 4) * SB + q / 4, wsrc[p] + t);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  prepare(0, 0);
#pragma unroll
  for (int t = 0; t < TG; ++t) load(0, 0, 0, t);
  cp_async_commit();
  for (int chunk = 0, g = 0, cb = 1; chunk < chunks; ++chunk, ++cb) {
    cp_async_wait_all();
    __syncthreads();  // the chunk has landed; the other stage is free
    if (cb == nblk) cb = 0, ++g;  // (g, cb): the next chunk's
    const bool more = chunk + 1 < chunks;
    if (more) prepare(g, cb);
    const float* As = smem + (chunk & 1) * S::STAGE + 4 * rg;
    const float* Bs = smem + (chunk & 1) * S::STAGE + KC * SA + 4 * cg;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      // the next chunk's copies, a tap every 4 depth steps
      if (k % 4 == 0 && more) load(g, cb, (chunk + 1) & 1, k / 4);
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * SA);
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * SA + BM / 2);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * SB);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * SB + BN / 2);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    cp_async_commit();
  }

  // the epilogue: rows 4 rg + i and BM / 2 + 4 rg + i (i < 4), channels
  // 4 cg .. 4 cg + 3 (h = 0) and BN / 2 + the same (h = 1), as float4s
  float bias[8], mean[8], var[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = min(n0 + 4 * cg + (j / 4) * (BN / 2) + j % 4, a.Cout - 1);
    bias[j] = a.bias[co];
    if (STORE != kBias) mean[j] = a.mean[co], var[j] = a.var[co];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + 4 * rg + (i / 4) * (BM / 2) + i % 4;
    if (r >= a.M) continue;
    const unsigned n = a.dP.div((unsigned)r), p = r - n * a.dP.d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = n0 + 4 * cg + h * (BN / 2);
      if (co >= a.Cout) continue;
      const float* b = bias + 4 * h;
      const float* c = acc[i] + 4 * h;
      const float4 v = make_float4(c[0] + b[0], c[1] + b[1], c[2] + b[2],
                                   c[3] + b[3]);
      if (STORE == kBias) {
        float* o = a.out + ((int64_t)n * a.Cout + co) * a.dP.d + p;
        o[0] = v.x;
        o[a.dP.d] = v.y;
        o[2 * a.dP.d] = v.z;
        o[3 * a.dP.d] = v.w;
        continue;
      }
      const float4 y = bn_relu4(v, mean + 4 * h, var + 4 * h, a.eps);
      if (STORE == kDense) {
        *reinterpret_cast<float4*>(a.out + (int64_t)r * a.Cout + co) = y;
        continue;
      }
      // the padded map: pixel (oh + 1, ow + 1), its wrap copy, zero rows
      const unsigned oh = a.dW.div(p), ow = p - oh * a.dW.d;
      const int Wp = a.Wo + 2;
      const int64_t pix = ((int64_t)n * (a.Ho + 2) + oh + 1) * Wp + ow + 1;
      const bool last = ow == (unsigned)a.Wo - 1, first = ow == 0;
      float* o = a.out + co;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int side = -1; side < 2; ++side) {   // zero row, map row, zero row
        if (side && oh != (side > 0 ? (unsigned)a.Ho - 1 : 0u)) continue;
        const int64_t q = pix + side * Wp;
        const float4 val = side ? zero : y;
        *reinterpret_cast<float4*>(o + q * a.Cout) = val;
        if (last) *reinterpret_cast<float4*>(o + (q - a.Wo) * a.Cout) = val;
        if (first) *reinterpret_cast<float4*>(o + (q + a.Wo) * a.Cout) = val;
      }
    }
  }
}

template <int BN, int TG, int STORE>
int launch(const ConvArgs& a, cudaStream_t stream) {
  constexpr int BM = Tile<BN, TG>::BM, smem = Tile<BN, TG>::SMEM;
  static bool ready[64];  // the shared-memory opt-in, once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(conv_implicit_gemm_kernel<BN, TG, STORE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const dim3 grid((a.M + BM - 1) / BM, (a.Cout + BN - 1) / BN);
  conv_implicit_gemm_kernel<BN, TG, STORE>
      <<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int STORE>
int launch_store(const ConvArgs& a, cudaStream_t stream) {
  if (a.Cout <= 32) return launch<32, 3, STORE>(a, stream);
  if (a.Cout <= 64) return launch<64, 9, STORE>(a, stream);
  return launch<128, 9, STORE>(a, stream);
}

}  // namespace

// out = the convolution of x [N, Din, Hin, Win, Cin] (channels last, dense)
// by w [Cout, Cin, KD, KH, KW] with the store ``store`` (kPad 0, kDense 1,
// kBias 2; mean and var null for kBias).  The plans (block channels BN,
// taps a chunk TG), as kernels/conv_cuda.py's plan(): BN 32, 64 or 128 by
// Cout; TG 3 for BN 32 (4 for a 2 x 2 kernel), else 9.  Returns a CUDA
// error code; cudaErrorInvalidValue for a size below 1, Cin or Cout not a
// multiple of 4, x of 2^31 elements or more, a kPad store with Do > 1, or
// no plan.  out is 16-byte aligned (float4 stores).
extern "C" int conv_launch(const float* x, int N, int Din, int Hin, int Win,
                           int Cin, const float* w, int Cout, int KD, int KH,
                           int KW, const float* bias, const float* mean,
                           const float* var, float eps, int store, float* out,
                           void* stream) {
  const int Do = Din - KD + 1, Ho = Hin - KH + 1, Wo = Win - KW + 1;
  const int T = KD * KH * KW;
  if (N < 1 || Cin < 4 || Cin % 4 != 0 || Cout < 4 || Cout % 4 != 0 ||
      Do < 1 || Ho < 1 || Wo < 1 || T > kMaxTaps || bias == nullptr ||
      store < kPad || store > kBias ||
      (store != kBias && (mean == nullptr || var == nullptr)) ||
      (store == kPad && Do != 1) || ((uintptr_t)out % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)N * Do * Ho * Wo;
  const int64_t x_batch = (int64_t)Din * Hin * Win * Cin;
  if (N * x_batch >= ((int64_t)1 << 31) || M >= ((int64_t)1 << 31) ||
      (int64_t)Cout * Cin * T >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{x, w, bias, mean, var, out, eps, (int)M, Cin, Cout, T, Ho, Wo,
             Hin, Win, (int)x_batch, Div(Do * Ho * Wo), Div(Ho * Wo), Div(Wo),
             {}};
  for (int kd = 0, t = 0; kd < KD; ++kd)
    for (int kh = 0; kh < KH; ++kh)
      for (int kw = 0; kw < KW; ++kw, ++t)
        a.tap[t] = ((kd * Hin + kh) * Win + kw) * Cin;
  const cudaStream_t s = (cudaStream_t)stream;
  if (T % 9 == 0 || (Cout <= 32 && T % 3 == 0)) {
    if (store == kPad) return launch_store<kPad>(a, s);
    if (store == kDense) return launch_store<kDense>(a, s);
    if (Cout <= 32) return launch<32, 3, kBias>(a, s);
  } else if (T == 4 && store == kBias && Cout <= 32) {
    return launch<32, 4, kBias>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
