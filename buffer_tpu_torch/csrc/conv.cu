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
//   register tile.  A depth step reads two float4s of inputs and two of
//   weights from shared memory for 64 fused multiply-adds; a warp's reads
//   touch at most 8 distinct 16-byte words, in distinct bank groups.  The
//   thread stays within 128 registers, so two blocks (16 warps) share an
//   SM.  The depth advances a chunk at a time through two shared-memory
//   stages: the next chunk's copies land while the current one is
//   multiplied;
// - two ways to stage a chunk's operands (make_plan picks one by shape):
//   the halo path (conv_implicit_gemm_kernel): a chunk is CH input channels
//   (8, or 4 where eight would not leave two blocks an SM) x all T taps.
//   Its inputs are a halo tile: every input pixel the block's rows read,
//   copied once, 16 bytes (a pixel's 4 channels of a quad) a cp.async, in
//   CH / 4 planes of 16-byte words.  The tile lays the pixels out by
//   pitches (line WP, plane PP, image IP), so a row's read at tap (kd, kh,
//   kw) is the row's position plus kd PP + kh WP + kw; the pitches are the
//   input's extents rounded up so that consecutive rows lie 1 apart modulo
//   RW, the row groups of a warp (thread rows rg + NRG i), so the RW rows a
//   warp reads at once fall in distinct bank groups.  The weights come from
//   a chunk-major copy written by conv_implicit_gemm_weights_kernel before
//   the launch ([Cin / CH][T][CH][Cout]: a chunk's [T CH][BN] tile is BN
//   contiguous floats a row), also 16-byte cp.async;
//   the per-tap path (conv_implicit_gemm_tap_kernel), for the shapes where
//   it was faster on the card (128-channel blocks; a 3-D kernel over one
//   output plane): a chunk is TG = 9 taps x 4 input channels, gathered tap
//   by tap with 4-byte cp.async into depth-major tiles (thread rows 4 rg +
//   i and BM / 2 + the same), the weights likewise from PyTorch's layout;
// - row coordinates and tile pixels come from launch-fixed divisors, once a
//   block and once a copy; the depth steps have no division;
// - no split of the depth and no atomics: every output sums in one fixed
//   order (channel block, tap, channel on the halo path; tap group, channel
//   block, tap, channel per tap), so launches repeat bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
// a block's shared memory, so that two blocks share an SM's 228 KB: half of
// it, less the 1 KB the runtime keeps a block
constexpr int kMaxSmem = 228 * 1024 / 2 - 1024;
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
  const float* w;        // PyTorch's layout (the per-tap path)
  const float* wt;       // chunk-major (the halo path: the weights kernel's)
  const float* bias;
  const float* mean;
  const float* var;
  float* out;
  float eps;
  int M;                 // output positions, N * Do * Ho * Wo
  int Cin, Cout, T;      // T = KD * KH * KW
  int KD, KH, KW;
  int Din, Hin, Win, Ho, Wo;
  int WP, PP, IP;        // the tile's pitches (pixels): line, plane, image
  int HP;                // a channel quad's plane of the tile (16-byte words)
  Div dP, dHW, dW;       // by Do * Ho * Wo, Ho * Wo, Wo
  Div dIP, dPP, dWP;     // by IP, PP, WP
  // the per-tap path: x's batch stride, each tap's offset in x
  int x_batch;           // Din * Hin * Win * Cin
  int tap[kMaxTaps];     // (kd * Hin * Win + kh * Win + kw) * Cin
};

__device__ __forceinline__ void cp_async16(float4* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

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

// The tile coordinate of output position r's base pixel (its (n, od, oh,
// ow) at tap 0).
__device__ __forceinline__ int row_coord(const ConvArgs& a, unsigned r) {
  const unsigned n = a.dP.div(r), p = r - n * a.dP.d;
  const unsigned od = a.dHW.div(p), q = p - od * a.dHW.d;
  const unsigned oh = a.dW.div(q), ow = q - oh * a.dW.d;
  return (int)(n * a.IP + od * a.PP + oh * a.WP + ow);
}

// The input offset of output position r (its (n, od, oh, ow) at tap 0),
// for the per-tap path.
__device__ __forceinline__ int row_offset(const ConvArgs& a, unsigned r) {
  const unsigned n = a.dP.div(r), p = r - n * a.dP.d;
  const unsigned od = a.dHW.div(p), q = p - od * a.dHW.d;
  const unsigned oh = a.dW.div(q), ow = q - oh * a.dW.d;
  return (int)(n * a.x_batch + ((od * a.Hin + oh) * a.Win + ow) * a.Cin);
}

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
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

// The epilogue of a thread's 8 x 8 tile: rows row[i] (i < 8), channels co0
// .. co0 + 3 (h = 0) and BN / 2 + the same (h = 1), as float4s.
template <int BN, int STORE>
__device__ __forceinline__ void store_tile(const ConvArgs& a,
                                           const float (&acc)[8][8],
                                           const int (&row)[8], int co0) {
  float bias[8], mean[8], var[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = min(co0 + (j / 4) * (BN / 2) + j % 4, a.Cout - 1);
    bias[j] = a.bias[co];
    if (STORE != kBias) mean[j] = a.mean[co], var[j] = a.var[co];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row[i];
    if (r >= a.M) continue;
    const unsigned n = a.dP.div((unsigned)r), p = r - n * a.dP.d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + h * (BN / 2);
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

// Shapes of a plan: BN channels and CH input channels a chunk.
template <int BN, int CH>
struct Tile {
  static constexpr int NCG = BN / 8;            // channel groups of a block
  static constexpr int NRG = kThreads / NCG;    // row groups of a block
  static constexpr int BM = NRG * 8;
  static constexpr int NQ = CH / 4;             // channel quads of a chunk
  static constexpr int CW = NCG < 8 ? NCG : 8;  // channel groups of a warp
  static constexpr int RW = 32 / CW;            // row groups of a warp
};

// Shapes of a per-tap plan: BN channels and TG taps a chunk.
template <int BN, int TG>
struct TapTile {
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
    conv_implicit_gemm_tap_kernel(const ConvArgs a) {
  using S = TapTile<BN, TG>;
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

  int rows[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = m0 + 4 * rg + (i / 4) * (BM / 2) + i % 4;
  store_tile<BN, STORE>(a, acc, rows, n0 + 4 * cg);
}

// The tile coordinate of block m0's first row, and the span of tile
// positions its rows read (the last rows clamped to M - 1).
template <int BM>
__device__ __forceinline__ int2 block_tile(const ConvArgs& a, int m0) {
  const int origin = row_coord(a, (unsigned)m0);
  const int span = row_coord(a, (unsigned)min(m0 + BM - 1, a.M - 1)) -
                   origin + (a.KD - 1) * a.PP + (a.KH - 1) * a.WP + a.KW;
  return make_int2(origin, span);
}

// Chunk cb's staging into stage As, all 16-byte cp.async copies: the tile
// (copy j = tid + 256 s is position j / NQ, quad j % NQ; padding positions
// skipped), then the weights [T][CH][BN] from the transposed weights' chunk
// rows (float4 j of row k is channels n0 + 4 (j % (BN / 4)) .. + 3; past
// Cout skipped).  Everything is recomputed from the launch's arguments, so
// nothing stays live across the multiply-adds.
template <int BN, int CH>
__device__ __forceinline__ void stage_chunk(const ConvArgs& a, int cb,
                                            float4* As, int m0, int n0) {
  using S = Tile<BN, CH>;
  constexpr int NQ = S::NQ;
  const int tid = threadIdx.x;
  const int2 t = block_tile<S::BM>(a, m0);
#pragma unroll 1
  for (int j = tid; j < NQ * t.y; j += kThreads) {
    const int pos = NQ == 2 ? j >> 1 : j, quad = NQ == 2 ? j & 1 : 0;
    const unsigned c = (unsigned)(t.x + pos);
    const unsigned n = a.dIP.div(c), e = c - n * a.IP;
    const unsigned d = a.dPP.div(e), f = e - d * a.PP;
    const unsigned h = a.dWP.div(f), x = f - h * a.WP;
    if (d < (unsigned)a.Din && h < (unsigned)a.Hin && x < (unsigned)a.Win)
      cp_async16(As + quad * a.HP + pos,
                 a.x + ((int)(((n * a.Din + d) * a.Hin + h) * a.Win + x) *
                            a.Cin + CH * cb + 4 * quad));
  }
  float4* Bw = As + NQ * a.HP;
  const float* wc = a.wt + (size_t)cb * CH * a.T * a.Cout + n0;
#pragma unroll 1
  for (int j = tid; j < CH * a.T * (BN / 4); j += kThreads) {
    const int k = j / (BN / 4), col = 4 * (j % (BN / 4));
    if (n0 + col < a.Cout) cp_async16(Bw + j, wc + k * a.Cout + col);
  }
}

// The weights [Cout, Cin, T] as the convolution stages them, chunk-major:
// wt[((cb T + t) CH + ci) Cout + co] = w[(co Cin + cb CH + ci) T + t].
__global__ void conv_implicit_gemm_weights_kernel(const float* w, float* wt,
                                                  int Cout, int Cin, int T,
                                                  int CH) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Cout * Cin * T) return;
  const int co = i % Cout, r = i / Cout;       // r = (cb T + t) CH + ci
  const int ci = r % CH, q = r / CH, t = q % T, cb = q / T;
  wt[i] = w[(co * Cin + cb * CH + ci) * T + t];
}

template <int BN, int CH, int STORE>
__global__ void __launch_bounds__(kThreads, 2)
    conv_implicit_gemm_kernel(const ConvArgs a) {
  using S = Tile<BN, CH>;
  constexpr int NRG = S::NRG, BM = S::BM, NQ = S::NQ, CW = S::CW;
  static_assert(S::NCG * NRG == kThreads && S::RW * CW == 32, "thread grid");

  extern __shared__ float4 smem4[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int cg = (warp % (S::NCG / CW)) * CW + lane % CW;
  const int rg = (warp / (S::NCG / CW)) * S::RW + lane / CW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // a stage: the tile (NQ planes of HP words), then the weights [T][CH][BN]
  const int stage_words = NQ * a.HP + CH * a.T * BN / 4;

  // this thread's 8 rows' tile positions, as byte offsets 16 bits each
  // (the plan keeps a tile under 64 KB), rows 2 k and 2 k + 1 in rp[k]
  unsigned rp[4];
  {
    const int origin = row_coord(a, (unsigned)m0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned lo = row_coord(a, (unsigned)min(m0 + rg + NRG * 2 * k,
                                                     a.M - 1)) - origin;
      const unsigned hi = row_coord(
          a, (unsigned)min(m0 + rg + NRG * (2 * k + 1), a.M - 1)) - origin;
      rp[k] = 16 * lo | 16 * hi << 16;
    }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  stage_chunk<BN, CH>(a, 0, smem4, m0, n0);
  cp_async_commit();
  const int chunks = a.Cin / CH;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    cp_async_wait_all();
    __syncthreads();  // the chunk has landed; the other stage is free
    // the next chunk's staging, landing while this one is multiplied
    if (chunk + 1 < chunks)
      stage_chunk<BN, CH>(a, chunk + 1, smem4 + ((chunk + 1) & 1) * stage_words,
                          m0, n0);
    cp_async_commit();
    const char* As =
        reinterpret_cast<const char*>(smem4 + (chunk & 1) * stage_words);
    const float* Bs =
        reinterpret_cast<const float*>(As + 16 * NQ * a.HP) + 4 * cg;
    for (int kd = 0, t = 0; kd < a.KD; ++kd)
      for (int kh = 0; kh < a.KH; ++kh)
        for (int kw = 0; kw < a.KW; ++kw, ++t) {
          // the tap's offset in the tile (bytes)
          const char* At = As + 16 * (kd * a.PP + kh * a.WP + kw);
          const float* Bt = Bs + t * CH * BN;
#pragma unroll
          for (int qd = 0; qd < NQ; ++qd) {
            const char* Aq = At + qd * 16 * a.HP;
            float4 av[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              av[i] = *reinterpret_cast<const float4*>(
                  Aq + (i % 2 ? rp[i / 2] >> 16 : rp[i / 2] & 0xffffu));
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float* b = Bt + (4 * qd + c) * BN;
              const float4 b0 = *reinterpret_cast<const float4*>(b);
              const float4 b1 = *reinterpret_cast<const float4*>(b + BN / 2);
              const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                   b1.x, b1.y, b1.z, b1.w};
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float ai = lane4(av[i], c);
#pragma unroll
                for (int j = 0; j < 8; ++j)
                  acc[i][j] = __fmaf_rn(ai, bv[j], acc[i][j]);
              }
            }
          }
        }
  }

  int rows[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = m0 + rg + NRG * i;
  store_tile<BN, STORE>(a, acc, rows, n0 + 4 * cg);
}

// A launch's plan: its path (kHalo, kTap), the block's channels BN, a
// chunk's input channels CH (halo) or taps TG (per tap), the halo tile's
// pitches and plane, the dynamic shared memory.
enum Path { kHalo = 0, kTap = 1 };
struct Plan {
  int path, BN, CH, TG, WP, PP, IP, HP, smem;
};

int64_t round_up_to(int64_t v, int64_t target, int64_t mod) {
  // the least value >= v congruent to target modulo mod
  return v + (((target - v) % mod) + mod) % mod;
}

int64_t gcd(int64_t p, int64_t q) { return q ? gcd(q, p % q) : p; }

// The plan of a convolution, as kernels/conv_cuda.py's plan(); BN = 0 where
// there is none.  The per-tap path where the halo's was slower on the card:
// 128-channel blocks, and a 3-D kernel over one output plane (its tile holds
// KD planes an image for one of outputs), with 9 taps a chunk.  Else the
// halo path: BN 32, 64 or 128 after Cout, or 64 where a 32-channel block's
// tile would not fit (tiny maps: a warp's 8 rows span several, and the
// padding outgrows them).  The tile's pitches: the least above the input's
// extents that put consecutive rows 1 apart modulo RW (the row groups of a
// warp: 8 at BN 32, else 4), the line pitch kept where rows cross no line
// (Ho = 1) and the plane pitch where they cross no plane.  HP: the largest
// span a block reads (blocks repeat every P / gcd(BM, P), the last one
// clamped), rounded to 4 mod 8 words so that the two quads of a pixel's 8
// channels land in distinct bank groups, under 4096 (16-bit byte offsets).
// CH: 8, else 4, as shared memory leaves two blocks an SM.
Plan make_plan(int64_t N, int Din, int Hin, int Win, int Cin, int Cout, int KD,
               int KH, int KW, int store) {
  const Plan none{0, 0, 0, 0, 0, 0, 0, 0, 0};
  const int T = KD * KH * KW;
  const int64_t Do = Din - KD + 1, Ho = Hin - KH + 1, Wo = Win - KW + 1;
  if (N < 1 || Cin < 4 || Cin % 4 || Cout < 4 || Cout % 4 || T > kMaxTaps ||
      Do < 1 || Ho < 1 || Wo < 1)
    return none;
  const int BN0 = Cout <= 32 ? 32 : Cout <= 64 ? 64 : 128;
  if (T % 9 == 0 && store != kBias && (BN0 == 128 || (Do == 1 && KD > 1))) {
    const int smem = BN0 == 128 ? TapTile<128, 9>::SMEM : TapTile<64, 9>::SMEM;
    return Plan{kTap, BN0, 4, 9, 0, 0, 0, 0, smem};
  }
  const int64_t P = Do * Ho * Wo, M = N * P;
  // BN after Cout, then 64 where a 32-channel block's tile does not fit
  for (int BN = BN0; BN; BN = BN == 32 ? 64 : 0) {
    if (store == kBias && BN > 64) break;
    const int BM = kThreads * 64 / BN, RW = BN == 32 ? 8 : 4;
    const int64_t WP = Ho > 1 ? round_up_to(Win, Wo, RW) : Win;
    const int64_t PP = Do > 1 ? round_up_to(Hin * WP, Ho * Wo, RW) : Hin * WP;
    const int64_t IP = round_up_to(Din * PP, P, RW);
    if (N * IP >= ((int64_t)1 << 31)) return none;
    auto coord = [&](int64_t r) {
      const int64_t n = r / P, p = r % P;
      return n * IP + p / (Ho * Wo) * PP + p % (Ho * Wo) / Wo * WP + p % Wo;
    };
    auto span_of = [&](int64_t b) {
      const int64_t m0 = b * BM;
      return coord(m0 + BM - 1 < M - 1 ? m0 + BM - 1 : M - 1) - coord(m0);
    };
    const int64_t blocks = (M + BM - 1) / BM, period = P / gcd(BM, P);
    int64_t span = span_of(blocks - 1);
    for (int64_t b = 0; b < blocks && b < period; ++b)
      span = span_of(b) > span ? span_of(b) : span;
    span += (KD - 1) * PP + (KH - 1) * WP + KW;
    const int64_t HP = round_up_to(span, 4, 8);
    if (HP >= 4096) continue;
    for (int CH = 8; CH >= 4; CH -= 4) {
      const int64_t smem = 2 * (CH / 4 * HP * 16 + (int64_t)CH * T * BN * 4);
      if (Cin % CH == 0 && smem <= kMaxSmem)
        return Plan{kHalo, BN, CH, 0, (int)WP, (int)PP, (int)IP, (int)HP,
                    (int)smem};
    }
  }
  return none;
}

// Launches Kernel on grid with smem, or with ``attrs`` reports it instead:
// blocks an SM at its shared memory, registers a thread, local memory
// (spills) a thread, static and dynamic shared memory a block.
template <auto Kernel>
int launch_kernel(const ConvArgs& a, dim3 grid, int smem, cudaStream_t stream,
                  int* attrs) {
  static bool ready[64];  // the shared-memory opt-in, once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  if (attrs != nullptr) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, Kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&attrs[0], Kernel,
                                                        kThreads, smem);
    attrs[1] = fa.numRegs;
    attrs[2] = (int)fa.localSizeBytes;
    attrs[3] = (int)fa.sharedSizeBytes;
    attrs[4] = smem;
    return (int)e;
  }
  Kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int STORE, int BN, int BM, auto Kernel>
int launch_bn(const ConvArgs& a, const Plan& p, cudaStream_t s, int* attrs) {
  const dim3 grid((a.M + BM - 1) / BM, (a.Cout + BN - 1) / BN);
  return launch_kernel<Kernel>(a, grid, p.smem, s, attrs);
}

template <int STORE, int CH>
int launch_halo(const ConvArgs& a, const Plan& p, cudaStream_t s, int* attrs) {
  if (p.BN == 32)
    return launch_bn<STORE, 32, Tile<32, CH>::BM,
                     conv_implicit_gemm_kernel<32, CH, STORE>>(a, p, s, attrs);
  if (p.BN == 64)
    return launch_bn<STORE, 64, Tile<64, CH>::BM,
                     conv_implicit_gemm_kernel<64, CH, STORE>>(a, p, s, attrs);
  if constexpr (STORE == kBias) {
    return (int)cudaErrorInvalidValue;  // make_plan gives the bias store <= 64
  } else {
    return launch_bn<STORE, 128, Tile<128, CH>::BM,
                     conv_implicit_gemm_kernel<128, CH, STORE>>(a, p, s,
                                                                attrs);
  }
}

template <int STORE>
int launch_tap(const ConvArgs& a, const Plan& p, cudaStream_t s, int* attrs) {
  if constexpr (STORE == kBias) {
    return (int)cudaErrorInvalidValue;  // make_plan gives it the halo path
  } else {
    if (p.BN == 64)
      return launch_bn<STORE, 64, TapTile<64, 9>::BM,
                       conv_implicit_gemm_tap_kernel<64, 9, STORE>>(a, p, s,
                                                                    attrs);
    return launch_bn<STORE, 128, TapTile<128, 9>::BM,
                     conv_implicit_gemm_tap_kernel<128, 9, STORE>>(a, p, s,
                                                                   attrs);
  }
}

template <int STORE>
int launch_store(const ConvArgs& a, const Plan& p, cudaStream_t s,
                 int* attrs) {
  if (p.path == kTap) return launch_tap<STORE>(a, p, s, attrs);
  return p.CH == 8 ? launch_halo<STORE, 8>(a, p, s, attrs)
                   : launch_halo<STORE, 4>(a, p, s, attrs);
}

int launch_plan(const ConvArgs& a, const Plan& p, int store, cudaStream_t s,
                int* attrs = nullptr) {
  if (p.BN == 0) return (int)cudaErrorInvalidValue;
  if (store == kPad) return launch_store<kPad>(a, p, s, attrs);
  if (store == kDense) return launch_store<kDense>(a, p, s, attrs);
  return launch_store<kBias>(a, p, s, attrs);
}

}  // namespace

// The plan of a convolution of x [N, Din, Hin, Win, Cin] by a [Cout, Cin,
// KD, KH, KW] kernel with store ``store``, as conv_launch takes it, into
// plan[0..8]: path (0 halo, 1 per tap), BN, CH, TG, WP, PP, IP, HP, shared
// memory bytes (BN 0: no plan).
extern "C" int conv_plan(int N, int Din, int Hin, int Win, int Cin, int Cout,
                         int KD, int KH, int KW, int store, int* plan) {
  const Plan p = make_plan(N, Din, Hin, Win, Cin, Cout, KD, KH, KW, store);
  const int v[9] = {p.path, p.BN, p.CH, p.TG, p.WP, p.PP, p.IP, p.HP, p.smem};
  for (int i = 0; i < 9; ++i) plan[i] = v[i];
  return 0;
}

// out = the convolution of x [N, Din, Hin, Win, Cin] (channels last, dense)
// by w [Cout, Cin, KD, KH, KW] with the store ``store`` (kPad 0, kDense 1,
// kBias 2; mean and var null for kBias), on the plan of conv_plan(): on
// the halo path two launches, the weights into wt (Cout Cin KD KH KW floats,
// chunk-major) and the convolution; on the per-tap path the convolution
// (wt unused, may be null).  Returns a CUDA error code; cudaErrorInvalidValue for a
// size below 1, Cin or Cout not a multiple of 4, x of 2^31 elements or more,
// a kPad store with Do > 1, x, wt or out not 16-byte aligned (16-byte reads
// and stores), or no plan.
extern "C" int conv_launch(const float* x, int N, int Din, int Hin, int Win,
                           int Cin, const float* w, int Cout, int KD, int KH,
                           int KW, const float* bias, const float* mean,
                           const float* var, float eps, int store, float* out,
                           float* wt, void* stream) {
  const int Do = Din - KD + 1, Ho = Hin - KH + 1, Wo = Win - KW + 1;
  const int T = KD * KH * KW;
  if (N < 1 || Cin < 4 || Cin % 4 != 0 || Cout < 4 || Cout % 4 != 0 ||
      Do < 1 || Ho < 1 || Wo < 1 || T > kMaxTaps || bias == nullptr ||
      store < kPad || store > kBias ||
      (store != kBias && (mean == nullptr || var == nullptr)) ||
      (store == kPad && Do != 1) || ((uintptr_t)out % 16) != 0 ||
      ((uintptr_t)x % 16) != 0 || ((uintptr_t)wt % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)N * Do * Ho * Wo;
  const int64_t x_batch = (int64_t)Din * Hin * Win * Cin;
  if (N * x_batch >= ((int64_t)1 << 31) || M >= ((int64_t)1 << 31) ||
      (int64_t)Cout * Cin * T >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(N, Din, Hin, Win, Cin, Cout, KD, KH, KW, store);
  if (p.BN == 0 || (p.path == kHalo && wt == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  ConvArgs a{x, w, wt, bias, mean, var, out, eps, (int)M, Cin, Cout, T, KD,
             KH, KW, Din, Hin, Win, Ho, Wo, p.WP, p.PP, p.IP, p.HP,
             Div(Do * Ho * Wo), Div(Ho * Wo), Div(Wo), Div(p.IP ? p.IP : 1),
             Div(p.PP ? p.PP : 1), Div(p.WP ? p.WP : 1), (int)x_batch, {}};
  if (p.path == kTap) {
    for (int kd = 0, t = 0; kd < KD; ++kd)
      for (int kh = 0; kh < KH; ++kh)
        for (int kw = 0; kw < KW; ++kw, ++t)
          a.tap[t] = ((kd * Hin + kh) * Win + kw) * Cin;
  } else {
    const int n = Cout * Cin * T;
    conv_implicit_gemm_weights_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        w, wt, Cout, Cin, T, p.CH);
  }
  return launch_plan(a, p, store, s);
}

// The instance conv_launch would launch for these shapes, into attrs[0..4]:
// blocks an SM, registers and local (spill) bytes a thread, static and
// dynamic shared memory bytes a block.  Returns a CUDA error code;
// cudaErrorInvalidValue where there is no plan.
extern "C" int conv_attributes(int N, int Din, int Hin, int Win, int Cin,
                               int Cout, int KD, int KH, int KW, int store,
                               int* attrs) {
  const Plan p = make_plan(N, Din, Hin, Win, Cin, Cout, KD, KH, KW, store);
  return launch_plan(ConvArgs{}, p, store, nullptr, attrs);
}
