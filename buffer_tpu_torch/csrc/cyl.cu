// The data movement around the descriptor and cost-volume convolutions in
// inference: conv 0's input written once, padded and channels last, as the
// convolution kernel (csrc/conv.cu) reads it, and the cost volume in one
// pass, instead of concatenations and 20 rolls, a stack and a subtraction.
// The convolution kernel writes every later padded input itself.
//
// Replaces no TPU kernel.  The JAX package leaves these steps to XLA, which
// fuses them into the convolutions' operands; in PyTorch
// (nn/cylindrical.py:pad_cyl_2d, models/heads.py:cost_volume) each is a
// library pass or several over the whole map.
//
// Contracts, as the plain versions that kernels/cyl_cuda.py names:
//   cyl_pad_kernel: x [N0, C, N2, H, W] (any strides) -> its cylindrical
//     padding [N0, C, N2, H + 2, W + 2] stored channels last: column j is
//     x's column (j - 1) mod W (azimuth wrap), rows 0 and H + 1 are zeros
//     (elevation).
//   cost_volume_kernel: vol[m, s, e, a, c] = des1[m, e, (a - s) mod A, c]
//     - des2[m, e, a, c] for every shift s < A, stored [M, A, E, A, C]
//     (the channels-last layout of the [M, C, A, E, A] volume).
// Every value is a copy or one float32 subtraction of the plain version's,
// so kernel and plain version agree bit for bit.
//
// Bound: bytes.  Each kernel reads its input once and writes its output
// once, with consecutive threads on consecutive output addresses; the cost
// volume stages one match's two descriptors in shared memory and writes its
// 20 shifted differences as float4 stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // a grid-stride loop past this
constexpr int kUnroll = 4;            // elements a thread has in flight

// Division by a divisor fixed for the launch, as a multiply-high, add and
// shift (Granlund and Montgomery), exact for 0 <= n < 2^31; a runtime
// integer division would leave the padded write bound by its ~20
// instructions an element, not by its bytes.
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

// The padded map's element o (channels last): its source value, 0 on the
// padding rows.
struct PadMap {
  const float* x;
  int64_t s0, s1, s2, sh, sw;
  int H, W;
  Div dC, dN2, dHp, dWp;

  __device__ __forceinline__ float at(unsigned o) const {
    unsigned r = o, c, n2, i, j, q;
    q = dC.div(r), c = r - q * dC.d, r = q;
    q = dWp.div(r), j = r - q * dWp.d, r = q;
    q = dHp.div(r), i = r - q * dHp.d, r = q;
    q = dN2.div(r), n2 = r - q * dN2.d, r = q;
    if (i == 0 || i == (unsigned)H + 1) return 0.0f;
    const int col = j == 0 ? W - 1 : (j == (unsigned)W + 1 ? 0 : (int)j - 1);
    return x[r * s0 + c * s1 + n2 * s2 + (i - 1) * sh + col * sw];
  }
};

// Each warp writes chunks of 32 * kUnroll consecutive elements, its lanes
// reading all of theirs before storing any.
__global__ void cyl_pad_kernel(PadMap map, unsigned total,
                               float* __restrict__ out) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const unsigned warps = (gridDim.x * blockDim.x) >> 5;
  for (unsigned base = warp * 32 * kUnroll; base < total;
       base += warps * 32 * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned o = base + 32 * k + lane;
      v[k] = o < total ? map.at(o) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned o = base + 32 * k + lane;
      if (o < total) out[o] = v[k];
    }
  }
}

// One match a block: des1[m] and des2[m] into shared memory as [E][A][C],
// then the A shifts of the difference, four channels a thread and store.
__global__ void cost_volume_kernel(const float* __restrict__ d1,
                                   const float* __restrict__ d2, int E, int A,
                                   int C, int a0, int a1, int a2, int a3,
                                   int b0, int b1, int b2, int b3, Div dC4,
                                   Div dA, Div dE, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* s1 = reinterpret_cast<float*>(smem4);
  const int n = E * A * C;
  float* s2 = s1 + n;
  const int m = blockIdx.x;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int c = t % C, a = (t / C) % A, e = t / (C * A);
    s1[t] = d1[(int64_t)m * a0 + e * a1 + a * a2 + c * a3];
    s2[t] = d2[(int64_t)m * b0 + e * b1 + a * b2 + c * b3];
  }
  __syncthreads();
  const int C4 = C / 4;
  float4* o4 = reinterpret_cast<float4*>(out + (int64_t)m * A * n);
  for (unsigned t = threadIdx.x; t < (unsigned)(A * E * A * C4);
       t += blockDim.x) {
    const unsigned r0 = dC4.div(t), r1 = dA.div(r0), s = dE.div(r1);
    const int c4 = t - r0 * C4, a = r0 - r1 * A, e = r1 - s * E;
    const int ar = a >= (int)s ? a - (int)s : a - (int)s + A;
    const float4 p = reinterpret_cast<const float4*>(s1)[(e * A + ar) * C4 + c4];
    const float4 q = reinterpret_cast<const float4*>(s2)[(e * A + a) * C4 + c4];
    o4[t] = make_float4(p.x - q.x, p.y - q.y, p.z - q.z, p.w - q.w);
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

// The padded map of x [N0, C, N2, H, W] (element strides s0, s1, s2, sh,
// sw) into out, channels last [N0, N2, H + 2, W + 2, C].  Returns a CUDA
// error code; cudaErrorInvalidValue for a size below 1 or a padded map of
// 2^30 elements or more.
extern "C" int cyl_pad_launch(const float* x, int N0, int C, int N2, int H,
                              int W, int s0, int s1, int s2, int sh, int sw,
                              float* out, void* stream) {
  if (N0 < 1 || C < 1 || N2 < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)N0 * C * N2 * (H + 2) * (W + 2);
  if (total >= ((int64_t)1 << 30)) return (int)cudaErrorInvalidValue;
  PadMap map{x, s0, s1, s2, sh, sw, H, W,
             Div(C), Div(N2), Div(H + 2), Div(W + 2)};
  cyl_pad_kernel<<<blocks_for((total + kUnroll - 1) / kUnroll), kThreads, 0,
                   (cudaStream_t)stream>>>(map, (unsigned)total, out);
  return (int)cudaGetLastError();
}

// The cost volume of M matches (des1, des2 [M, E, A, C], element strides
// a0..a3 and b0..b3) into out [M, A, E, A, C].  Returns a CUDA error code;
// cudaErrorInvalidValue for a size below 1, C not a multiple of 4, or two
// descriptors past 48 KB of shared memory.
extern "C" int cost_volume_launch(const float* d1, const float* d2, int M,
                                  int E, int A, int C, int a0, int a1, int a2,
                                  int a3, int b0, int b1, int b2, int b3,
                                  float* out, void* stream) {
  if (M < 1 || E < 1 || A < 1 || C < 4 || C % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = (int64_t)2 * E * A * C * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cost_volume_kernel<<<M, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      d1, d2, E, A, C, a0, a1, a2, a3, b0, b1, b2, b3, Div(C / 4), Div(A),
      Div(E), out);
  return (int)cudaGetLastError();
}
