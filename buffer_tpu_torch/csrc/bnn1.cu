// Rank-banded 1-NN over B Morton-sorted clouds (the level-0 -> level-1
// upsample of the conv pyramid).
//
// Replaces buffer_tpu/kernels/geom_pallas.py:banded_nn1_tpu (_bnn1_kernel).
// Contract, as in the plain version kernels/knn_cuda.py:banded_nn1_plain:
// the support of cloud b is [S] points and validity, rank s at row s / 128,
// column s % 128 of an NR-row grid, ranks >= S invalid at (0, 0, 0); query
// tile t (32 queries) searches rows r0 .. r0 + LW - 1 (LW <= 16), r0 the
// fp32 window rule of kernels/knn_cuda.py:window_starts from the valid
// counts of support and query.  d2 = ((dx*dx + dy*dy) + dz*dz) separately
// rounded, + 1e9 where invalid, floored at 1e-30; per column the smallest
// key (bits(d2) & ~0x3F) | row; across columns the smallest
// (key & ~0xFFFF) | rank.  Out d2 = float(best & ~0xFFFF) and
// idx = min(best & 0xFFFF, S - 1).
//
// Bound: operations (B*Q*LW*128 distance tests of ~8 flops).  Design: one
// block of 128 threads per (query tile, cloud) derives its window from the
// two valid counts (as in bknn.cu) and stages its 16 x 128 window points
// (32 KB) in shared memory once; four threads per query each take
// every fourth column (the four read neighbouring float4s, broadcast to the
// other queries of the warp), then two shuffles combine them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 128;
constexpr int kTile = 32;
constexpr int kMaxRows = 16;
constexpr int kThreads = 128;
constexpr int kParts = kThreads / kTile;   // threads per query
constexpr unsigned kRowMask = 0x3Fu;
constexpr unsigned kRankMask = 0xFFFFu;
constexpr unsigned kFull = 0xffffffffu;

// First window row of query tile `tile` (kernels/knn_cuda.py:window_starts).
__device__ __forceinline__ int window_start(int tile, long long n_support,
                                            long long n_query, int NR,
                                            int LW) {
  const float ratio = __fdiv_rn(fmaxf((float)n_support, 1.f),
                                fmaxf((float)n_query, 1.f));
  const float center =
      __fmul_rn(__fadd_rn(__fmul_rn((float)tile, (float)kTile), 16.f), ratio);
  const float row = __fdiv_rn(center, (float)kSeg);
  const int r0 = (int)__fadd_rn(__fdiv_rn(row, 8.f), 0.5f) * 8 - LW / 2;
  return min(max(r0, 0), max(((NR - LW) / 8) * 8, 0));
}

__device__ __forceinline__ unsigned window_key(float qx, float qy, float qz,
                                               float4 s, unsigned row) {
  const float dx = __fsub_rn(qx, s.x);
  const float dy = __fsub_rn(qy, s.y);
  const float dz = __fsub_rn(qz, s.z);
  float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                      __fmul_rn(dz, dz));
  if (s.w == 0.f) d = __fadd_rn(d, 1e9f);
  d = fmaxf(d, 1e-30f);
  return (__float_as_uint(d) & ~kRowMask) | row;
}

__global__ void __launch_bounds__(kThreads) bnn1_kernel(
    const float* __restrict__ query,      // [B, Q, 3]
    const float* __restrict__ support,    // [B, S, 3]
    const uint8_t* __restrict__ valid,    // [B, S]
    const long long* __restrict__ n_support,  // [B] valid support points
    const long long* __restrict__ n_query,    // [B] valid queries
    int Q, int S, int NR, int LW,
    float* __restrict__ d_out,            // [B, Q]
    int* __restrict__ i_out) {            // [B, Q]
  __shared__ float4 win[kMaxRows * kSeg];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = window_start(tile, n_support[b], n_query[b], NR, LW);
  const float* sb = support + (size_t)b * S * 3;
  const uint8_t* vb = valid + (size_t)b * S;
  for (int j = threadIdx.x; j < LW * kSeg; j += kThreads) {
    const int s = r0 * kSeg + j;
    win[j] = s < S ? make_float4(sb[3 * s], sb[3 * s + 1], sb[3 * s + 2],
                                 vb[s] ? 1.f : 0.f)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int q = tile * kTile + threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q < Q) {
    const float* qp = query + ((size_t)b * Q + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  unsigned best = 0xffffffffu;
  for (int c = part; c < kSeg; c += kParts) {
    unsigned m = 0xffffffffu;
    for (int row = 0; row < LW; ++row)
      m = min(m, window_key(qx, qy, qz, win[row * kSeg + c], (unsigned)row));
    const unsigned rank = (unsigned)((r0 + (int)(m & kRowMask)) * kSeg + c);
    best = min(best, (m & ~kRankMask) | rank);
  }
#pragma unroll
  for (int off = 1; off < kParts; off <<= 1)
    best = min(best, __shfl_xor_sync(kFull, best, off));
  if (part == 0 && q < Q) {
    d_out[(size_t)b * Q + q] = __uint_as_float(best & ~kRankMask);
    i_out[(size_t)b * Q + q] = min((int)(best & kRankMask), S - 1);
  }
}

}  // namespace

// Returns a CUDA error code; cudaErrorInvalidValue for a window the kernel
// does not take.
extern "C" int bnn1_launch(const float* query, const float* support,
                           const uint8_t* valid, const long long* n_support,
                           const long long* n_query, int B, int Q, int S,
                           int NR, int LW, float* d_out, int* i_out,
                           void* stream) {
  if (LW < 16 || LW > kMaxRows || LW > NR || NR * kSeg < S)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Q + kTile - 1) / kTile, B);
  bnn1_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      query, support, valid, n_support, n_query, Q, S, NR, LW, d_out, i_out);
  return (int)cudaGetLastError();
}
