// Rank-banded radius-kNN over B Morton-sorted clouds: stage A (the two
// nearest window points of each of 128 stride-interleaved rank columns) and
// stage B (the exact k smallest of those 256 candidates), in one launch.
//
// Replaces buffer_tpu/kernels/geom_pallas.py:banded_knn_tpu (_bknn_kernel)
// and its stage B topk_packed_tpu (_topk_knockout_kernel).  Contract, as in
// the plain version kernels/knn_cuda.py:banded_knn_plain:
//  * support of cloud b: [S] points and validity, rank s at row s / 128,
//    column s % 128 of an NR-row grid, ranks >= S invalid at (0, 0, 0);
//  * query tile t (32 queries) searches rows r0 .. r0 + LW - 1, r0 the
//    fp32 window rule of kernels/knn_cuda.py:window_starts from the valid
//    counts of support and query;
//  * d2 = ((dx*dx + dy*dy) + dz*dz) separately rounded, + 1e9 where the
//    point is invalid, floored at 1e-30; key = (bits(d2) & ~0x3F) | row;
//  * per column the winner is the smallest key, the runner-up the smallest
//    among the other rows with the winner's row replaced by bits(1e9);
//  * candidate = (bits(m) & ~0xFFFF) | rank, m = key & ~0xFFFF, or 1e9 when
//    a radius is given and m > r2;
//  * stage B: k rounds, each emits the smallest candidate and replaces every
//    candidate equal to it by bits(1e9); out d2 = float(key & ~0xFFFF),
//    idx = min(key & 0xFFFF, S - 1), valid = d2 < 5e8.
// Keys are bit patterns of non-negative floats: unsigned order is float order.
//
// Bound: operations (B*Q*LW*128 distance tests of ~8 flops; the window is
// read from L2, 13 bytes a point per 16 queries).  Design: one block of 128
// threads per (query tile, cloud), one thread per column walking its LW
// rows; a row's loads are coalesced across the block.  Each block derives
// its window from the two valid counts, so the wrapper launches nothing but
// two sums besides the kernel (computing the starts with PyTorch would add
// ~18 small launches a call, and the host's launch rate would then set the
// call's time).  The tile's queries go in two groups of 16 so their
// coordinates and (winner, runner-up) keys stay in registers.  The 256
// candidates per query go to shared memory (32 KB), never to device memory;
// stage B is one warp per query, k rounds of a warp min with knock-out over
// 8 keys a lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 128;
constexpr int kTile = 32;
constexpr int kGroup = 16;
constexpr int kCand = 2 * kSeg;
constexpr int kPerLane = kCand / 32;
constexpr unsigned kBigKey = 0x4E6E6B28u;  // bits of 1e9f
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

// The support point of rank s as (x, y, z, 1 if valid else 0).
__device__ __forceinline__ float4 support_point(const float* sb,
                                                const uint8_t* vb, int s,
                                                int S) {
  if (s >= S) return make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(sb[3 * s], sb[3 * s + 1], sb[3 * s + 2],
                     vb[s] ? 1.f : 0.f);
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

__device__ __forceinline__ unsigned candidate(unsigned key, int r0, int col,
                                              float r2, int use_radius) {
  const unsigned rank = (unsigned)((r0 + (int)(key & kRowMask)) * kSeg + col);
  unsigned m = key & ~kRankMask;
  if (use_radius && !(__uint_as_float(m) <= r2)) m = kBigKey & ~kRankMask;
  return m | rank;
}

__global__ void __launch_bounds__(kSeg) bknn_kernel(
    const float* __restrict__ query,      // [B, Q, 3]
    const float* __restrict__ support,    // [B, S, 3]
    const uint8_t* __restrict__ valid,    // [B, S]
    const long long* __restrict__ n_support,  // [B] valid support points
    const long long* __restrict__ n_query,    // [B] valid queries
    int Q, int S, int NR, int LW, int k, float r2, int use_radius,
    float* __restrict__ d_out,            // [B, Q, k]
    int* __restrict__ i_out,              // [B, Q, k]
    uint8_t* __restrict__ v_out) {        // [B, Q, k]
  __shared__ unsigned cand[kTile][kCand];
  __shared__ float qs[kTile][3];
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int col = threadIdx.x;
  const int q0 = tile * kTile;
  const int r0 = window_start(tile, n_support[b], n_query[b], NR, LW);
  const float* qb = query + (size_t)b * Q * 3;
  for (int j = col; j < kTile * 3; j += kSeg) {
    const int q = q0 + j / 3;
    qs[j / 3][j % 3] = q < Q ? qb[(size_t)q * 3 + j % 3] : 0.f;
  }
  __syncthreads();

  // stage A
  const float* sb = support + (size_t)b * S * 3;
  const uint8_t* vb = valid + (size_t)b * S;
  for (int g = 0; g < kTile; g += kGroup) {
    float qx[kGroup], qy[kGroup], qz[kGroup];
    unsigned b1[kGroup], b2[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      qx[j] = qs[g + j][0];
      qy[j] = qs[g + j][1];
      qz[j] = qs[g + j][2];
      b1[j] = 0xffffffffu;
      b2[j] = 0xffffffffu;
    }
    for (int row = 0; row < LW; ++row) {
      const float4 s = support_point(sb, vb, (r0 + row) * kSeg + col, S);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        // running (winner, runner-up); keys of different rows differ
        const unsigned key = window_key(qx[j], qy[j], qz[j], s, (unsigned)row);
        b2[j] = min(b2[j], max(b1[j], key));
        b1[j] = min(b1[j], key);
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      cand[g + j][col] = candidate(b1[j], r0, col, r2, use_radius);
      cand[g + j][kSeg + col] =
          candidate(min(b2[j], kBigKey), r0, col, r2, use_radius);
    }
  }
  __syncthreads();

  // stage B: warp w takes the tile's queries w, w + 4, ...
  const int warp = col >> 5;
  const int lane = col & 31;
  for (int ql = warp; ql < kTile && q0 + ql < Q; ql += kSeg / 32) {
    unsigned keys[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) keys[j] = cand[ql][lane + 32 * j];
    const size_t out = ((size_t)b * Q + q0 + ql) * k;
    for (int j = 0; j < k; ++j) {
      unsigned m = keys[0];
#pragma unroll
      for (int t = 1; t < kPerLane; ++t) m = min(m, keys[t]);
      m = __reduce_min_sync(kFull, m);
#pragma unroll
      for (int t = 0; t < kPerLane; ++t)
        if (keys[t] == m) keys[t] = kBigKey;
      if (lane == 0) {
        const float d = __uint_as_float(m & ~kRankMask);
        d_out[out + j] = d;
        i_out[out + j] = min((int)(m & kRankMask), S - 1);
        v_out[out + j] = d < 5e8f ? 1 : 0;
      }
    }
  }
}

}  // namespace

// Returns a CUDA error code; cudaErrorInvalidValue for a k or a window the
// kernel does not take.
extern "C" int bknn_launch(const float* query, const float* support,
                           const uint8_t* valid, const long long* n_support,
                           const long long* n_query, int B, int Q, int S,
                           int NR, int LW, int k, float r2, int use_radius,
                           float* d_out, int* i_out, uint8_t* v_out,
                           void* stream) {
  if (k < 1 || k > kSeg || LW < 16 || LW > 64 || LW > NR || NR * kSeg < S)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Q + kTile - 1) / kTile, B);
  bknn_kernel<<<grid, kSeg, 0, (cudaStream_t)stream>>>(
      query, support, valid, n_support, n_query, Q, S, NR, LW, k, r2,
      use_radius, d_out, i_out, v_out);
  return (int)cudaGetLastError();
}
