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
// Keys are bit patterns of positive normal floats: float order is unsigned
// order.
//
// Bound: operations (B*Q*LW*128 window tests).  The contract fixes ~14
// issue slots a test (3 FADD for the differences, 3 FMUL and 2 FADD for d2
// without contraction, the penalty FADD, the floor, one LOP3 for the row,
// three min/max for winner and runner-up), so the issue rate of the FP32
// pipe is the floor.  Design, all in one C entry point:
//  * a pack kernel writes the support once a call as float4 (x, y, z, pen),
//    pen = 0 for a valid point and 1e9 for an invalid or padded rank, so
//    the test adds pen unconditionally (d + 0 == d for d >= +0), and counts
//    the valid support and query points of each cloud (__syncthreads_count,
//    one atomicAdd a block) for the window rule;
//  * the search kernel: a block takes one tile, 2 groups of 16 queries,
//    one thread per (group, column).  Its window is LW consecutive rows,
//    a contiguous slice of the packed support; the block streams it once
//    through a ring of 8-row chunks (16 KB) in shared memory, each chunk
//    one cp.async.bulk completing on its mbarrier, and each thread reads
//    one 16-byte shared load a point for its 16 queries.  Winner and
//    runner-up are compared as floats (FMNMX) with a +inf sentinel;
//  * after the window, the 256 candidates of each query go to the ring's
//    shared memory and stage B runs one warp per query, k rounds of a warp
//    min with knock-out over 8 keys a lane.  The SM holds two blocks, so
//    one block's stage B overlaps the other's stage A.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 128;
constexpr int kTile = 32;
constexpr int kGroup = 16;  // queries a thread
constexpr int kThreadsATile = kSeg * (kTile / kGroup);
constexpr int kCand = 2 * kSeg;
constexpr int kPerLane = kCand / 32;
constexpr int kChunkRows = 8;
constexpr int kChunkBytes = kChunkRows * kSeg * 16;
constexpr int kMaxRing = 8;
constexpr unsigned kBigKey = 0x4E6E6B28u;  // bits of 1e9f
constexpr unsigned kRowMask = 0x3Fu;
constexpr unsigned kRankMask = 0xFFFFu;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// First window row of query tile `tile` (kernels/knn_cuda.py:window_starts).
__device__ __forceinline__ int window_start(int tile, int n_support,
                                            int n_query, int NR, int LW) {
  const float ratio = __fdiv_rn(fmaxf((float)n_support, 1.f),
                                fmaxf((float)n_query, 1.f));
  const float center =
      __fmul_rn(__fadd_rn(__fmul_rn((float)tile, (float)kTile), 16.f), ratio);
  const float row = __fdiv_rn(center, (float)kSeg);
  const int r0 = (int)__fadd_rn(__fdiv_rn(row, 8.f), 0.5f) * 8 - LW / 2;
  return min(max(r0, 0), max(((NR - LW) / 8) * 8, 0));
}

__device__ __forceinline__ unsigned candidate(unsigned key, int r0, int col,
                                              float r2, int use_radius) {
  const unsigned rank = (unsigned)((r0 + (int)(key & kRowMask)) * kSeg + col);
  unsigned m = key & ~kRankMask;
  if (use_radius && !(__uint_as_float(m) <= r2)) m = kBigKey & ~kRankMask;
  return m | rank;
}

// packed[b, s] = (x, y, z, 0 if valid else 1e9) for s < NR*128 (padded
// ranks invalid at the origin); counts[b] = (#valid support, #valid query).
__global__ void __launch_bounds__(256) bknn_pack_kernel(
    const float* __restrict__ support, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ query_valid, int S, int Q, int NR,
    float4* __restrict__ packed, int* __restrict__ counts) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool ok = i < S && valid[(size_t)b * S + i] != 0;
  if (i < NR * kSeg) {
    float4 p = make_float4(0.f, 0.f, 0.f, 1e9f);
    if (i < S) {
      const float* s = support + ((size_t)b * S + i) * 3;
      p = make_float4(s[0], s[1], s[2], ok ? 0.f : 1e9f);
    }
    packed[(size_t)b * NR * kSeg + i] = p;
  }
  const int cs = __syncthreads_count(ok);
  const int cq = __syncthreads_count(i < Q && query_valid[(size_t)b * Q + i]);
  if (threadIdx.x == 0) {
    if (cs) atomicAdd(&counts[2 * b], cs);
    if (cq) atomicAdd(&counts[2 * b + 1], cq);
  }
}

// At <= 128 registers the SM holds two blocks.
__global__ void __launch_bounds__(kThreadsATile, 2) bknn_kernel(
    const float* __restrict__ query,      // [B, Q, 3]
    const float4* __restrict__ packed,    // [B, NR*128]
    const int* __restrict__ counts,       // [B, 2]
    int Q, int S, int NR, int LW, int k, float r2, int use_radius, int ring,
    float* __restrict__ d_out,            // [B, Q, k]
    int* __restrict__ i_out,              // [B, Q, k]
    uint8_t* __restrict__ v_out) {        // [B, Q, k]
  // [ring chunks | (later) candidates] [queries] [mbarriers]
  extern __shared__ __align__(128) unsigned char smem[];
  const int body = max(ring * kChunkBytes, kTile * kCand * 4);
  const float4* chunks = reinterpret_cast<const float4*>(smem);
  unsigned* cand = reinterpret_cast<unsigned*>(smem);
  float* qs = reinterpret_cast<float*>(smem + body);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + body + kTile * 12);

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int col = tid & (kSeg - 1);
  const int group = tid / kSeg;
  const int r0 = window_start(tile, counts[2 * b], counts[2 * b + 1], NR, LW);
  const int n_chunks = LW / kChunkRows;
  const char* src = reinterpret_cast<const char*>(
      packed + ((size_t)b * NR + r0) * kSeg);

  if (tid == 0) {
    for (int c = 0; c < ring; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&full[c])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const float* qb = query + (size_t)b * Q * 3;
  for (int j = tid; j < kTile * 3; j += blockDim.x) {
    const int q = tile * kTile + j / 3;
    qs[j] = q < Q ? qb[(size_t)q * 3 + j % 3] : 0.f;
  }
  __syncthreads();

  // chunk c of the window into ring slot c % ring, completing full[c % ring]
  auto issue = [&](int c) {
    const unsigned bar = smem_u32(&full[c % ring]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"((unsigned)kChunkBytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(smem + (c % ring) * kChunkBytes)),
           "l"(src + (size_t)c * kChunkBytes), "r"((unsigned)kChunkBytes),
           "r"(bar) : "memory");
  };
  if (tid == 0)
    for (int c = 0; c < min(ring, n_chunks); ++c) issue(c);

  // stage A
  float qx[kGroup], qy[kGroup], qz[kGroup], b1[kGroup], b2[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float* q = qs + (group * kGroup + j) * 3;
    qx[j] = q[0];
    qy[j] = q[1];
    qz[j] = q[2];
    b1[j] = __uint_as_float(0x7F800000u);  // +inf: above every key
    b2[j] = __uint_as_float(0x7F800000u);
  }
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile(
        "{\n .reg .pred done;\n WAIT:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        " @!done bra WAIT;\n }\n"
        :: "r"(smem_u32(&full[c % ring])), "r"((unsigned)(c / ring) & 1u)
        : "memory");
    const float4* rows = chunks + (c % ring) * kChunkRows * kSeg + col;
#pragma unroll 2
    for (int rr = 0; rr < kChunkRows; ++rr) {
      const float4 p = rows[rr * kSeg];
      const unsigned row = (unsigned)(c * kChunkRows + rr);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float dx = __fsub_rn(qx[j], p.x);
        const float dy = __fsub_rn(qy[j], p.y);
        const float dz = __fsub_rn(qz[j], p.z);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        d = fmaxf(__fadd_rn(d, p.w), 1e-30f);
        const float key =
            __uint_as_float((__float_as_uint(d) & ~kRowMask) | row);
        // running (winner, runner-up); keys of different rows differ
        b2[j] = fminf(b2[j], fmaxf(b1[j], key));
        b1[j] = fminf(b1[j], key);
      }
    }
    __syncthreads();  // slot c % ring is read by every thread
    if (tid == 0 && c + ring < n_chunks) issue(c + ring);
  }

  // every copy issued has landed and been read: the ring holds candidates
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    unsigned* row = cand + (group * kGroup + j) * kCand;
    row[col] = candidate(__float_as_uint(b1[j]), r0, col, r2, use_radius);
    row[kSeg + col] = candidate(min(__float_as_uint(b2[j]), kBigKey), r0, col,
                                r2, use_radius);
  }
  __syncthreads();

  // stage B: warp w takes the tile's queries w, w + warps, ...
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  for (int ql = warp; ql < kTile && tile * kTile + ql < Q; ql += n_warps) {
    unsigned keys[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) keys[j] = cand[ql * kCand + lane + 32 * j];
    const size_t out = ((size_t)b * Q + tile * kTile + ql) * k;
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

// Dynamic shared memory of the search kernel (kernels/knn_cuda.py:
// bknn_smem_bytes): the ring or, after it, the candidates; the queries; the
// mbarriers.
static int smem_bytes(int ring) {
  const int body = ring * kChunkBytes > kTile * kCand * 4
                       ? ring * kChunkBytes : kTile * kCand * 4;
  return body + kTile * 12 + ring * 8;
}

// Packs the support, counts the valid points and searches, on `stream`.
// The plan (threads, ring chunks, shared bytes) comes from
// kernels/knn_cuda.py:bknn_plan.  `packed` ([B, NR*128] float4) and
// `counts` ([B, 2] int) are scratch.  Returns a CUDA error code;
// cudaErrorInvalidValue for a k, a window or a plan the kernel does not
// take.
extern "C" int bknn_launch(const float* query, const float* support,
                           const uint8_t* valid, const uint8_t* query_valid,
                           int B, int Q, int S, int NR, int LW, int k,
                           float r2, int use_radius, int threads, int ring,
                           int smem, void* packed, int* counts, float* d_out,
                           int* i_out, uint8_t* v_out, void* stream) {
  if (B < 1 || Q < 1 || k < 1 || k > kSeg || LW < 16 || LW > 64 ||
      LW % 16 || LW > NR || NR * kSeg < S || NR * kSeg > (1 << 16) ||
      threads != kThreadsATile || ring < 2 || ring > kMaxRing ||
      smem != smem_bytes(ring) || reinterpret_cast<uintptr_t>(packed) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * 2 * B, st);
  if (err != cudaSuccess) return (int)err;
  const int n_pack = NR * kSeg > Q ? NR * kSeg : Q;
  bknn_pack_kernel<<<dim3((n_pack + 255) / 256, B), 256, 0, st>>>(
      support, valid, query_valid, S, Q, NR, (float4*)packed, counts);
  err = cudaFuncSetAttribute(bknn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bknn_kernel<<<dim3((Q + kTile - 1) / kTile, B), threads, smem, st>>>(
      query, (const float4*)packed, counts, Q, S, NR, LW, k, r2, use_radius,
      ring, d_out, i_out, v_out);
  return (int)cudaGetLastError();
}
