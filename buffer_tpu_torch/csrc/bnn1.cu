// Rank-banded 1-NN over B Morton-sorted clouds: the level-0 -> level-1
// upsample of the conv pyramid and the positive-pair sampler of training.
//
// Replaces buffer_tpu/kernels/geom_pallas.py:banded_nn1_tpu (_bnn1_kernel).
// Contract, as in the plain version kernels/knn_cuda.py:banded_nn1_plain:
//  * support of cloud b: [S] points and validity, rank s at row s / 128,
//    column s % 128 of an NR-row grid, ranks >= S invalid at (0, 0, 0);
//  * query tile t (32 queries) searches rows r0 .. r0 + 15, r0 the fp32
//    window rule of kernels/knn_cuda.py:window_starts from the valid counts
//    of support and query;
//  * d2 = ((dx*dx + dy*dy) + dz*dz) separately rounded, + 1e9 where the
//    point is invalid, floored at 1e-30; key = (bits(d2) & ~0x3F) | row;
//  * per column the smallest key; across columns the smallest
//    (key & ~0xFFFF) | rank; out d2 = float(best & ~0xFFFF) and
//    idx = min(best & 0xFFFF, S - 1).
// The two levels do not fold into one min over rank keys: a row that ties
// its column's winner at 16-bit truncation would win on a lower rank.
// Keys are bit patterns of positive normal floats: float order is unsigned
// order.
//
// Bound: operations (B*Q*16*128 window tests).  The contract fixes ~12
// issue slots a test (3 FADD for the differences, 3 FMUL and 2 FADD for d2
// without contraction, the penalty FADD, the floor, one LOP3 for the row,
// the column min), so the issue rate is the floor.  Design, in one C entry
// point:
//  * a pack kernel writes the support once a call as float4 (x, y, z, pen),
//    pen = 0 for a valid point and 1e9 for an invalid or padded rank, so
//    the test adds pen unconditionally (d + 0 == d for d >= +0), and counts
//    the valid support and query points of each cloud (__syncthreads_count,
//    one atomicAdd a block) for the window rule;
//  * the search kernel: a block takes one query tile and brings its 16-row
//    window (32 KB) into shared memory as two 8-row cp.async.bulk chunks
//    completing on one mbarrier.  A warp takes QT of the tile's queries;
//    lane l takes columns l, l + 32, l + 64, l + 96, so a warp's 16-byte
//    shared loads are conflict-free and each feeds QT tests.  The column
//    min is taken on floats (FMNMX) from a +inf sentinel, with the row
//    ORed in from a register (one LOP3 with the mask as its immediate;
//    two immediates would take two); the across-column min is one warp
//    reduction a query.  Small blocks (4 warps at QT = 8, the plan) let
//    one block's window copy overlap the other blocks' tests on the SM;
//    blocks of 2 to 8 tiles sharing one copy of their windows measured
//    slower (utils/plan_sweep.py; PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 128;
constexpr int kTile = 32;
constexpr int kWinRows = 16;
constexpr int kChunkRows = 8;
constexpr int kChunkBytes = kChunkRows * kSeg * 16;
constexpr unsigned kRowMask = 0x3Fu;
constexpr unsigned kRankMask = 0xFFFFu;
constexpr unsigned kFull = 0xffffffffu;

// Threads a block at QT queries a thread: a warp for every QT of the tile's
// 32 queries.
template <int QT>
constexpr int threads() {
  return kTile / QT * 32;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// First window row of query tile `tile` (kernels/knn_cuda.py:window_starts).
__device__ __forceinline__ int window_start(int tile, int n_support,
                                            int n_query, int NR) {
  const float ratio = __fdiv_rn(fmaxf((float)n_support, 1.f),
                                fmaxf((float)n_query, 1.f));
  const float center =
      __fmul_rn(__fadd_rn(__fmul_rn((float)tile, (float)kTile), 16.f), ratio);
  const float row = __fdiv_rn(center, (float)kSeg);
  const int r0 = (int)__fadd_rn(__fdiv_rn(row, 8.f), 0.5f) * 8 - kWinRows / 2;
  return min(max(r0, 0), max(((NR - kWinRows) / 8) * 8, 0));
}

// packed[b, s] = (x, y, z, 0 if valid else 1e9) for s < NR*128 (padded
// ranks invalid at the origin); counts[b] = (#valid support, #valid query).
__global__ void __launch_bounds__(256) bnn1_pack_kernel(
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

template <int QT>
__global__ void __launch_bounds__(threads<QT>()) bnn1_kernel(
    const float* __restrict__ query,      // [B, Q, 3]
    const float4* __restrict__ packed,    // [B, NR*128]
    const int* __restrict__ counts,       // [B, 2]
    int Q, int S, int NR,
    float* __restrict__ d_out,            // [B, Q]
    int* __restrict__ i_out) {            // [B, Q]
  __shared__ __align__(128) float4 win[kWinRows * kSeg];
  __shared__ __align__(8) unsigned long long full;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = window_start(tile, counts[2 * b], counts[2 * b + 1], NR);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_u32(&full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const unsigned bar = smem_u32(&full);
    const char* src = reinterpret_cast<const char*>(
        packed + ((size_t)b * NR + r0) * kSeg);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"((unsigned)(kWinRows * kSeg * 16)) : "memory");
    for (int c = 0; c < kWinRows / kChunkRows; ++c)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_u32(win + c * kChunkRows * kSeg)),
             "l"(src + (size_t)c * kChunkBytes), "r"((unsigned)kChunkBytes),
             "r"(bar) : "memory");
  }

  const int q0 = tile * kTile + (tid >> 5) * QT;
  float qx[QT], qy[QT], qz[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int q = q0 + j;
    const float* qp = query + ((size_t)b * Q + (q < Q ? q : 0)) * 3;
    qx[j] = qp[0];
    qy[j] = qp[1];
    qz[j] = qp[2];
  }
  // the window rows as registers: a zero the compiler cannot fold (NR is
  // below 2^31) keeps each row out of the LOP3's immediate
  unsigned rows[kWinRows];
  const unsigned zero = (unsigned)NR >> 31;
#pragma unroll
  for (int row = 0; row < kWinRows; ++row) rows[row] = zero + (unsigned)row;
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      " @!done bra WAIT;\n }\n"
      :: "r"(smem_u32(&full)) : "memory");

  unsigned best[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) best[j] = kFull;
#pragma unroll 1
  for (int c = lane; c < kSeg; c += 32) {
    float m[QT];
#pragma unroll
    for (int j = 0; j < QT; ++j) m[j] = __uint_as_float(0x7F800000u);
#pragma unroll
    for (int row = 0; row < kWinRows; ++row) {
      const float4 p = win[row * kSeg + c];
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const float dx = __fsub_rn(qx[j], p.x);
        const float dy = __fsub_rn(qy[j], p.y);
        const float dz = __fsub_rn(qz[j], p.z);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        d = fmaxf(__fadd_rn(d, p.w), 1e-30f);
        m[j] = fminf(m[j], __uint_as_float((__float_as_uint(d) & ~kRowMask) |
                                           rows[row]));
      }
    }
#pragma unroll
    for (int j = 0; j < QT; ++j) {
      const unsigned k = __float_as_uint(m[j]);
      const unsigned rank = (unsigned)((r0 + (int)(k & kRowMask)) * kSeg + c);
      best[j] = min(best[j], (k & ~kRankMask) | rank);
    }
  }
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const unsigned k = __reduce_min_sync(kFull, best[j]);
    const int q = q0 + j;
    if (lane == j && q < Q) {
      d_out[(size_t)b * Q + q] = __uint_as_float(k & ~kRankMask);
      i_out[(size_t)b * Q + q] = min((int)(k & kRankMask), S - 1);
    }
  }
}

template <int QT>
void launch(const float* query, const float4* packed, const int* counts, int B,
            int Q, int S, int NR, float* d_out, int* i_out, cudaStream_t st) {
  bnn1_kernel<QT><<<dim3((Q + kTile - 1) / kTile, B), threads<QT>(), 0, st>>>(
      query, packed, counts, Q, S, NR, d_out, i_out);
}

}  // namespace

// Packs the support, counts the valid points and searches, on `stream`.
// QT, the queries a thread, comes from kernels/knn_cuda.py:bnn1_plan.
// `packed` ([B, NR*128] float4) and `counts` ([B, 2] int) are scratch.
// Returns a CUDA error code; cudaErrorInvalidValue for a grid or a QT the
// kernel does not take.
extern "C" int bnn1_launch(const float* query, const float* support,
                           const uint8_t* valid, const uint8_t* query_valid,
                           int B, int Q, int S, int NR, int queries,
                           void* packed, int* counts, float* d_out, int* i_out,
                           void* stream) {
  if (B < 1 || Q < 1 || NR < kWinRows || NR * kSeg < S ||
      NR * kSeg > (1 << 16) || (queries != 4 && queries != 8 && queries != 16) ||
      reinterpret_cast<uintptr_t>(packed) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * 2 * B, st);
  if (err != cudaSuccess) return (int)err;
  const int n_pack = NR * kSeg > Q ? NR * kSeg : Q;
  bnn1_pack_kernel<<<dim3((n_pack + 255) / 256, B), 256, 0, st>>>(
      support, valid, query_valid, S, Q, NR, (float4*)packed, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float4* p = (const float4*)packed;
  switch (queries) {
    case 4: launch<4>(query, p, counts, B, Q, S, NR, d_out, i_out, st); break;
    case 8: launch<8>(query, p, counts, B, Q, S, NR, d_out, i_out, st); break;
    default: launch<16>(query, p, counts, B, Q, S, NR, d_out, i_out, st);
  }
  return (int)cudaGetLastError();
}
