// Exact 1-NN of each query over a valid-masked support, batched over clouds.
//
// Replaces buffer_tpu/kernels/geom_pallas.py:nearest_tpu (_nearest_kernel).
// Contract, as in the plain version kernels/geom_cuda.py:nearest_plain:
// (d2 [B, Q] f32, idx [B, Q] i32); d2 is the fp32 squared
// coordinate-difference distance ((dx*dx + dy*dy) + dz*dz, no FMA);
// invalid support points never win; the lowest index wins a tie; a query
// with no valid support (or none nearer than 1e9) gets (1e9, 0).
//
// Bound: operations (B*Q*S distance tests, ~11 issue slots each: 3 FADD,
// 3 FMUL, 2 FADD, then a compare and two selects).  Design: one
// thread-block cluster of P CTAs takes 32*QT queries of one cloud; CTA r
// takes the r-th of P contiguous slices of the support and its W warps
// split the slice again, so the grid fills the card several times over
// although a preset's call has only ~20k queries.  A CTA stages its slice
// once as float4 with invalid points moved to +inf (q - inf = -inf, its
// square +inf: an invalid point never beats the 1e9 start, and the loop
// holds no validity test).  Each lane keeps QT queries in registers, so a
// broadcast 16-byte shared load feeds QT tests, and scans its warp's
// points in index order with a strict compare (the lowest index wins
// within a thread).  The partial results merge as 64-bit keys
// (bits(d2) << 32) | idx -- d2 >= +0, so integer order is (d2, idx) order
// -- first across the warps of a CTA in shared memory, then across the
// cluster through distributed shared memory; no scratch in device memory
// and one launch a call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kUnroll = 4;
// support points a CTA stages (kernels/geom_cuda.py NEAREST_MAX_SLICE)
constexpr int kMaxSlice = 12288;
constexpr int kMaxSmem = 232448;  // shared bytes a block can opt in to
constexpr float kBig = 1e9f;

// Points a warp scans of a slice: a multiple of kUnroll.
__host__ __device__ constexpr int run_of(int slice) {
  return ((slice + kWarps - 1) / kWarps + kUnroll - 1) / kUnroll * kUnroll;
}

// Shared bytes of a CTA: the staged slice (kWarps runs of `run` points)
// and the per-warp and merged keys of its 32*QT queries.
__host__ __device__ constexpr int smem_bytes(int run, int QT) {
  return kWarps * run * 16 + (kWarps + 1) * 32 * QT * 8;
}
static_assert(smem_bytes(run_of(kMaxSlice), 8) <= kMaxSmem,
              "a full slice must fit at every instantiation");

template <int QT>
__global__ void __launch_bounds__(kThreads) nearest_kernel(
    const float* __restrict__ query,     // [B, Q, 3]
    const float* __restrict__ support,   // [B, S, 3]
    const uint8_t* __restrict__ valid,   // [B, S]
    int Q, int S, int groups, int slice, int run,
    float* __restrict__ d_out,           // [B, Q]
    int* __restrict__ i_out) {           // [B, Q]
  extern __shared__ __align__(16) unsigned char smem[];
  float4* pts = reinterpret_cast<float4*>(smem);
  unsigned long long* part =
      reinterpret_cast<unsigned long long*>(smem + kWarps * run * 16);
  unsigned long long* merged = part + kWarps * 32 * QT;
  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / P;
  const int b = group / groups;
  const int qbase = (group % groups) * 32 * QT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the slice [s0, s1) as kWarps runs of `run` points, padded with +inf
  const int s0 = rank * slice;
  const int s1 = min(s0 + slice, S);
  const float* sb = support + (size_t)b * S * 3;
  const uint8_t* vb = valid + (size_t)b * S;
  const float inf = __uint_as_float(0x7F800000u);
  for (int j = tid; j < kWarps * run; j += kThreads) {
    const int s = s0 + j;
    float4 p = make_float4(inf, inf, inf, 0.f);
    if (s < s1 && vb[s]) p = make_float4(sb[3 * s], sb[3 * s + 1], sb[3 * s + 2], 0.f);
    pts[j] = p;
  }
  float qx[QT], qy[QT], qz[QT], bd[QT];
  int bi[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int q = qbase + j * 32 + lane;
    const float* qp = query + ((size_t)b * Q + (q < Q ? q : 0)) * 3;
    qx[j] = qp[0];
    qy[j] = qp[1];
    qz[j] = qp[2];
    bd[j] = kBig;
    bi[j] = 0;
  }
  __syncthreads();

  const float4* mine = pts + warp * run;
  const int first = s0 + warp * run;
#pragma unroll 1
  for (int i = 0; i < run; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float4 p = mine[i + u];
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const float dx = __fsub_rn(qx[j], p.x);
        const float dy = __fsub_rn(qy[j], p.y);
        const float dz = __fsub_rn(qz[j], p.z);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const bool lt = d < bd[j];
        bd[j] = lt ? d : bd[j];
        bi[j] = lt ? first + i + u : bi[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < QT; ++j)
    part[warp * 32 * QT + j * 32 + lane] =
        ((unsigned long long)__float_as_uint(bd[j]) << 32) | (unsigned)bi[j];
  __syncthreads();
  for (int t = tid; t < 32 * QT; t += kThreads) {
    unsigned long long k = part[t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) k = min(k, part[w * 32 * QT + t]);
    merged[t] = k;
  }
  cluster.sync();  // every CTA's merged keys are in place

  // CTA r writes every P-th query slot of the cluster, from all P CTAs
  for (int t = rank + P * tid; t < 32 * QT; t += P * kThreads) {
    unsigned long long k = merged[t];
    for (int r = 0; r < P; ++r)
      if (r != rank) k = min(k, cluster.map_shared_rank(merged, r)[t]);
    const int q = qbase + t;
    if (q < Q) {
      d_out[(size_t)b * Q + q] = __uint_as_float((unsigned)(k >> 32));
      i_out[(size_t)b * Q + q] = (int)(unsigned)k;
    }
  }
  cluster.sync();  // no CTA exits while its keys may still be read
}

template <int QT>
int launch(const float* query, const float* support, const uint8_t* valid,
           int B, int Q, int S, int P, float* d_out, int* i_out,
           cudaStream_t st) {
  const int groups = (Q + 32 * QT - 1) / (32 * QT);
  const int slice = (S + P - 1) / P;
  if (slice > kMaxSlice) return (int)cudaErrorInvalidValue;
  const int run = run_of(slice);
  const int smem = smem_bytes(run, QT);
  cudaError_t err = cudaFuncSetAttribute(
      nearest_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * groups * P);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = P;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nearest_kernel<QT>, query, support, valid, Q,
                           S, groups, slice, run, d_out, i_out);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// Launches the plan (QT queries a thread, clusters of P CTAs splitting the
// support) from kernels/geom_cuda.py:nearest_plan on `stream`.  Returns a
// CUDA error code; cudaErrorInvalidValue for a plan the kernel does not take
// (QT without an instantiation, P outside 1..8, a slice past kMaxSlice
// points).
extern "C" int nearest_launch(const float* query, const float* support,
                              const uint8_t* valid, int B, int Q, int S,
                              int queries, int cluster, float* d_out,
                              int* i_out, void* stream) {
  if (B < 1 || Q < 1 || S < 1 || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (queries) {
    case 1: return launch<1>(query, support, valid, B, Q, S, cluster, d_out, i_out, st);
    case 2: return launch<2>(query, support, valid, B, Q, S, cluster, d_out, i_out, st);
    case 4: return launch<4>(query, support, valid, B, Q, S, cluster, d_out, i_out, st);
    case 8: return launch<8>(query, support, valid, B, Q, S, cluster, d_out, i_out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
