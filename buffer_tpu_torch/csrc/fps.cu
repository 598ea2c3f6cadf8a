// Farthest point sampling over B clouds, one thread-block cluster per cloud.
//
// Replaces buffer_tpu/kernels/fps_pallas.py:fps_pallas_batched
// (_fps_kernel_batched) and, at B = 1, fps_pallas (_fps_kernel).  Contract:
// idx [B, S] i32.  The chain starts at the first eligible point (index 0
// when none is); the running min-distance of eligible points starts at 1e10
// and of ineligible points is pinned at -1, so they never win while an
// eligible point remains; each step takes the argmax, lowest index on a
// tie.  Distances are ((dx*dx + dy*dy) + dz*dz) without FMA: FPS is
// chaotic, one differently rounded distance changes every later index, so
// the plain version repeats this arithmetic exactly.
//
// Bound: latency of the S-step serial chain; the operations of a step are
// few (9 flops a point), so what a step costs is its argmax across the
// cloud.  Design: the cloud is split over a cluster of C CTAs of T threads,
// P points a thread (the plan comes from kernels/fps_cuda.py:fps_plan and
// is checked here); thread t of CTA r owns the P points from (r*T + t)*P
// on, so indices ascend with the lane, the warp and the rank.  Each thread
// keeps its points' x, y, z and running min-distance in registers for the
// whole chain, so the loop reads no device memory.  A step's argmax is
// hierarchical, on an order-preserving uint32 key of the min-distance
// (out-of-range slots hold -inf, below every real point); at each level the
// lowest holder of the highest key (__reduce_max_sync, then the lowest bit
// of a ballot) holds the lowest index with that key:
//   warp    the winning lane posts (key; x, y, z, index) to shared memory;
//   CTA     after one __syncthreads, warp 0 picks the CTA's candidate and
//           its lane j < C sends it into slot `rank` of CTA j's shared
//           memory (st.async over distributed shared memory), which counts
//           its bytes on CTA j's mbarrier for the step's parity;
//   cluster each CTA waits on its own mbarrier until all C candidates have
//           landed, and each warp reduces the C slots itself, so the next
//           centroid's coordinates arrive with the winner.
// Slots and barriers are double-buffered by step parity: a CTA sends step
// m + 2 only after every CTA's step m + 1, which each CTA sends only after
// all its threads have read step m.  (highest key, lowest index) is
// associative, so the grouping cannot change a result.  Rank 0 writes each
// step's index to `out`, off the chain.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// CTAs a cluster: 8 is the portable size; Hopper also schedules 16, which
// a kernel has to opt in to (cudaFuncAttributeNonPortableClusterSizeAllowed)
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSlotBytes = 20;  // a candidate: key + (x, y, z, index)

// Threads a CTA that the register budget allows at P points a thread.
template <int P>
constexpr int max_threads() {
  return P <= 4 ? 1024 : (P == 8 ? 768 : 512);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Monotone map of a float to uint32 (larger float, larger key).
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The lowest lane holding the warp's highest key: lanes own ascending
// index ranges, so that lane holds the lowest index on a tie.
__device__ __forceinline__ int warp_argmax(unsigned key) {
  const unsigned top = __reduce_max_sync(kFull, key);
  return __ffs(__ballot_sync(kFull, key == top)) - 1;
}

template <int P>
__global__ void __launch_bounds__(max_threads<P>()) fps_cluster_kernel(
    const float* __restrict__ pts,         // [B, N, 3]
    const uint8_t* __restrict__ eligible,  // [B, N]
    int N, int S, int* __restrict__ out) { // [B, S]
  // each warp's and each CTA's candidate: a key, and (x, y, z, index bits);
  // CTA j's candidate goes to slot j of every CTA, by step parity, with
  // full[parity] counting its bytes
  __shared__ unsigned warp_key[32];
  __shared__ float4 warp_cand[32];
  __shared__ unsigned slot_key[2][kMaxCluster];
  __shared__ float4 slot_cand[2][kMaxCluster];
  __shared__ __align__(8) unsigned long long full[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int base = (rank * T + t) * P;
  const size_t off = (size_t)b * N;

  // out-of-range slots hold -inf: below the -1 of ineligible points, and
  // fminf with a distance keeps both where they are
  float px[P], py[P], pz[P], mind[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = base + p;
    px[p] = py[p] = pz[p] = 0.f;
    mind[p] = -INFINITY;
    if (i < N) {
      const float* q = pts + (off + i) * 3;
      px[p] = q[0];
      py[p] = q[1];
      pz[p] = q[2];
      mind[p] = eligible[off + i] ? 1e10f : -1.f;
    }
  }
  // warp 0's lane j < C sends the CTA's candidate to CTA j
  unsigned r_key = 0, r_cand = 0, r_full = 0;
  if (warp == 0 && lane < C) {
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r_key) : "r"(smem_u32(&slot_key[0][0])), "r"(lane));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r_cand) : "r"(smem_u32(&slot_cand[0][0])), "r"(lane));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r_full) : "r"(smem_u32(&full[0])), "r"(lane));
  }
  const unsigned tx = (unsigned)C * kSlotBytes;
  if (t == 0) {
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&full[q])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int q = 0; q < 2; ++q)  // armed for steps 0 and 1
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_u32(&full[q])), "r"(tx) : "memory");
  }
  cluster.sync();  // every CTA is running and its barriers are armed

  float cx = 0.f, cy = 0.f, cz = 0.f;
  for (int m = 0; m < S; ++m) {
    // thread: update its points and take their highest min-distance
    float bv = -INFINITY;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (m > 0) {
        const float dx = __fsub_rn(px[p], cx);
        const float dy = __fsub_rn(py[p], cy);
        const float dz = __fsub_rn(pz[p], cz);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        mind[p] = fminf(mind[p], d);  // d >= 0 > -1: ineligible stay pinned
      }
      bv = fmaxf(bv, mind[p]);
    }
    // warp -> CTA: the winning lane posts its first point holding bv
    const unsigned key = order_key(bv);
    if (lane == warp_argmax(key)) {
      int bp = P - 1;
      float bx = px[P - 1], by = py[P - 1], bz = pz[P - 1];
#pragma unroll
      for (int p = P - 2; p >= 0; --p) {
        if (mind[p] == bv) {
          bp = p;
          bx = px[p];
          by = py[p];
          bz = pz[p];
        }
      }
      warp_key[warp] = key;
      warp_cand[warp] = make_float4(bx, by, bz, __int_as_float(base + bp));
    }
    __syncthreads();
    const int par = m & 1;
    if (warp == 0) {  // CTA -> every CTA of the cluster
      const unsigned k = lane < (T >> 5) ? warp_key[lane] : 0u;  // 0: below all
      const int w = warp_argmax(k);
      const unsigned top = __shfl_sync(kFull, k, w);
      const float4 c = warp_cand[w];
      if (lane < C) {
        const unsigned slot = (unsigned)(par * kMaxCluster + rank);
        const unsigned bar = r_full + (unsigned)par * 8u;
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32"
            " [%0], %1, [%2];"
            :: "r"(r_key + slot * 4u), "r"(top), "r"(bar) : "memory");
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
            " [%0], {%1, %2, %3, %4}, [%5];"
            :: "r"(r_cand + slot * 16u), "f"(c.x), "f"(c.y), "f"(c.z),
               "f"(c.w), "r"(bar) : "memory");
      }
    }
    // wait for the C candidates of this step (phase m / 2 of full[par])
    asm volatile(
        "{\n .reg .pred done;\n WAIT:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        " @!done bra WAIT;\n }\n"
        :: "r"(smem_u32(&full[par])), "r"((unsigned)(m >> 1) & 1u) : "memory");
    // re-arm for step m + 2; its bytes can only come after this CTA's
    // candidate of step m + 1, which every thread's reads below precede
    if (t == 0 && m + 2 < S)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_u32(&full[par])), "r"(tx) : "memory");
    const unsigned k = lane < C ? slot_key[par][lane] : 0u;
    const float4 c = slot_cand[par][warp_argmax(k)];
    cx = c.x;
    cy = c.y;
    cz = c.z;
    if (rank == 0 && t == 0) out[(size_t)b * S + m] = __float_as_int(c.w);
  }
  cluster.sync();  // no CTA exits while candidates to it are in flight
}

// The launch of B clusters of C CTAs; opts in to clusters above the
// portable size.
template <int P>
cudaError_t configure(int B, int C, int T, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (T > max_threads<P>()) return cudaErrorInvalidValue;
  if (C > kPortableCluster) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_cluster_kernel<P>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * C);
  cfg->blockDim = dim3(T);
  cfg->dynamicSmemBytes = 0;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int P>
int launch(const float* pts, const uint8_t* e, int B, int N, int S, int C,
           int T, int* out, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<P>(B, C, T, stream, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel<P>, pts, e, N, S, out);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <int P>
int max_clusters(int C, int T) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t err = configure<P>(kMaxCluster, C, T, nullptr, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, fps_cluster_kernel<P>, &cfg);
  cudaGetLastError();
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// Launches the plan (C CTAs a cluster, T threads a CTA, P points a thread)
// over B clouds of N points.  Returns a CUDA error code:
// cudaErrorInvalidValue for a plan that does not cover the cloud exactly
// (C*T*P >= N with no empty CTA), a T that is not a multiple of 32 or over
// P's register budget, a P without an instantiation, or C > 16; otherwise
// the launch's own error (a cluster the card cannot schedule).
extern "C" int fps_launch(const float* pts, const uint8_t* eligible, int B,
                          int N, int S, int C, int T, int P, int* out,
                          void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || N < 1 || S < 1 || C < 1 || C > kMaxCluster || T < 32 ||
      T % 32 != 0 || (long long)C * T * P < N ||
      (long long)(C - 1) * T * P >= N)
    return (int)cudaErrorInvalidValue;
  switch (P) {
    case 1: return launch<1>(pts, eligible, B, N, S, C, T, out, st);
    case 2: return launch<2>(pts, eligible, B, N, S, C, T, out, st);
    case 4: return launch<4>(pts, eligible, B, N, S, C, T, out, st);
    case 8: return launch<8>(pts, eligible, B, N, S, C, T, out, st);
    case 16: return launch<16>(pts, eligible, B, N, S, C, T, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of the plan the card can hold at once
// (cudaOccupancyMaxActiveClusters): 0 when it cannot schedule one, minus
// the CUDA error code when the query fails.
extern "C" int fps_max_active_clusters(int C, int T, int P) {
  if (C < 1 || C > kMaxCluster || T < 32 || T % 32 != 0)
    return -(int)cudaErrorInvalidValue;
  switch (P) {
    case 1: return max_clusters<1>(C, T);
    case 2: return max_clusters<2>(C, T);
    case 4: return max_clusters<4>(C, T);
    case 8: return max_clusters<8>(C, T);
    case 16: return max_clusters<16>(C, T);
    default: return -(int)cudaErrorInvalidValue;
  }
}
