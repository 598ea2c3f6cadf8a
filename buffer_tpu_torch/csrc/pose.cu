// The pose solver: weighted rigid alignment by Horn's quaternion method
// (a shifted power iteration on the 4x4 Davenport matrix), batched, and the
// IRLS pose refinement built on it, each in one launch.
//
// Replaces no TPU kernel.  The JAX package leaves
// buffer_tpu/core/se3.py:kabsch_quat and
// buffer_tpu/pipeline/refine.py:post_refinement to XLA, which fuses them;
// in PyTorch each power step is ~6 library launches on one 4x4 matrix, so
// an IRLS round made ~400 launches and a boost tail ~8,000.
// Contract, as the plain versions core/se3.py:kabsch_quat and
// kernels/pose_cuda.py:irls_plain (the post_refinement loop): float32;
// wsum = sum(w) + eps, the centroids sum(A*w) / wsum and sum(B*w) / wsum,
// H = sum(((A - cA)*w) (x) (B - cB)), the Davenport matrix shifted by
// 2*sqrt(sum(H*H) + eps), `steps` power steps from q = (1, 1, 1, 1), each
// divided by max(|q|, eps), R from q and t = cB - R cA; an IRLS round warps
// each source point (p R^T + t), keeps the inliers (d < th) & valid with
// the weights 1/(1 + (d/th)^2), and takes the solve's pose when at least 3
// points are inliers.  Every expression is the plain version's, each
// operation separately rounded (--fmad=false), but the sums run in another
// order (a thread's points in index order, then a fixed tree), so kernel
// and plain version agree to rounding, not bit for bit; a launch gives the
// same bits every time (no atomics).
//
// Bound: latency.  A solve is ~30 flops a point and `steps` dependent 4x4
// steps (a square root and 4 divisions each); the library version's cost
// is its launches, not its work.  Design: a problem of at most kThreadMaxN
// points (RANSAC's 3-point hypotheses) is one thread's, points, sums and
// the power steps in registers; a larger one (RANSAC's refit, an IRLS
// round) is one CTA's: a block reduction of the weights and weighted sums,
// the centroids, a second of H, then one thread runs the power steps in
// registers.  IRLS keeps the pose in shared memory and runs every round of
// a pair in one CTA, the inlier count a third lane of the first reduction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;       // a CTA's threads (a large problem, IRLS)
constexpr int kWarps = kThreads / 32;
constexpr int kThreadMaxN = 32;     // the points of a problem one thread solves
constexpr int kSmallThreads = 128;  // threads a block of one-thread problems

// The pose [R | t] (3x4, row-major) from H's 9 sums and the centroids:
// kabsch_quat's Davenport matrix, shift and power steps.
__device__ void solve(const float* H, const float* cA, const float* cB,
                      float eps, int steps, float* P) {
  const float Sxx = H[0], Sxy = H[1], Sxz = H[2];
  const float Syx = H[3], Syy = H[4], Syz = H[5];
  const float Szx = H[6], Szy = H[7], Szz = H[8];
  float hh = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) hh = hh + H[i] * H[i];
  const float shift = 2.0f * sqrtf(hh + eps);
  const float K[16] = {
      ((Sxx + Syy) + Szz) + shift, Syz - Szy, Szx - Sxz, Sxy - Syx,
      Syz - Szy, ((Sxx - Syy) - Szz) + shift, Sxy + Syx, Szx + Sxz,
      Szx - Sxz, Sxy + Syx, ((-Sxx + Syy) - Szz) + shift, Syz + Szy,
      Sxy - Syx, Szx + Sxz, Syz + Szy, ((-Sxx - Syy) + Szz) + shift};
  float q[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  for (int s = 0; s < steps; ++s) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = ((K[4 * i] * q[0] + K[4 * i + 1] * q[1]) + K[4 * i + 2] * q[2]) +
             K[4 * i + 3] * q[3];
    const float n = fmaxf(
        sqrtf(((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]) + p[3] * p[3]), eps);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = p[i] / n;
  }
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float R[9] = {
      1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z),
      2.0f * (x * z + w * y),        2.0f * (x * y + w * z),
      1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - w * x),
      2.0f * (x * z - w * y),        2.0f * (y * z + w * x),
      1.0f - 2.0f * (x * x + y * y)};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    P[4 * i] = R[3 * i];
    P[4 * i + 1] = R[3 * i + 1];
    P[4 * i + 2] = R[3 * i + 2];
    P[4 * i + 3] =
        cB[i] - ((R[3 * i] * cA[0] + R[3 * i + 1] * cA[1]) + R[3 * i + 2] * cA[2]);
  }
}

// m[0] += w, m[1..3] += a*w, m[4..6] += b*w.
__device__ __forceinline__ void add_moments(const float* a, const float* b,
                                            float w, float* m) {
  m[0] = m[0] + w;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[1 + i] = m[1 + i] + a[i] * w;
    m[4 + i] = m[4 + i] + b[i] * w;
  }
}

// h[3i + j] += ((a_i - cA_i) * w) * (b_j - cB_j).
__device__ __forceinline__ void add_h(const float* a, const float* b, float w,
                                      const float* cA, const float* cB,
                                      float* h) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float da = (a[i] - cA[i]) * w;
#pragma unroll
    for (int j = 0; j < 3; ++j) h[3 * i + j] = h[3 * i + j] + da * (b[j] - cB[j]);
  }
}

// The centroids from the moments m[0..6].
__device__ __forceinline__ void centroids(const float* m, float eps, float* cA,
                                          float* cB) {
  const float wsum = m[0] + eps;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cA[i] = m[1 + i] / wsum;
    cB[i] = m[4 + i] / wsum;
  }
}

// P as a 4x4 pose, bottom row (0, 0, 0, 1).
__device__ __forceinline__ void store_pose(const float* P, float* out) {
#pragma unroll
  for (int i = 0; i < 12; ++i) out[i] = P[i];
  out[12] = 0.0f;
  out[13] = 0.0f;
  out[14] = 0.0f;
  out[15] = 1.0f;
}

// Sums v[M] over the CTA (kThreads threads): each warp in a fixed shuffle
// tree, then thread m adds the warps' m-th sums in warp order into tot[m].
// Every thread may read tot[0..M) when it returns.
template <int M>
__device__ void block_sum(float (&v)[M], float* red, float* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[m] = v[m] + __shfl_down_sync(0xffffffffu, v[m], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) red[warp * M + m] = v[m];
  }
  __syncthreads();
  if (threadIdx.x < M) {
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s = s + red[k * M + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// Problem b of A, B [bs, N, 3] and w [bs, N] (all ones when null) -> out
// [bs, 4, 4]: one thread a problem (kCta false: blocks of kSmallThreads
// threads) or one CTA of kThreads threads a problem.
template <bool kCta>
__global__ void __launch_bounds__(kThreads) kabsch_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ w, int bs, int N, float eps, int steps,
    float* __restrict__ out) {
  float m[7] = {};
  float h[9] = {};
  float cA[3], cB[3], P[12];
  if constexpr (kCta) {
    __shared__ float red[kWarps * 9];
    __shared__ float mom[7], hs[9];
    const size_t b = blockIdx.x;
    const float* a = A + b * N * 3;
    const float* c = B + b * N * 3;
    const float* wb = w ? w + b * N : nullptr;
    for (int n = threadIdx.x; n < N; n += kThreads)
      add_moments(a + 3 * n, c + 3 * n, wb ? wb[n] : 1.0f, m);
    block_sum<7>(m, red, mom);
    centroids(mom, eps, cA, cB);
    for (int n = threadIdx.x; n < N; n += kThreads)
      add_h(a + 3 * n, c + 3 * n, wb ? wb[n] : 1.0f, cA, cB, h);
    block_sum<9>(h, red, hs);
    if (threadIdx.x == 0) {
      solve(hs, cA, cB, eps, steps, P);
      store_pose(P, out + b * 16);
    }
  } else {
    const int bi = blockIdx.x * blockDim.x + threadIdx.x;
    if (bi >= bs) return;
    const size_t b = bi;
    const float* a = A + b * N * 3;
    const float* c = B + b * N * 3;
    const float* wb = w ? w + b * N : nullptr;
    for (int n = 0; n < N; ++n)
      add_moments(a + 3 * n, c + 3 * n, wb ? wb[n] : 1.0f, m);
    centroids(m, eps, cA, cB);
    for (int n = 0; n < N; ++n)
      add_h(a + 3 * n, c + 3 * n, wb ? wb[n] : 1.0f, cA, cB, h);
    solve(h, cA, cB, eps, steps, P);
    store_pose(P, out + b * 16);
  }
}

// An IRLS round's weight of a source point s and its target g under the
// pose P (3x4): 1/(1 + (d/th)^2) for an inlier (d < th and valid), else 0.
__device__ __forceinline__ float irls_weight(const float* P, const float* s,
                                             const float* g, bool ok, float th,
                                             bool* inlier) {
  float d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    d[i] = (((s[0] * P[4 * i] + s[1] * P[4 * i + 1]) + s[2] * P[4 * i + 2]) +
            P[4 * i + 3]) - g[i];
  const float dist = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
  *inlier = (dist < th) && ok;
  const float r = dist / th;
  return (1.0f / (1.0f + r * r)) * (*inlier ? 1.0f : 0.0f);
}

// `rounds` IRLS rounds of one pair from pose_in [4, 4] over src, tgt [K, 3]
// and valid [K] -> pose_out [4, 4]; one CTA of kThreads threads.
__global__ void __launch_bounds__(kThreads) irls_kernel(
    const float* __restrict__ pose_in, const float* __restrict__ src,
    const float* __restrict__ tgt, const uint8_t* __restrict__ valid, int K,
    float th, float eps, int steps, int rounds, float* __restrict__ pose_out) {
  __shared__ float pose[16];
  __shared__ float red[kWarps * 9];
  __shared__ float mom[8], hs[9];
  const int tid = threadIdx.x;
  if (tid < 16) pose[tid] = pose_in[tid];
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    float P[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) P[i] = pose[i];
    float m[8] = {};  // the moments, then the inlier count
    bool inl;
    for (int n = tid; n < K; n += kThreads) {
      const float w =
          irls_weight(P, src + 3 * n, tgt + 3 * n, valid[n] != 0, th, &inl);
      add_moments(src + 3 * n, tgt + 3 * n, w, m);
      m[7] = m[7] + (inl ? 1.0f : 0.0f);
    }
    block_sum<8>(m, red, mom);
    float cA[3], cB[3];
    centroids(mom, eps, cA, cB);
    float h[9] = {};
    for (int n = tid; n < K; n += kThreads) {
      const float w =
          irls_weight(P, src + 3 * n, tgt + 3 * n, valid[n] != 0, th, &inl);
      add_h(src + 3 * n, tgt + 3 * n, w, cA, cB, h);
    }
    block_sum<9>(h, red, hs);
    if (tid == 0 && mom[7] >= 3.0f) {
      float Q[12];
      solve(hs, cA, cB, eps, steps, Q);
      store_pose(Q, pose);
    }
    __syncthreads();
  }
  if (tid < 16) pose_out[tid] = pose[tid];
}

}  // namespace

// Weighted Kabsch of bs problems of N points (w null: unweighted) into
// out [bs, 4, 4] on `stream`: one thread a problem up to kThreadMaxN
// points, else one CTA a problem.  Returns a CUDA error code;
// cudaErrorInvalidValue for bs or N below 1 or steps below 0.
extern "C" int kabsch_launch(const float* A, const float* B, const float* w,
                             int bs, int N, float eps, int steps, float* out,
                             void* stream) {
  if (bs < 1 || N < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= kThreadMaxN) {
    kabsch_kernel<false><<<(bs + kSmallThreads - 1) / kSmallThreads,
                           kSmallThreads, 0, st>>>(A, B, w, bs, N, eps, steps,
                                                   out);
  } else {
    kabsch_kernel<true><<<bs, kThreads, 0, st>>>(A, B, w, bs, N, eps, steps,
                                                 out);
  }
  return (int)cudaGetLastError();
}

// `rounds` IRLS rounds of one pair of K correspondences on `stream`, one
// CTA.  Returns a CUDA error code; cudaErrorInvalidValue for K, steps or
// rounds below 0.
extern "C" int irls_launch(const float* pose_in, const float* src,
                           const float* tgt, const uint8_t* valid, int K,
                           float th, float eps, int steps, int rounds,
                           float* pose_out, void* stream) {
  if (K < 0 || steps < 0 || rounds < 0) return (int)cudaErrorInvalidValue;
  irls_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      pose_in, src, tgt, valid, K, th, eps, steps, rounds, pose_out);
  return (int)cudaGetLastError();
}
