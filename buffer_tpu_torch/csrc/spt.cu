// Fused SPT descriptor front: per keypoint and cylindrical anchor, the
// top-priority in-ball patch point of each of NSEG patch segments, run
// through the BN-folded, azimuth-derotated 3->16 point MLP and ReLU, and
// max-pooled; an empty segment contributes f0.
//
// Replaces buffer_tpu/kernels/geom_pallas.py:spt_pooled_tpu (_spt_kernel).
// Inputs: unrotated patch planes px, py, pz [K, ld] (rows of stride ld, of
// which the first S, the NSEG segments that can win, are read), the
// alignment R [K, 3, 3] (a point is rotated as p @ R), priorities u [S],
// anchor terms ax2 = -2*ax, ay2, az2 and an = |a|^2 [A] in anchor-column
// order (column az*G + g for azimuth az of AZ and ring g of G), the folded
// weights W_all [AZ, 3, 16] (column az*G + g takes row az), bias b and f0
// [16].  Output [K, 16, A].  The
// rotation, the ball test (((pr_x*ax2 + an) + pr_y*ay2) + pr_z*az2 <=
// r2 - |pr|^2) and the MLP (((x*wx + y*wy) + z*wz) + b) run without FMA in
// the same order as the plain version in kernels/geom_cuda.py, so both give
// the same bits.
//
// Bound: operations (K*A*S ball tests of 7 flops; the MLP adds 16*8 flops
// per valid winner).  The inner loop is issue-bound, so the design spends
// as few instructions and shared-memory loads a test as it can.  Plan
// (kernels/geom_cuda.py:spt_plan, checked here): KB keypoints a block, a
// thread per (keypoint, group of kAT anchor columns), dynamic shared memory
// for the staged points and the winners.  Phases, one barrier apart:
//   1. the rank of each patch point within its segment by (priority, then
//      lower index), the order the reference's strict `>` scan keeps;
//   2. each keypoint's points rotated once and staged as one 16-byte
//      vector (x, y, z, r2 - |pr|^2), each segment in ascending rank;
//   3. the scan: a thread tests its kAT anchor columns against every point
//      it loads (one 16-byte shared load feeds kAT tests); in rank order
//      the winner is the last point that passes, so the position itself is
//      the priority and no priority is loaded; each (anchor, segment)
//      winner's position, or -1 for none, goes to shared memory;
//   4. MLP and max: a thread per (keypoint, 8 channels, anchor column),
//      columns fastest so a warp's stores of a channel form one run.
//      Rounding is monotone, so max_s fl(v_s + b) = fl(max_s v_s + b) and
//      max_s relu(.) = relu(max_s .): the bias and ReLU apply once after the
//      max over winners, giving the plain version's bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kAT = 4;          // anchor columns a scan thread
constexpr int kCG = 8;          // channels a thread of the MLP phase
constexpr int kCh = 16;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float dot3(float a, float wa, float b, float wb,
                                      float c, float wc) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb)),
                   __fmul_rn(c, wc));
}

__global__ void __launch_bounds__(kMaxThreads) spt_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz,                 // [K, ld], first S used
    const float* __restrict__ R,                  // [K, 3, 3]
    const float* __restrict__ u,                  // [S]
    const float* __restrict__ ax2, const float* __restrict__ ay2,
    const float* __restrict__ az2, const float* __restrict__ an,  // [A]
    const float* __restrict__ W,                  // [AZ, 3, 16]
    const float* __restrict__ bias, const float* __restrict__ f0,  // [16]
    int K, int S, int ld, int A, int AZ, int NSEG, int KB, float r2,
    float* __restrict__ out) {                    // [K, 16, A]
  extern __shared__ float4 smem[];
  float4* pts = smem;                             // [KB][S]
  int* pos = reinterpret_cast<int*>(pts + KB * S);          // [S]
  short* win = reinterpret_cast<short*>(pos + S);           // [KB][NSEG][A]
  const int LS = S / NSEG;
  const int G = A / AZ;
  const int GS = (A + kAT - 1) / kAT;             // scan threads a keypoint
  const int k0 = blockIdx.x * KB;
  const int nk = min(KB, K - k0);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  // 1. staged position of each point: its segment's start + the number of
  // the segment's points it beats (lower priority, or equal and later)
  for (int p = tid; p < S; p += nth) {
    const int s0 = (p / LS) * LS;
    const float up = u[p];
    int r = 0;
    for (int q = s0; q < s0 + LS; ++q) {
      const float uq = u[q];
      r += (uq < up || (uq == up && q > p)) ? 1 : 0;
    }
    pos[p] = s0 + r;
  }
  __syncthreads();

  // 2. rotate (pr_e = sum_d p_d R[d][e]) and stage
  for (int j = tid; j < nk * S; j += nth) {
    const int kb = j / S;
    const int p = j - kb * S;
    const size_t k = (size_t)(k0 + kb);
    const float* Rk = R + k * 9;
    const float x = px[k * ld + p], y = py[k * ld + p], z = pz[k * ld + p];
    const float rx = dot3(x, Rk[0], y, Rk[3], z, Rk[6]);
    const float ry = dot3(x, Rk[1], y, Rk[4], z, Rk[7]);
    const float rz = dot3(x, Rk[2], y, Rk[5], z, Rk[8]);
    pts[kb * S + pos[p]] =
        make_float4(rx, ry, rz, __fsub_rn(r2, dot3(rx, rx, ry, ry, rz, rz)));
  }
  __syncthreads();

  // 3. scan: thread (kb, s) tests anchor columns a = s, s + GS, ... (< A)
  {
    const int kb = tid / GS;
    const int s = tid - kb * GS;
    if (kb < nk) {
      float cx[kAT], cy[kAT], cz[kAT], cn[kAT];
#pragma unroll
      for (int j = 0; j < kAT; ++j) {
        const int a = min(s + j * GS, A - 1);
        cx[j] = ax2[a];
        cy[j] = ay2[a];
        cz[j] = az2[a];
        cn[j] = an[a];
      }
      for (int seg = 0; seg < NSEG; ++seg) {
        const float4* Q = pts + kb * S + seg * LS;
        int best[kAT];
#pragma unroll
        for (int j = 0; j < kAT; ++j) best[j] = -1;
#pragma unroll 4
        for (int l = 0; l < LS; ++l) {
          const float4 v = Q[l];
#pragma unroll
          for (int j = 0; j < kAT; ++j) {
            float t = __fadd_rn(__fmul_rn(v.x, cx[j]), cn[j]);
            t = __fadd_rn(t, __fmul_rn(v.y, cy[j]));
            t = __fadd_rn(t, __fmul_rn(v.z, cz[j]));
            if (t <= v.w) best[j] = l;
          }
        }
#pragma unroll
        for (int j = 0; j < kAT; ++j) {
          const int a = s + j * GS;
          if (a < A) win[(kb * NSEG + seg) * A + a] = (short)best[j];
        }
      }
    }
  }
  __syncthreads();

  // 4. MLP of each winner and max over the segments: thread (kb, 8
  // channels, column a), columns fastest
  constexpr int NCG = kCh / kCG;
  for (int item = tid; item < nk * NCG * A; item += nth) {
    const int kb = item / (NCG * A);
    const int rem = item - kb * NCG * A;
    const int cg = rem / A;
    const int a = rem - cg * A;
    const int c0 = cg * kCG;
    const int az = a / G;
    float w[3][kCG], acc[kCG];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float4* wr = reinterpret_cast<const float4*>(W + (az * 3 + d) * kCh + c0);
#pragma unroll
      for (int c4 = 0; c4 < kCG / 4; ++c4) {
        const float4 q = __ldg(wr + c4);
        w[d][4 * c4] = q.x;
        w[d][4 * c4 + 1] = q.y;
        w[d][4 * c4 + 2] = q.z;
        w[d][4 * c4 + 3] = q.w;
      }
    }
#pragma unroll
    for (int c = 0; c < kCG; ++c) acc[c] = -INFINITY;
    bool any_valid = false, any_empty = false;
    for (int seg = 0; seg < NSEG; ++seg) {
      const int l = win[(kb * NSEG + seg) * A + a];
      if (l >= 0) {
        const float4 v = pts[kb * S + seg * LS + l];
#pragma unroll
        for (int c = 0; c < kCG; ++c)
          acc[c] = fmaxf(acc[c], dot3(v.x, w[0][c], v.y, w[1][c], v.z, w[2][c]));
        any_valid = true;
      } else {
        any_empty = true;
      }
    }
#pragma unroll
    for (int c = 0; c < kCG; ++c) {
      float r = any_valid ? fmaxf(__fadd_rn(acc[c], bias[c0 + c]), 0.f) : -INFINITY;
      if (any_empty) r = fmaxf(r, f0[c0 + c]);
      out[((size_t)(k0 + kb) * kCh + c0 + c) * A + a] = r;
    }
  }
}

int smem_bytes(int S, int A, int NSEG, int KB) {
  const int b = KB * S * 16 + S * 4 + KB * NSEG * A * 2;
  return (b + 15) / 16 * 16;
}

}  // namespace

// Launches the plan (AT anchor columns a scan thread, KB keypoints a block,
// `threads` threads, `smem` bytes of dynamic shared memory).  Returns a CUDA
// error code; cudaErrorInvalidValue when the plan is not the one this
// source computes for (S, A, NSEG), S does not split into NSEG segments or
// A into AZ azimuths.
extern "C" int spt_launch(const float* px, const float* py, const float* pz,
                          const float* R, const float* u, const float* ax2,
                          const float* ay2, const float* az2, const float* an,
                          const float* W, const float* bias, const float* f0,
                          int K, int S, int ld, int A, int AZ, int NSEG,
                          float r2, int AT, int KB, int threads, int smem,
                          float* out, void* stream) {
  if (K < 1 || S < 1 || ld < S || A < 1 || AZ < 1 || A % AZ != 0 ||
      NSEG <= 0 || S % NSEG != 0 || S / NSEG > 32767 || AT != kAT || KB < 1)
    return (int)cudaErrorInvalidValue;
  const int GS = (A + kAT - 1) / kAT;
  if (threads != (KB * GS + 31) / 32 * 32 || threads > kMaxThreads ||
      smem != smem_bytes(S, A, NSEG, KB))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (K + KB - 1) / KB;
  spt_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      px, py, pz, R, u, ax2, ay2, az2, an, W, bias, f0, K, S, ld, A, AZ, NSEG,
      KB, r2, out);
  return (int)cudaGetLastError();
}
