// Fused SPT descriptor front: per keypoint and cylindrical anchor, the
// top-priority in-ball patch point of each of NSEG patch segments, run
// through the BN-folded, azimuth-derotated 3->16 point MLP and ReLU, and
// max-pooled; an empty segment contributes f0.
//
// Replaces buffer_tpu/kernels/geom_pallas.py:spt_pooled_tpu (_spt_kernel).
// Inputs: unrotated patch planes px, py, pz [K, S] (S already trimmed to
// the NSEG segments that can win), the alignment R [K, 3, 3] (a point is
// rotated as p @ R), priorities u [S], anchor terms ax2 = -2*ax, ay2, az2
// and an = |a|^2 [A] in anchor-column order (column a*G + g), folded
// weights wx, wy, wz [16, A] (the column's azimuth row of W_all), bias b
// and f0 [16].  Output [K, 16, A].  The rotation, the ball test
// (((pr_x*ax2 + an) + pr_y*ay2) + pr_z*az2 <= r2 - |pr|^2) and the MLP
// (((x*wx + y*wy) + z*wz) + b) run without FMA in the same order as the
// plain version in kernels/geom_cuda.py, so both give the same bits.
//
// Bound: operations (K*A*S ball tests of 7 flops; the MLP adds 16*8 flops
// per valid winner).  Design: one block per keypoint; the block rotates the
// S patch points once into shared memory (with |pr|^2 folded into the
// threshold); one thread per anchor column scans the segments from shared
// memory (a broadcast read) keeping the running top-1 per segment, then
// applies the MLP to each winner with its 48 weights in registers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxS = 1024;
constexpr int kCh = 16;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float dot3(float a, float wa, float b, float wb,
                                      float c, float wc) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb)),
                   __fmul_rn(c, wc));
}

__global__ void spt_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz,                 // [K, S]
    const float* __restrict__ R,                  // [K, 3, 3]
    const float* __restrict__ u,                  // [S]
    const float* __restrict__ ax2, const float* __restrict__ ay2,
    const float* __restrict__ az2, const float* __restrict__ an,  // [A]
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ wz,                 // [16, A]
    const float* __restrict__ bias, const float* __restrict__ f0,  // [16]
    int S, int A, int NSEG, float r2,
    float* __restrict__ out) {                    // [K, 16, A]
  __shared__ float sx[kMaxS], sy[kMaxS], sz[kMaxS], srhs[kMaxS], su[kMaxS];
  const int k = blockIdx.x;
  const float* Rk = R + (size_t)k * 9;
  const float r00 = Rk[0], r01 = Rk[1], r02 = Rk[2];
  const float r10 = Rk[3], r11 = Rk[4], r12 = Rk[5];
  const float r20 = Rk[6], r21 = Rk[7], r22 = Rk[8];
  for (int p = threadIdx.x; p < S; p += blockDim.x) {
    const float x = px[(size_t)k * S + p];
    const float y = py[(size_t)k * S + p];
    const float z = pz[(size_t)k * S + p];
    // pr_e = sum_d p_d R[d][e]
    const float rx = dot3(x, r00, y, r10, z, r20);
    const float ry = dot3(x, r01, y, r11, z, r21);
    const float rz = dot3(x, r02, y, r12, z, r22);
    sx[p] = rx;
    sy[p] = ry;
    sz[p] = rz;
    srhs[p] = __fsub_rn(r2, dot3(rx, rx, ry, ry, rz, rz));
    su[p] = u[p];
  }
  __syncthreads();

  const int c = threadIdx.x;
  if (c >= A) return;
  const float cx2 = ax2[c], cy2 = ay2[c], cz2 = az2[c], cn = an[c];
  float w0[kCh], w1[kCh], w2[kCh], acc[kCh];
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch) {
    w0[ch] = wx[ch * A + c];
    w1[ch] = wy[ch * A + c];
    w2[ch] = wz[ch * A + c];
    acc[ch] = -INFINITY;
  }
  const int LS = S / NSEG;
  for (int seg = 0; seg < NSEG; ++seg) {
    float best = -INFINITY;
    int best_p = seg * LS;
    for (int l = 0; l < LS; ++l) {
      const int p = seg * LS + l;
      float t = __fadd_rn(__fmul_rn(sx[p], cx2), cn);
      t = __fadd_rn(t, __fmul_rn(sy[p], cy2));
      t = __fadd_rn(t, __fmul_rn(sz[p], cz2));
      const float sc = (t <= srhs[p]) ? su[p] : -kBig;
      if (sc > best) {
        best = sc;
        best_p = p;
      }
    }
    if (best > -kBig / 2) {
      const float x = sx[best_p], y = sy[best_p], z = sz[best_p];
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) {
        const float f = fmaxf(
            __fadd_rn(dot3(x, w0[ch], y, w1[ch], z, w2[ch]), bias[ch]), 0.f);
        acc[ch] = fmaxf(acc[ch], f);
      }
    } else {
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) acc[ch] = fmaxf(acc[ch], f0[ch]);
    }
  }
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch) out[((size_t)k * kCh + ch) * A + c] = acc[ch];
}

}  // namespace

// Returns a CUDA error code; cudaErrorInvalidValue when S exceeds the
// shared-memory staging (1024 points) or does not split into NSEG segments.
extern "C" int spt_launch(const float* px, const float* py, const float* pz,
                          const float* R, const float* u, const float* ax2,
                          const float* ay2, const float* az2, const float* an,
                          const float* wx, const float* wy, const float* wz,
                          const float* bias, const float* f0, int K, int S,
                          int A, int NSEG, float r2, float* out, void* stream) {
  if (S > kMaxS || NSEG <= 0 || S % NSEG != 0 || A > 1024)
    return (int)cudaErrorInvalidValue;
  const int threads = ((A + 31) / 32) * 32;
  spt_kernel<<<K, threads, 0, (cudaStream_t)stream>>>(
      px, py, pz, R, u, ax2, ay2, az2, an, wx, wy, wz, bias, f0, S, A, NSEG,
      r2, out);
  return (int)cudaGetLastError();
}
