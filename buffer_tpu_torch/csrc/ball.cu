// Ball sampling: for each query, the two highest-priority in-ball support
// points of each of NS contiguous support segments, as coordinates.
//
// Replaces buffer_tpu/kernels/geom_pallas.py:ball_sample_planes_tpu
// (_ball_kernel).  The support of cloud b arrives as [L, NS] grids (column s
// holds segment s, original index s*L + l) of x, y, z, |s|^2 and the
// priority u (-1e9 where the point is invalid).  A point is in the ball when
// (-2qx*x + |s|^2) + -2qy*y + -2qz*z <= r^2 - |q|^2, evaluated in exactly
// that order without FMA (the plain version in kernels/geom_cuda.py gives
// the same bits).  Its score is u, else -1e9.  Per segment the best score
// wins, the lowest index on a tie; the runner-up is the best of the rest.
// Outputs x, y, z f32 [B, Q, 2*NS] and valid u8 [B, Q, 2*NS] in slot order
// [firsts of segments 0..NS-1, seconds of segments 0..NS-1]; a slot is valid
// when its score > -5e8, and invalid slots hold (0, 0, 0).
//
// Bound: operations (B*Q*N ball tests of 7 flops against ~20 bytes a
// support point).  Design: one block of NS threads per tile of kQT queries,
// one thread per segment; each support point is read once per tile (rows
// of the grids are coalesced across threads) and tested against the kQT
// queries, whose top-2 (score, row) pairs stay in registers.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kQT = 8;
constexpr float kBig = 1e9f;

__global__ void ball_kernel(
    const float* __restrict__ query,   // [B, Q, 3]
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gz, const float* __restrict__ gn,
    const float* __restrict__ gu,      // [B, L, NS] each
    int Q, int L, int NS, float r2,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz,
    uint8_t* __restrict__ ovalid) {    // [B, Q, 2*NS] each
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQT;
  const int s = threadIdx.x;
  const size_t grid_off = (size_t)b * L * NS;

  float qx2[kQT], qy2[kQT], qz2[kQT], rhs[kQT];
  float v1[kQT], v2[kQT];
  int l1[kQT], l2[kQT];
#pragma unroll
  for (int j = 0; j < kQT; ++j) {
    const int q = min(q0 + j, Q - 1);
    const float* qp = query + ((size_t)b * Q + q) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    qx2[j] = -2.f * qx;
    qy2[j] = -2.f * qy;
    qz2[j] = -2.f * qz;
    rhs[j] = __fsub_rn(r2, __fadd_rn(__fadd_rn(__fmul_rn(qx, qx),
                                               __fmul_rn(qy, qy)),
                                     __fmul_rn(qz, qz)));
    v1[j] = -INFINITY;
    v2[j] = -INFINITY;
    l1[j] = 0;
    l2[j] = 0;
  }
  if (s < NS) {
    for (int l = 0; l < L; ++l) {
      const size_t g = grid_off + (size_t)l * NS + s;
      const float x = gx[g], y = gy[g], z = gz[g], n = gn[g], u = gu[g];
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        float t = __fadd_rn(__fmul_rn(qx2[j], x), n);
        t = __fadd_rn(t, __fmul_rn(qy2[j], y));
        t = __fadd_rn(t, __fmul_rn(qz2[j], z));
        const float sc = (t <= rhs[j]) ? u : -kBig;
        if (sc > v1[j]) {
          v2[j] = v1[j];
          l2[j] = l1[j];
          v1[j] = sc;
          l1[j] = l;
        } else if (sc > v2[j]) {
          v2[j] = sc;
          l2[j] = l;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      const int q = q0 + j;
      if (q >= Q) break;
      const size_t row = ((size_t)b * Q + q) * (2 * NS);
      const bool ok1 = v1[j] > -kBig / 2;
      const bool ok2 = v2[j] > -kBig / 2;
      const size_t g1 = grid_off + (size_t)l1[j] * NS + s;
      const size_t g2 = grid_off + (size_t)l2[j] * NS + s;
      ox[row + s] = ok1 ? gx[g1] : 0.f;
      oy[row + s] = ok1 ? gy[g1] : 0.f;
      oz[row + s] = ok1 ? gz[g1] : 0.f;
      ovalid[row + s] = ok1;
      ox[row + NS + s] = ok2 ? gx[g2] : 0.f;
      oy[row + NS + s] = ok2 ? gy[g2] : 0.f;
      oz[row + NS + s] = ok2 ? gz[g2] : 0.f;
      ovalid[row + NS + s] = ok2;
    }
  }
}

}  // namespace

extern "C" int ball_launch(const float* query, const float* gx,
                           const float* gy, const float* gz, const float* gn,
                           const float* gu, int B, int Q, int L, int NS,
                           float r2, float* ox, float* oy, float* oz,
                           uint8_t* ovalid, void* stream) {
  const int threads = ((NS + 31) / 32) * 32;
  const dim3 grid((Q + kQT - 1) / kQT, B);
  ball_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      query, gx, gy, gz, gn, gu, Q, L, NS, r2, ox, oy, oz, ovalid);
  return (int)cudaGetLastError();
}
