// Ball sampling: for each query, the two highest-priority in-ball support
// points of each of NS contiguous support segments, as coordinates.
//
// Two entry points share one selection loop (ball_kernel, templated on the
// output layout):
//   ball_launch        replaces buffer_tpu/kernels/geom_pallas.py:
//                      ball_sample_planes_tpu -- x, y, z planes out (the
//                      inference front);
//   ball_points_launch replaces geom_pallas.py:ball_sample_points_tpu --
//                      stacked [.., 3] points out (the training front,
//                      models/patch_embedder.py:extract_patches).
// The support of cloud b arrives as [L, NS] grids (column s holds segment
// s, original index s*L + l) of x, y, z, |s|^2 and the priority u (-1e9
// where the point is invalid).  A point is in the ball when
// (-2qx*x + |s|^2) + -2qy*y + -2qz*z <= r^2 - |q|^2, evaluated in exactly
// that order without FMA (the plain versions in kernels/geom_cuda.py give
// the same bits).  Its score is u, else -1e9.  Per segment the best score
// wins, the lowest index on a tie; the runner-up is the best of the rest.
// Slot order is [firsts of segments 0..NS-1, seconds of segments 0..NS-1];
// a slot is valid when its score > -5e8, and invalid slots hold (0, 0, 0).
// Planes: x, y, z f32 [B, Q, 2*NS]; points: f32 [B, Q, 2*NS, 3]; valid u8
// [B, Q, 2*NS] in both.
//
// The outputs are indices made coordinates: copies of input points.  No
// gradient flows through them (the JAX package has no custom_vjp for
// either kernel), so there is no backward kernel; the wrappers raise when
// an input asks for a gradient.
//
// Bound: operations (B*Q*N ball tests of 7 flops against ~17 bytes a
// support point).  Design: one block of NS threads per tile of kQT queries,
// one thread per segment; each support point is read once per tile (rows
// of the grids are coalesced across threads) and tested against the kQT
// queries, whose top-2 (score, row) pairs stay in registers.  At 512
// queries a cloud the grid has 64 blocks a cloud, so a two-cloud launch
// fills 128 of the H100's 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kQT = 8;
constexpr float kBig = 1e9f;

// kPoints: write one [.., 3] array through o0 (o1, o2 unused); else the
// x, y, z planes through o0, o1, o2.
template <bool kPoints>
__global__ void ball_kernel(
    const float* __restrict__ query,   // [B, Q, 3]
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gz, const float* __restrict__ gn,
    const float* __restrict__ gu,      // [B, L, NS] each
    int Q, int L, int NS, float r2,
    float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2,
    uint8_t* __restrict__ ovalid) {    // [B, Q, 2*NS]
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
  if (s >= NS) return;
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
    const float vs[2] = {v1[j], v2[j]};
    const int ls[2] = {l1[j], l2[j]};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = vs[r] > -kBig / 2;
      const size_t g = grid_off + (size_t)ls[r] * NS + s;
      const size_t slot = row + r * NS + s;
      const float x = ok ? gx[g] : 0.f;
      const float y = ok ? gy[g] : 0.f;
      const float z = ok ? gz[g] : 0.f;
      if (kPoints) {
        o0[slot * 3] = x;
        o0[slot * 3 + 1] = y;
        o0[slot * 3 + 2] = z;
      } else {
        o0[slot] = x;
        o1[slot] = y;
        o2[slot] = z;
      }
      ovalid[slot] = ok;
    }
  }
}

template <bool kPoints>
int launch(const float* query, const float* gx, const float* gy,
           const float* gz, const float* gn, const float* gu, int B, int Q,
           int L, int NS, float r2, float* o0, float* o1, float* o2,
           uint8_t* ovalid, void* stream) {
  const int threads = ((NS + 31) / 32) * 32;
  const dim3 grid((Q + kQT - 1) / kQT, B);
  ball_kernel<kPoints><<<grid, threads, 0, (cudaStream_t)stream>>>(
      query, gx, gy, gz, gn, gu, Q, L, NS, r2, o0, o1, o2, ovalid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ball_launch(const float* query, const float* gx,
                           const float* gy, const float* gz, const float* gn,
                           const float* gu, int B, int Q, int L, int NS,
                           float r2, float* ox, float* oy, float* oz,
                           uint8_t* ovalid, void* stream) {
  return launch<false>(query, gx, gy, gz, gn, gu, B, Q, L, NS, r2, ox, oy,
                       oz, ovalid, stream);
}

extern "C" int ball_points_launch(const float* query, const float* gx,
                                  const float* gy, const float* gz,
                                  const float* gn, const float* gu, int B,
                                  int Q, int L, int NS, float r2, float* opts,
                                  uint8_t* ovalid, void* stream) {
  return launch<true>(query, gx, gy, gz, gn, gu, B, Q, L, NS, r2, opts,
                      nullptr, nullptr, ovalid, stream);
}
