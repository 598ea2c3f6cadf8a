// Ball sampling: for each query, the two highest-priority in-ball support
// points of each of NS contiguous support segments, as coordinates.
//
// Two entry points share one selection kernel (ball_kernel, templated on the
// output layout):
//   ball_launch        replaces buffer_tpu/kernels/geom_pallas.py:
//                      ball_sample_planes_tpu -- x, y, z planes out (the
//                      inference front);
//   ball_points_launch replaces geom_pallas.py:ball_sample_points_tpu --
//                      stacked [.., 3] points out (the training front,
//                      models/patch_embedder.py:extract_patches).
// Contract, as in the plain versions in kernels/geom_cuda.py: segment s of
// cloud b holds the support points s*L .. s*L + L - 1 (L = N / NS); u is the
// priority where the point is valid, else -1e9.  A point is in the ball
// when (-2qx*x + |s|^2) + -2qy*y + -2qz*z <= r^2 - |q|^2, evaluated in
// exactly that order without FMA, |s|^2 = (x*x + y*y) + z*z.  Its score is
// u, else -1e9.  Per segment the best score wins, the lowest index on a
// tie; the runner-up is the best of the rest.  Slot order is [firsts of
// segments 0..NS-1, seconds of segments 0..NS-1]; a slot is valid when its
// score > -5e8, and invalid slots hold (0, 0, 0).  Planes: x, y, z f32
// [B, Q, 2*NS]; points: f32 [B, Q, 2*NS, 3]; valid bool [B, Q, 2*NS] in
// both.
//
// The outputs are indices made coordinates: copies of input points.  No
// gradient flows through them (the JAX package has no custom_vjp for
// either kernel), so there is no backward kernel; the wrappers raise when
// an input asks for a gradient.
//
// Bound: operations (B*Q*N ball tests of 7 flops).  Design, all in one C
// entry point:
//  * a pack kernel writes the support once a call as [B, G, Lp, NSB]
//    grids: slice g, column c holds segment g*NSB + c, as float4 (x, y, z,
//    |s|^2) and the masked priority u (rows past L, up to the plan's
//    multiple Lp of the chunk, and columns past NS are padding and never
//    win);
//  * the selection kernel: a block takes one slice of NSB segments and QG
//    groups of QT queries (the plan, kernels/geom_cuda.py:ball_plan), one
//    thread per (group, segment), whose queries' test terms and top-2
//    (score, row) stay in registers.  The block streams its slice once
//    through a ring of CH-row chunks in shared memory, each chunk two
//    cp.async.bulk copies completing on one mbarrier; a thread reads one
//    16-byte and one 4-byte shared load a point for its QT queries, and
//    the grids leave L2 once for every QG*QT queries.  QT = 8 at <= 85
//    registers keeps three blocks an SM;
//  * the top-2 is updated only on a hit: both scores start at -1e9, and a
//    point enters only when it is in the ball and u > runner-up (strict, so
//    the lowest row keeps a tie).  An invalid in-ball point has u = -1e9
//    and never enters; a slot whose score stays -1e9 is invalid and writes
//    (0, 0, 0), whichever out-of-ball row the plain version's argmax held.
//    A miss costs the 6 arithmetic operations, two compares and a branch
//    (a version that tested all QT queries first and repeated the tests on
//    a hit read slower on the card);
//  * the epilogue reads each winner's float4 once from the packed grid and
//    writes validity as bytes of 0 or 1 straight into the bool output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e9f;
constexpr int kMaxRing = 8;
constexpr int kMaxThreads = 256;
constexpr int kMaxRows = 1 << 16;  // rows of a segment: a row fits 16 bits

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// grid[b, g, l, c] = (x, y, z, (x*x + y*y) + z*z) and ugrid[b, g, l, c] = u
// of support point s*L + l, s = g*NSB + c; rows l >= L and segments s >= NS
// are padding.
__global__ void __launch_bounds__(256) ball_pack_kernel(
    const float* __restrict__ support, const uint8_t* __restrict__ valid,
    const float* __restrict__ prio, int L, int Lp, int NS, int NSB, int G,
    float4* __restrict__ grid, float* __restrict__ ugrid) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // (g*Lp + l)*NSB + c
  if (e >= G * Lp * NSB) return;
  const int gl = e / NSB, l = gl % Lp;
  const int s = (gl / Lp) * NSB + (e - gl * NSB);
  float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
  float u = -kBig;
  if (l < L && s < NS) {
    const size_t i = (size_t)b * L * NS + (size_t)s * L + l;
    const float x = support[i * 3], y = support[i * 3 + 1],
                z = support[i * 3 + 2];
    p = make_float4(x, y, z, __fadd_rn(__fadd_rn(__fmul_rn(x, x),
                                                 __fmul_rn(y, y)),
                                       __fmul_rn(z, z)));
    u = valid[i] ? prio[i] : -kBig;
  }
  grid[(size_t)b * G * Lp * NSB + e] = p;
  ugrid[(size_t)b * G * Lp * NSB + e] = u;
}

// kPoints: write one [.., 3] array through o0 (o1, o2 unused); else the
// x, y, z planes through o0, o1, o2.
// QT = 8 keeps three blocks of 256 threads an SM (<= 85 registers), QT = 4
// four (<= 64).
template <int QT, bool kPoints>
__global__ void __launch_bounds__(kMaxThreads, QT == 4 ? 4 : 3) ball_kernel(
    const float* __restrict__ query,   // [B, Q, 3]
    const float4* __restrict__ grid,   // [B, G, Lp, NSB]
    const float* __restrict__ ugrid,   // [B, G, Lp, NSB]
    int Q, int L, int Lp, int NS, int NSB, float r2, int CH, int ring,
    float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2,
    uint8_t* __restrict__ ovalid) {    // [B, Q, 2*NS]
  // ring slot c: CH*NSB float4 then CH*NSB floats; then the mbarriers
  extern __shared__ __align__(128) unsigned char smem[];
  const int slot_bytes = CH * NSB * 20;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + ring * slot_bytes);
  const int b = blockIdx.z;
  const int c_ = threadIdx.x % NSB;          // column in the slice
  const int s = blockIdx.y * NSB + c_;       // segment
  const int q0 = (blockIdx.x * (blockDim.x / NSB) + threadIdx.x / NSB) * QT;
  const int n_chunks = Lp / CH;
  const size_t slice = ((size_t)b * gridDim.y + blockIdx.y) * Lp * NSB;
  const char* gsrc = reinterpret_cast<const char*>(grid + slice);
  const char* usrc = reinterpret_cast<const char*>(ugrid + slice);
  const unsigned pbytes = (unsigned)(CH * NSB * 16),
                 ubytes = (unsigned)(CH * NSB * 4);

  if (threadIdx.x == 0) {
    for (int c = 0; c < ring; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&full[c])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // chunk c (rows c*CH ..) into ring slot c % ring, completing full[c % ring]
  auto issue = [&](int c) {
    const unsigned bar = smem_u32(&full[c % ring]);
    unsigned char* dst = smem + (c % ring) * slot_bytes;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(pbytes + ubytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(gsrc + (size_t)c * pbytes), "r"(pbytes),
           "r"(bar) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst + pbytes)), "l"(usrc + (size_t)c * ubytes),
           "r"(ubytes), "r"(bar) : "memory");
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < min(ring, n_chunks); ++c) issue(c);

  // ls = winner's row | runner-up's row << 16
  float qx2[QT], qy2[QT], qz2[QT], rhs[QT], v1[QT], v2[QT];
  unsigned ls[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int q = min(q0 + j, Q - 1);
    const float* qp = query + ((size_t)b * Q + q) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    qx2[j] = -2.f * qx;
    qy2[j] = -2.f * qy;
    qz2[j] = -2.f * qz;
    rhs[j] = __fsub_rn(r2, __fadd_rn(__fadd_rn(__fmul_rn(qx, qx),
                                               __fmul_rn(qy, qy)),
                                     __fmul_rn(qz, qz)));
    v1[j] = v2[j] = -kBig;
    ls[j] = 0;
  }
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile(
        "{\n .reg .pred done;\n WAIT:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        " @!done bra WAIT;\n }\n"
        :: "r"(smem_u32(&full[c % ring])), "r"((unsigned)(c / ring) & 1u)
        : "memory");
    const float4* pts =
        reinterpret_cast<const float4*>(smem + (c % ring) * slot_bytes);
    const float* us = reinterpret_cast<const float*>(
        smem + (c % ring) * slot_bytes + pbytes);
    const int rows = min(CH, L - c * CH);
    if (s < NS) {
      for (int rr = 0; rr < rows; ++rr) {
        const float4 p = pts[rr * NSB + c_];
        const float u = us[rr * NSB + c_];
        const unsigned l = (unsigned)(c * CH + rr);
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          float t = __fadd_rn(__fmul_rn(qx2[j], p.x), p.w);
          t = __fadd_rn(t, __fmul_rn(qy2[j], p.y));
          t = __fadd_rn(t, __fmul_rn(qz2[j], p.z));
          if (t <= rhs[j] && u > v2[j]) {
            if (u > v1[j]) {
              v2[j] = v1[j];
              v1[j] = u;
              ls[j] = (ls[j] << 16) | l;
            } else {
              v2[j] = u;
              ls[j] = (ls[j] & 0xFFFFu) | (l << 16);
            }
          }
        }
      }
    }
    __syncthreads();  // slot c % ring is read by every thread
    if (threadIdx.x == 0 && c + ring < n_chunks) issue(c + ring);
  }
  if (s >= NS) return;
  const float4* gb = grid + slice + c_;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const int q = q0 + j;
    if (q >= Q) break;
    const size_t row = ((size_t)b * Q + q) * (2 * NS);
    const float vs[2] = {v1[j], v2[j]};
    const unsigned rows[2] = {ls[j] & 0xFFFFu, ls[j] >> 16};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = vs[r] > -kBig / 2;
      const float4 p =
          ok ? gb[(size_t)rows[r] * NSB] : make_float4(0.f, 0.f, 0.f, 0.f);
      const size_t slot = row + r * NS + s;
      if (kPoints) {
        o0[slot * 3] = p.x;
        o0[slot * 3 + 1] = p.y;
        o0[slot * 3 + 2] = p.z;
      } else {
        o0[slot] = p.x;
        o1[slot] = p.y;
        o2[slot] = p.z;
      }
      ovalid[slot] = ok;
    }
  }
}

// Dynamic shared memory of the selection kernel (kernels/geom_cuda.py:
// ball_smem_bytes): `ring` chunks of CH rows of a slice of both grids, one
// mbarrier each.
int smem_bytes(int NSB, int CH, int ring) {
  return ring * (CH * NSB * 20 + 8);
}

template <int QT, bool kPoints>
cudaError_t select_kernel(dim3 blocks, int threads, int smem, cudaStream_t st,
                          const float* query, const void* grid,
                          const float* ugrid, int Q, int L, int Lp, int NS,
                          int NSB, float r2, int CH, int ring, float* o0,
                          float* o1, float* o2, uint8_t* ovalid) {
  const cudaError_t err = cudaFuncSetAttribute(
      ball_kernel<QT, kPoints>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ball_kernel<QT, kPoints><<<blocks, threads, smem, st>>>(
      query, (const float4*)grid, ugrid, Q, L, Lp, NS, NSB, r2, CH, ring, o0,
      o1, o2, ovalid);
  return cudaGetLastError();
}

template <bool kPoints>
int launch(const float* query, const float* support, const uint8_t* valid,
           const float* prio, int B, int Q, int L, int NS, float r2, int QT,
           int QG, int NSB, int CH, int ring, int smem, void* grid,
           float* ugrid, float* o0, float* o1, float* o2, uint8_t* ovalid,
           void* stream) {
  // NSB segments a slice in whole warps, no slice empty; QG groups of QT
  // queries; QG * NSB threads
  const int Lp = (L + CH - 1) / CH * CH;
  const int G = NSB > 0 ? (NS + NSB - 1) / NSB : 0;
  const int threads = QG * NSB;
  if (B < 1 || Q < 1 || L < 1 || L > kMaxRows || NS < 1 || NSB < 32 ||
      NSB % 32 || NSB > (NS + 31) / 32 * 32 || QG < 1 ||
      threads > kMaxThreads || CH < 4 || CH % 4 || ring < 2 ||
      ring > kMaxRing || smem != smem_bytes(NSB, CH, ring) ||
      reinterpret_cast<uintptr_t>(grid) % 16 ||
      reinterpret_cast<uintptr_t>(ugrid) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  ball_pack_kernel<<<dim3((G * Lp * NSB + 255) / 256, B), 256, 0, st>>>(
      support, valid, prio, L, Lp, NS, NSB, G, (float4*)grid, ugrid);
  const dim3 blocks((Q + QG * QT - 1) / (QG * QT), G, B);
  switch (QT) {
    case 4:
      return (int)select_kernel<4, kPoints>(
          blocks, threads, smem, st, query, grid, ugrid, Q, L, Lp, NS, NSB,
          r2, CH, ring, o0, o1, o2, ovalid);
    case 8:
      return (int)select_kernel<8, kPoints>(
          blocks, threads, smem, st, query, grid, ugrid, Q, L, Lp, NS, NSB,
          r2, CH, ring, o0, o1, o2, ovalid);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points pack the support into `grid` ([B, G, Lp, NSB] float4)
// and `ugrid` ([B, G, Lp, NSB] f32), scratch of Lp = L rounded up to CH and
// G = ceil(NS / NSB) slices of NSB segments, then select, on `stream`.  The
// plan (QT queries a thread, QG groups, NSB segments a block, CH rows a
// chunk, ring chunks, shared bytes) comes from kernels/geom_cuda.py:
// ball_plan.
// Returns a CUDA error code; cudaErrorInvalidValue for a plan the kernel
// does not take.
extern "C" int ball_launch(const float* query, const float* support,
                           const uint8_t* valid, const float* prio, int B,
                           int Q, int L, int NS, float r2, int QT, int QG,
                           int NSB, int CH, int ring, int smem, void* grid,
                           float* ugrid, float* ox, float* oy, float* oz,
                           uint8_t* ovalid, void* stream) {
  return launch<false>(query, support, valid, prio, B, Q, L, NS, r2, QT, QG,
                       NSB, CH, ring, smem, grid, ugrid, ox, oy, oz, ovalid,
                       stream);
}

extern "C" int ball_points_launch(const float* query, const float* support,
                                  const uint8_t* valid, const float* prio,
                                  int B, int Q, int L, int NS, float r2,
                                  int QT, int QG, int NSB, int CH, int ring,
                                  int smem, void* grid, float* ugrid,
                                  float* opts, uint8_t* ovalid, void* stream) {
  return launch<true>(query, support, valid, prio, B, Q, L, NS, r2, QT, QG,
                      NSB, CH, ring, smem, grid, ugrid, opts, nullptr,
                      nullptr, ovalid, stream);
}
