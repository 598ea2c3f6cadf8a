// Exact 1-NN of each query over a valid-masked support, batched over clouds.
//
// Replaces buffer_tpu/kernels/geom_pallas.py:nearest_tpu (_nearest_kernel).
// Contract: (d2 [B, Q] f32, idx [B, Q] i32); d2 is the fp32 squared
// coordinate-difference distance ((dx*dx + dy*dy) + dz*dz, no FMA, so the
// plain PyTorch version in kernels/geom_cuda.py gives the same bits);
// invalid support points never win; the lowest index wins a tie; a query
// with no valid support gets (1e9, 0).
//
// Bound: operations.  B*Q*S distance evaluations of 8 flops each against
// B*(Q+S)*12 bytes of input.  Design: one thread per query keeps a running
// (min, argmin) in registers; the block streams the support through shared
// memory in tiles of 1024 points (x, y, z, valid as one float4 read by
// every thread at once, a broadcast), so each support point is read from
// device memory once per 256 queries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr float kBig = 1e9f;

__global__ void __launch_bounds__(kThreads) nearest_kernel(
    const float* __restrict__ query,     // [B, Q, 3]
    const float* __restrict__ support,   // [B, S, 3]
    const uint8_t* __restrict__ valid,   // [B, S]
    int Q, int S,
    float* __restrict__ d_out,           // [B, Q]
    int* __restrict__ i_out) {           // [B, Q]
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const float* qb = query + (size_t)b * Q * 3;
  const float* sb = support + (size_t)b * S * 3;
  const uint8_t* vb = valid + (size_t)b * S;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < Q) {
    qx = qb[3 * qi];
    qy = qb[3 * qi + 1];
    qz = qb[3 * qi + 2];
  }
  float best = kBig;
  int best_i = 0;
  for (int base = 0; base < S; base += kTile) {
    const int n = min(kTile, S - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int g = base + j;
      tile[j] = make_float4(sb[3 * g], sb[3 * g + 1], sb[3 * g + 2],
                            vb[g] ? 1.f : 0.f);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 p = tile[j];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (p.w != 0.f && d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (qi < Q) {
    d_out[(size_t)b * Q + qi] = best;
    i_out[(size_t)b * Q + qi] = best_i;
  }
}

}  // namespace

extern "C" int nearest_launch(const float* query, const float* support,
                              const uint8_t* valid, int B, int Q, int S,
                              float* d_out, int* i_out, void* stream) {
  const dim3 grid((Q + kThreads - 1) / kThreads, B);
  nearest_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      query, support, valid, Q, S, d_out, i_out);
  return (int)cudaGetLastError();
}
