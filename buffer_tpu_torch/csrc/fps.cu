// Farthest point sampling over B clouds, one block per cloud.
//
// Replaces buffer_tpu/kernels/fps_pallas.py:fps_pallas_batched
// (_fps_kernel_batched).  Contract: idx [B, S] i32.  The chain starts at the
// first eligible point (index 0 when none is); the running min-distance of
// eligible points starts at 1e10 and of ineligible points is pinned at -1,
// so they never win while an eligible point remains; each step takes the
// argmax, lowest index on a tie.  Distances are ((dx*dx + dy*dy) + dz*dz)
// without FMA: FPS is chaotic, one differently rounded distance changes
// every later index, so the plain version repeats this arithmetic exactly.
//
// Bound: latency of the S-step serial chain (each step a full argmax over
// the cloud).  Design: 1024 threads per cloud; thread t owns points
// t, t+1024, ... and keeps their min-distances in registers (PPT of them;
// an eligible point's min-distance is always >= 0, so its sign carries the
// eligibility mask).  The coordinates are re-read each step from device
// memory (planar x/y/z, coalesced; 12 bytes a point stay resident in L2).
// A step ends in a block argmax through warp shuffles and shared memory.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide argmax (highest value, lowest index); every thread gets it.
__device__ __forceinline__ int block_argmax(float v, int i, float* sv, int* si,
                                           int* result) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    take_better(v, i, ov, oi);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = sv[lane];
    i = si[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, off);
      const int oi = __shfl_xor_sync(kFull, i, off);
      take_better(v, i, ov, oi);
    }
    if (lane == 0) *result = i;
  }
  __syncthreads();
  return *result;
}

template <int PPT>
__global__ void __launch_bounds__(kThreads) fps_kernel(
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ zs,          // [B, N] each
    const uint8_t* __restrict__ eligible,  // [B, N]
    int N, int S, int* __restrict__ out) { // [B, S]
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ int result;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* x = xs + (size_t)b * N;
  const float* y = ys + (size_t)b * N;
  const float* z = zs + (size_t)b * N;
  const uint8_t* e = eligible + (size_t)b * N;
  int* o = out + (size_t)b * S;

  float mind[PPT];
  float bv = -INFINITY;
  int bi = INT_MAX;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = t + p * kThreads;
    mind[p] = -1.f;
    if (i < N) {
      const bool el = e[i] != 0;
      mind[p] = el ? 1e10f : -1.f;
      take_better(bv, bi, el ? 1.f : 0.f, i);
    }
  }
  int cur = block_argmax(bv, bi, sv, si, &result);
  if (t == 0) o[0] = cur;

  for (int m = 1; m < S; ++m) {
    const float cx = x[cur], cy = y[cur], cz = z[cur];
    bv = -INFINITY;
    bi = INT_MAX;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int i = t + p * kThreads;
      if (i < N) {
        const float dx = __fsub_rn(x[i], cx);
        const float dy = __fsub_rn(y[i], cy);
        const float dz = __fsub_rn(z[i], cz);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (mind[p] >= 0.f) mind[p] = fminf(mind[p], d);
        take_better(bv, bi, mind[p], i);
      }
    }
    cur = block_argmax(bv, bi, sv, si, &result);
    if (t == 0) o[m] = cur;
  }
}

template <int PPT>
int launch(const float* x, const float* y, const float* z, const uint8_t* e,
           int B, int N, int S, int* out, cudaStream_t stream) {
  fps_kernel<PPT><<<B, kThreads, 0, stream>>>(x, y, z, e, N, S, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code; cudaErrorInvalidValue when N exceeds the
// largest instantiated points-per-thread (64 * 1024 points).
extern "C" int fps_launch(const float* x, const float* y, const float* z,
                          const uint8_t* eligible, int B, int N, int S,
                          int* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int ppt = (N + kThreads - 1) / kThreads;
  if (ppt <= 1) return launch<1>(x, y, z, eligible, B, N, S, out, st);
  if (ppt <= 2) return launch<2>(x, y, z, eligible, B, N, S, out, st);
  if (ppt <= 4) return launch<4>(x, y, z, eligible, B, N, S, out, st);
  if (ppt <= 8) return launch<8>(x, y, z, eligible, B, N, S, out, st);
  if (ppt <= 16) return launch<16>(x, y, z, eligible, B, N, S, out, st);
  if (ppt <= 32) return launch<32>(x, y, z, eligible, B, N, S, out, st);
  if (ppt <= 64) return launch<64>(x, y, z, eligible, B, N, S, out, st);
  return (int)cudaErrorInvalidValue;
}
