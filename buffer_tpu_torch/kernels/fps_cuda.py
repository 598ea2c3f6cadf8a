"""Farthest point sampling (counterparts of
``buffer_tpu/kernels/fps_pallas.py`` ``fps_pallas_batched`` and the
single-cloud ``fps_pallas``; both launch ``csrc/fps.cu``, the single cloud
at B = 1, and count their launches apart).

Each wrapper takes the plain PyTorch version for CPU tensors only; a CUDA
tensor goes to ``csrc/fps.cu`` or raises.  Both compute each step's distances as
((dx*dx + dy*dy) + dz*dz) with separately rounded operations: FPS is
chaotic, so the indices agree only when the rounding does.

The kernel splits each cloud over one thread-block cluster;
:func:`fps_plan` chooses the split and the launcher checks it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels.cuda import I, P

FPS = cuda.register(cuda.Kernel(
    "fps", "buffer_tpu_torch/csrc/fps.cu", "fps_launch",
    [P, P, I, I, I, I, I, I, P, P],
    "buffer_tpu/kernels/fps_pallas.py:155"))
FPS_SINGLE = cuda.register(cuda.Kernel(
    "fps_single", "buffer_tpu_torch/csrc/fps.cu", "fps_launch",
    [P, P, I, I, I, I, I, I, P, P],
    "buffer_tpu/kernels/fps_pallas.py:67"))

# CTAs a cluster: 8 is the portable size; Hopper also schedules 16, which
# csrc/fps.cu opts in to (fps_max_active_clusters reports the card's count)
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8
MIN_CTA_POINTS = 512     # a cloud is split no finer than this a CTA
TARGET_THREADS = 256     # a CTA's threads: few warps to reduce a step
POINTS_A_THREAD = (1, 2, 4, 8, 16)   # csrc/fps.cu's instantiations
# csrc/fps.cu's max_threads<16>(): the threads a CTA that the register
# budget allows at 16 points a thread, which bounds the cloud
MAX_THREADS_16 = 512
MAX_POINTS = MAX_CLUSTER * MAX_THREADS_16 * 16


def fps_plan(N: int) -> Tuple[int, int, int]:
    """(cluster CTAs C, threads a CTA T, points a thread P) for a cloud of
    N points: as many CTAs as the cloud fills with MIN_CTA_POINTS each, up
    to MAX_CLUSTER; the fewest points a thread that keep a CTA within
    TARGET_THREADS threads (a step's latency grows with a CTA's warps more
    than with its points), or past 65536 points 16 a thread and up to
    MAX_THREADS_16 threads; then only as many CTAs as those cover.  CTA r
    owns points [r*T*P, (r+1)*T*P) and its thread t the P points from
    (r*T + t)*P on, see :func:`fps_points`; no CTA is empty.  Raises for N
    outside 1..MAX_POINTS."""
    if not 1 <= N <= MAX_POINTS:
        raise ValueError(f"fps: N={N} must be in 1..{MAX_POINTS}")
    per_cta = -(-N // min(MAX_CLUSTER, -(-N // MIN_CTA_POINTS)))
    P = next((p for p in POINTS_A_THREAD
              if -(-per_cta // p) <= TARGET_THREADS), POINTS_A_THREAD[-1])
    T = 32 * -(-per_cta // (32 * P))
    return -(-N // (T * P)), T, P


def fps_points(plan: Tuple[int, int, int]) -> torch.Tensor:
    """The point index of every (CTA r, thread t, slot p) of ``plan``:
    (r*T + t)*P + p, [C, T, P] int64 (indices >= N are empty slots).
    Indices ascend with the lane, warp and rank, so at each level of the
    kernel's argmax the lowest holder of the highest key holds the lowest
    index."""
    C, T, P = plan
    r = torch.arange(C)[:, None, None]
    t = torch.arange(T)[None, :, None]
    p = torch.arange(P)[None, None, :]
    return (r * T + t) * P + p


def fps_plain(points: torch.Tensor, eligible: torch.Tensor,
              num_samples: int) -> torch.Tensor:
    """points [B, N, 3], eligible [B, N] bool -> idx [B, num_samples] int32.

    Starts at the first eligible point; ineligible points sit at -1 and
    never win while an eligible point remains; ties go to the lowest
    index."""
    B, N, _ = points.shape
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    mind = torch.where(eligible, torch.full_like(x, 1e10),
                       torch.full_like(x, -1.0))
    neg = torch.full_like(x, -1.0)
    cur = torch.argmax(eligible.to(torch.float32), dim=1)          # [B]
    out = torch.empty((B, num_samples), dtype=torch.int64, device=points.device)
    out[:, 0] = cur
    for m in range(1, num_samples):
        c = torch.gather(points, 1, cur[:, None, None].expand(B, 1, 3))[:, 0]
        dx = x - c[:, 0:1]
        dy = y - c[:, 1:2]
        dz = z - c[:, 2:3]
        d = dx * dx + dy * dy + dz * dz
        mind = torch.minimum(mind, torch.where(eligible, d, neg))
        cur = torch.argmax(mind, dim=1)
        out[:, m] = cur
    return out.to(torch.int32)


def fps_max_active_clusters(plan: Tuple[int, int, int]) -> int:
    """How many clusters of ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: it cannot schedule one)."""
    fn = FPS.lib.load().fps_max_active_clusters
    fn.restype, fn.argtypes = I, [I, I, I]
    n = fn(*plan)
    if n < 0:
        raise RuntimeError(f"fps: occupancy query failed: cudaError {-n}")
    return n


def _fps_launch(kernel: cuda.Kernel, points: torch.Tensor,
                eligible: torch.Tensor, num_samples: int) -> torch.Tensor:
    B, N, _ = points.shape
    if num_samples < 1:
        raise ValueError(f"fps: num_samples={num_samples} must be >= 1")
    C, T, P = fps_plan(N)
    pts = points.float().contiguous()
    elig = eligible.to(torch.bool).contiguous().view(torch.uint8)
    cuda.check_cuda(kernel.name, pts, elig)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=points.device)
    kernel.launch(pts.data_ptr(), elig.data_ptr(), B, N, num_samples, C, T, P,
                  out.data_ptr(), cuda.stream_handle(pts))
    return out


def fps_cuda_batched(points: torch.Tensor, eligible: torch.Tensor,
                     num_samples: int) -> torch.Tensor:
    """FPS of :func:`fps_plain` over B clouds in one launch (one cluster of
    :func:`fps_plan` per cloud)."""
    if points.device.type == "cpu":
        return fps_plain(points, eligible, num_samples)
    return _fps_launch(FPS, points, eligible, num_samples)


def fps_single_plain(points: torch.Tensor, eligible: torch.Tensor,
                     num_samples: int) -> torch.Tensor:
    """:func:`fps_plain` of one cloud: points [N, 3], eligible [N] -> idx
    [num_samples] int32 (``fps_pallas``'s contract)."""
    return fps_plain(points[None], eligible[None], num_samples)[0]


def fps_cuda_single(points: torch.Tensor, eligible: torch.Tensor,
                    num_samples: int) -> torch.Tensor:
    """FPS of :func:`fps_single_plain`: the batched kernel at B = 1."""
    if points.device.type == "cpu":
        return fps_single_plain(points, eligible, num_samples)
    return _fps_launch(FPS_SINGLE, points[None], eligible[None], num_samples)[0]
