"""Farthest point sampling (counterparts of
``buffer_tpu/kernels/fps_pallas.py`` ``fps_pallas_batched`` and the
single-cloud ``fps_pallas``; both launch ``csrc/fps.cu``, the single cloud
at B = 1, and count their launches apart).

Each wrapper takes the plain PyTorch version for CPU tensors only; a CUDA
tensor goes to ``csrc/fps.cu`` or raises.  Both compute each step's distances as
((dx*dx + dy*dy) + dz*dz) with separately rounded operations: FPS is
chaotic, so the indices agree only when the rounding does.
"""

from __future__ import annotations

import torch

from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels.cuda import I, P

FPS = cuda.register(cuda.Kernel(
    "fps", "buffer_tpu_torch/csrc/fps.cu", "fps_launch",
    [P, P, P, P, I, I, I, P, P],
    "buffer_tpu/kernels/fps_pallas.py:155"))
FPS_SINGLE = cuda.register(cuda.Kernel(
    "fps_single", "buffer_tpu_torch/csrc/fps.cu", "fps_launch",
    [P, P, P, P, I, I, I, P, P],
    "buffer_tpu/kernels/fps_pallas.py:67"))

MAX_POINTS = 64 * 1024


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


def _fps_launch(kernel: cuda.Kernel, points: torch.Tensor,
                eligible: torch.Tensor, num_samples: int) -> torch.Tensor:
    B, N, _ = points.shape
    if N > MAX_POINTS or N == 0 or num_samples < 1:
        raise ValueError(f"fps: N={N} must be in 1..{MAX_POINTS}, "
                         f"num_samples={num_samples} >= 1")
    pts = points.float()
    x, y, z = (pts[..., d].contiguous() for d in range(3))
    elig = eligible.to(torch.uint8).contiguous()
    cuda.check_cuda(kernel.name, x, y, z, elig)
    out = torch.empty((B, num_samples), dtype=torch.int32, device=points.device)
    kernel.launch(x.data_ptr(), y.data_ptr(), z.data_ptr(), elig.data_ptr(), B,
                  N, num_samples, out.data_ptr(), cuda.stream_handle(x))
    return out


def fps_cuda_batched(points: torch.Tensor, eligible: torch.Tensor,
                     num_samples: int) -> torch.Tensor:
    """FPS of :func:`fps_plain` over B clouds in one launch (one block of
    1024 threads per cloud)."""
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
