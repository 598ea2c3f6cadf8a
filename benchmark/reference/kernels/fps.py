# Frozen copy of buffer_tpu_torch/kernels/fps_cuda.py at commit c88a0e7761321c01585f758b60ff2700171e6a6a: the
# plain versions of the port's kernels, which define what each kernel
# computes (launchers and plans left out).  The benchmark's reference calls
# them for the kernels' semantics only.  Do not edit.
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

import torch


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


