"""Farthest point sampling (counterpart of ``buffer_tpu/ops/sampling.py``).

Replaces ``pointnet2_ops.furthest_point_sample`` (models/BUFFER.py:266-267);
the detector threshold becomes an eligibility mask instead of a dynamic
boolean filter."""

from __future__ import annotations

from typing import Tuple

import torch

from buffer_tpu_torch.kernels.fps_cuda import fps_cuda_batched, fps_cuda_single


def farthest_point_sample(points: torch.Tensor, eligible: torch.Tensor,
                          num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS over the eligible subset of one cloud: points [N, 3], eligible
    [N] -> (idx [num_samples] int32, valid [num_samples]).  Starts at the
    first eligible point; slots past the eligible count repeat selected
    points and are invalid."""
    n_eligible = torch.sum(eligible.to(torch.int32))
    valid = torch.arange(num_samples, device=points.device) < n_eligible
    return fps_cuda_single(points, eligible, num_samples), valid


def farthest_point_sample_batched(points: torch.Tensor, eligible: torch.Tensor,
                                  num_samples: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points [B, N, 3]; eligible [B, N] -> (idx [B, S] int32, valid [B, S]).
    Slots past the eligible count repeat selected points and are invalid."""
    n_eligible = torch.sum(eligible.to(torch.int32), dim=1)
    valid = (torch.arange(num_samples, device=points.device)[None, :]
             < n_eligible[:, None])
    return fps_cuda_batched(points, eligible, num_samples), valid
