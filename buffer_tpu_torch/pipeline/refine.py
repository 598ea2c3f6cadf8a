"""IRLS weighted-Kabsch pose refinement (counterpart of
``buffer_tpu/pipeline/refine.py``; reference post_refinement,
models/BUFFER.py:382-418)."""

from __future__ import annotations

import torch

from buffer_tpu_torch.core import se3


def post_refinement(pose: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                    valid: torch.Tensor, inlier_threshold: float,
                    iters: int = 20) -> torch.Tensor:
    """``iters`` fixed rounds of inlier re-selection with Cauchy-like
    weights 1/(1 + (d/th)^2) and a weighted Kabsch; a round with fewer than
    3 inliers keeps the pose."""
    for _ in range(iters):
        warped = se3.transform(src[None], pose[None])[0]
        d = torch.linalg.norm(warped - tgt, dim=-1)
        inl = (d < inlier_threshold) & valid
        w = (1.0 / (1.0 + (d / inlier_threshold) ** 2)) * inl
        new = se3.kabsch_quat(src[None], tgt[None], w[None])[0]
        pose = torch.where(torch.sum(inl) >= 3, new, pose)
    return pose
