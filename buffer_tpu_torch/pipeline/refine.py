"""IRLS weighted-Kabsch pose refinement (counterpart of
``buffer_tpu/pipeline/refine.py``; reference post_refinement,
models/BUFFER.py:382-418)."""

from __future__ import annotations

import torch

from buffer_tpu_torch.kernels.pose_cuda import irls_cuda


def post_refinement(pose: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                    valid: torch.Tensor, inlier_threshold: float,
                    iters: int = 20) -> torch.Tensor:
    """``iters`` fixed rounds of inlier re-selection with Cauchy-like
    weights 1/(1 + (d/th)^2) and a weighted Kabsch; a round with fewer than
    3 inliers keeps the pose.  Every round in one call of ``irls_cuda``
    through this module (``kernels/sites.py`` swaps in the plain loop)."""
    return irls_cuda(pose, src, tgt, valid, inlier_threshold, iters)
