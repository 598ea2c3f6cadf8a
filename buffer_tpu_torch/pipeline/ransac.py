"""Batched correspondence RANSAC (counterpart of
``buffer_tpu/pipeline/ransac.py``; replaces Open3D's
registration_ransac_based_on_correspondence, models/BUFFER.py:314-324).

The 3-point draws are an input: Gumbel noise ``gumbel`` [H, 3, M], and
each draw is ``argmax(where(valid, 0, -inf) + gumbel)`` -- exactly what
``jax.random.categorical`` computes from its own Gumbel draws.  Both
solves (every hypothesis at once, then the refit) call ``kabsch_cuda``
through this module, where ``kernels/sites.py`` swaps in the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from buffer_tpu_torch.kernels.pose_cuda import kabsch_cuda
from buffer_tpu_torch.pipeline.matching import take, warp_sqdist


def sample_triplets(valid: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Categorical draws over the valid correspondences: [H, 3] indices."""
    logits = torch.where(valid, 0.0, float("-inf")).to(gumbel.dtype)
    return torch.argmax(gumbel + logits, dim=-1)


def ransac_pose(gumbel: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                valid: torch.Tensor, dist_th: float, similar_th: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (pose [4, 4], inlier mask [M]): the winning hypothesis
    re-fit on its inliers (when it has at least 3); identity when fewer than
    3 valid correspondences exist or no hypothesis survives."""
    idx = sample_triplets(valid, gumbel)
    a, b = src[idx], tgt[idx]                                  # [H, 3, 3]
    T = kabsch_cuda(a, b)
    R, t = T[:, :3, :3], T[:, :3, 3]

    # checker 1: edge-length similarity; checker 2: the sample fits
    ea = torch.linalg.norm(a - torch.roll(a, 1, dims=1), dim=-1)
    eb = torch.linalg.norm(b - torch.roll(b, 1, dims=1), dim=-1)
    ok = torch.all((ea > similar_th * eb) & (eb > similar_th * ea), dim=-1)
    wa = torch.einsum("hij,hmj->hmi", R, a) + t[:, None, :]
    ok = ok & torch.all(torch.linalg.norm(wa - b, dim=-1) < dist_th, dim=-1)

    inl = (warp_sqdist(R, t, src, tgt) < dist_th * dist_th) & valid[None, :]
    counts = torch.where(ok, torch.sum(inl, dim=-1),
                         torch.full_like(ok, -1, dtype=torch.int64))
    best = torch.argmax(counts)
    pose = take(T, best)
    inliers = take(inl, best)
    feasible = (torch.sum(valid) >= 3) & (take(counts, best) > 0)
    w = inliers.to(src.dtype)
    refit_T = kabsch_cuda(src[None], tgt[None], w[None])[0]
    pose = torch.where(torch.sum(inliers) >= 3, refit_T, pose)
    eye = torch.eye(4, dtype=src.dtype, device=src.device)
    return torch.where(feasible, pose, eye), inliers & feasible
