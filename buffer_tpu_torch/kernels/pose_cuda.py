"""The pose solver: batched weighted Kabsch (Horn's quaternion method by
shifted power iteration) and the IRLS refinement built on it, each one
launch of ``csrc/pose.cu``.

Neither replaces a TPU kernel: the JAX package leaves
``buffer_tpu/core/se3.py:kabsch_quat`` and
``buffer_tpu/pipeline/refine.py:post_refinement`` to XLA, which fuses
them, while in PyTorch each of the 60 power steps is a handful of library
launches on one 4x4 matrix.  The plain versions are those functions as the
port writes them (:func:`buffer_tpu_torch.core.se3.kabsch_quat` and the
``post_refinement`` loop).  Each wrapper takes its plain version for CPU
tensors only; a CUDA tensor goes to the kernel or raises.  The kernels
repeat the plain versions' expressions with separately rounded operations
but sum in another order, so on the card the two agree to rounding, not bit
for bit.  Neither kernel has a backward; both raise when an input asks for
a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from buffer_tpu_torch.core import se3
from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels.cuda import F, I, P

KABSCH = cuda.register(cuda.Kernel(
    "kabsch", "buffer_tpu_torch/csrc/pose.cu", "kabsch_launch",
    [P, P, P, I, I, F, I, P, P], "buffer_tpu/core/se3.py:208"))
IRLS = cuda.register(cuda.Kernel(
    "irls", "buffer_tpu_torch/csrc/pose.cu", "irls_launch",
    [P, P, P, P, I, F, F, I, I, P, P], "buffer_tpu/pipeline/refine.py:21"))


def kabsch_cuda(A: torch.Tensor, B: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`se3.kabsch_quat` (A, B [bs, N, 3], weights [bs, N] or None
    for all ones -> [bs, 4, 4] with ``B ~= R @ A + t``) of every problem in
    one launch: one thread a problem of at most 32 points (RANSAC's
    hypotheses), else one CTA a problem (the refit on the winner's
    inliers)."""
    w = () if weights is None else (weights,)
    if not (A.dim() == 3 and A.shape[-1] == 3 and B.shape == A.shape
            and A.shape[0] >= 1 and A.shape[1] >= 1
            and all(t.shape == A.shape[:2] for t in w)):
        raise ValueError("kabsch: A and B must be [bs, N, 3] alike and "
                         "weights [bs, N], not "
                         f"{[tuple(t.shape) for t in (A, B, *w)]}")
    if any(t.dtype != torch.float32 for t in (A, B, *w)):
        raise ValueError("kabsch: A, B and weights must be float32")
    if A.device.type == "cpu":
        return se3.kabsch_quat(A, B, weights)
    cuda.check_no_grad("kabsch", A, B, *w)
    cuda.check_cuda("kabsch", A, B, *w)
    bs, N, _ = A.shape
    out = torch.empty((bs, 4, 4), dtype=torch.float32, device=A.device)
    KABSCH.launch(A.data_ptr(), B.data_ptr(),
                  None if weights is None else weights.data_ptr(), bs, N,
                  se3.KABSCH_EPS, se3.KABSCH_ITERS, out.data_ptr(),
                  cuda.stream_handle(A))
    return out


def irls_plain(pose: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
               valid: torch.Tensor, inlier_threshold: float,
               iters: int) -> torch.Tensor:
    """``iters`` fixed rounds of inlier re-selection with Cauchy-like
    weights 1/(1 + (d/th)^2) and a weighted Kabsch; a round with fewer than
    3 inliers keeps the pose.  pose [4, 4], src and tgt [K, 3], valid [K]
    -> [4, 4]."""
    for _ in range(iters):
        warped = se3.transform(src[None], pose[None])[0]
        d = torch.linalg.norm(warped - tgt, dim=-1)
        inl = (d < inlier_threshold) & valid
        w = (1.0 / (1.0 + (d / inlier_threshold) ** 2)) * inl
        new = se3.kabsch_quat(src[None], tgt[None], w[None])[0]
        pose = torch.where(torch.sum(inl) >= 3, new, pose)
    return pose


def irls_cuda(pose: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
              valid: torch.Tensor, inlier_threshold: float,
              iters: int) -> torch.Tensor:
    """:func:`irls_plain`, every round in one launch of one CTA."""
    if not (pose.shape == (4, 4) and src.dim() == 2 and src.shape[-1] == 3
            and tgt.shape == src.shape and valid.shape == src.shape[:1]):
        raise ValueError("irls: pose must be [4, 4], src and tgt [K, 3] and "
                         "valid [K], not "
                         f"{[tuple(t.shape) for t in (pose, src, tgt, valid)]}")
    if (any(t.dtype != torch.float32 for t in (pose, src, tgt))
            or valid.dtype != torch.bool):
        raise ValueError("irls: pose, src and tgt must be float32 and valid "
                         "bool")
    if iters < 0:
        raise ValueError(f"irls: iters={iters} must be >= 0")
    if src.device.type == "cpu":
        return irls_plain(pose, src, tgt, valid, inlier_threshold, iters)
    cuda.check_no_grad("irls", pose, src, tgt)
    cuda.check_cuda("irls", pose, src, tgt, valid)
    out = torch.empty((4, 4), dtype=torch.float32, device=src.device)
    IRLS.launch(pose.data_ptr(), src.data_ptr(), tgt.data_ptr(),
                valid.view(torch.uint8).data_ptr(), src.shape[0],
                inlier_threshold, se3.KABSCH_EPS, se3.KABSCH_ITERS, iters,
                out.data_ptr(),
                cuda.stream_handle(src))
    return out
