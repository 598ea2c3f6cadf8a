"""Gradient-safe norms (counterpart of ``buffer_tpu/core/numerics.py``)
and the fp32 matmul precision of the registration path."""

from __future__ import annotations

import contextlib

import torch


def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with value >= eps (zero gradient at zero)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps * eps))


def safe_normalize(x: torch.Tensor, dim=-1, eps: float = 1e-8) -> torch.Tensor:
    """x / max(|x|, eps); zero vectors stay zero."""
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matmuls and cuDNN convolutions within the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
