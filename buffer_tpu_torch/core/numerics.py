"""Gradient-safe norms (counterpart of ``buffer_tpu/core/numerics.py``)."""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with value >= eps (zero gradient at zero)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps * eps))


def safe_normalize(x: torch.Tensor, dim=-1, eps: float = 1e-8) -> torch.Tensor:
    """x / max(|x|, eps); zero vectors stay zero."""
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)
