"""Equivariant matching and the SO(2) cost-volume head (counterpart of
``buffer_tpu/models/heads.py``; reference ``EquiMatch`` and ``CostVolume``,
models/BUFFER.py:15-66)."""

from __future__ import annotations

import torch
import torch.nn as nn

from buffer_tpu_torch.nn.cylindrical import CostNet


def _azimuth_rolls(des: torch.Tensor, azi_n: int) -> torch.Tensor:
    """des [M, ele, azi, C] -> [M, azi_n (shift), ele, azi, C]; shift i is
    des rolled by i along azimuth."""
    return torch.stack([torch.roll(des, i, dims=2) for i in range(azi_n)], dim=1)


def equi_match(des1: torch.Tensor, des2: torch.Tensor, azi_n: int) -> torch.Tensor:
    """Correlation of every azimuth shift of des1 with des2
    (models/BUFFER.py:26-34): des* [M, ele, azi, C] -> [M, azi_n]."""
    return torch.einsum("mnkac,mkac->mn", _azimuth_rolls(des1, azi_n), des2)


class CostVolume(nn.Module):
    """Roll des1 over every azimuth shift, subtract des2, aggregate with the
    3-D CostNet and return the soft-argmax azimuth bin [M]."""

    def __init__(self, azi_n: int = 20):
        super().__init__()
        self.azi_n = azi_n
        self.conv = CostNet(azi_n)

    def cost(self, des1: torch.Tensor, des2: torch.Tensor) -> torch.Tensor:
        """The volume CostNet reads: [M, C, shift, ele, azi]."""
        rolls = _azimuth_rolls(des1, self.azi_n)
        return (rolls - des2[:, None]).permute(0, 4, 1, 2, 3)

    def forward(self, des1: torch.Tensor, des2: torch.Tensor) -> torch.Tensor:
        """des1, des2 [M, ele_band, azi, C] (the reduced elevation band)."""
        prob = torch.softmax(self.conv(self.cost(des1, des2)), dim=-1)
        bins = torch.arange(self.azi_n, dtype=prob.dtype, device=prob.device)
        return torch.sum(prob * bins, dim=-1)
