"""SO(2) cost-volume head (counterpart of ``buffer_tpu/models/heads.py``;
reference ``CostVolume``, models/BUFFER.py:37-66)."""

from __future__ import annotations

import torch
import torch.nn as nn

from buffer_tpu_torch.nn.cylindrical import CostNet


class CostVolume(nn.Module):
    """Roll des1 over every azimuth shift, subtract des2, aggregate with the
    3-D CostNet and return the soft-argmax azimuth bin [M]."""

    def __init__(self, azi_n: int = 20):
        super().__init__()
        self.azi_n = azi_n
        self.conv = CostNet(azi_n)

    def forward(self, des1: torch.Tensor, des2: torch.Tensor) -> torch.Tensor:
        """des1, des2 [M, ele_band, azi, C] (the reduced elevation band)."""
        rolls = torch.stack([torch.roll(des1, i, dims=2)
                             for i in range(self.azi_n)], dim=1)
        cost = (rolls - des2[:, None]).permute(0, 4, 1, 2, 3)  # [M, C, s, e, a]
        prob = torch.softmax(self.conv(cost), dim=-1)
        bins = torch.arange(self.azi_n, dtype=prob.dtype, device=prob.device)
        return torch.sum(prob * bins, dim=-1)
