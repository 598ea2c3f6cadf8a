"""Cylindrical CNNs of the patch embedder and the inlier cost volume
(counterpart of ``buffer_tpu/nn/cylindrical.py``; reference
models/patchnet.py).  Channels-first (NCHW / NCDHW) as in the reference,
with its ``ops.N`` parameter numbering; all batch norms are affine-free
and unmasked: PyTorch's own batch norm, running statistics in eval mode and
batch statistics in train mode, the semantics of the JAX package's
``MaskedBatchNorm`` without a mask."""

from __future__ import annotations

import torch
import torch.nn as nn


def pad_cyl_2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Circular padding along azimuth (last axis), zeros along elevation
    (axis -2) for odd k (utils/common.py:265-310).  x [B, C, ele, azi], or
    [B, C, rad, ele, azi] with no radial padding."""
    p = (k - 1) // 2
    x = torch.cat([x[..., -p:], x, x[..., :p]], dim=-1)
    z = torch.zeros_like(x[..., :p, :])
    return torch.cat([z, x, z], dim=-2)


class CylindricalNet(nn.Module):
    """``Cylindrical_Net(inchan=16, dim=32)`` (models/patchnet.py:69-85):
    [B, 16, rad, ele, azi] -> [B, 32, ele, azi]."""

    def __init__(self):
        super().__init__()
        ops = [nn.Conv3d(16, 64, 3), nn.BatchNorm3d(64, affine=False), nn.ReLU()]
        cur = 64
        for d in (64, 128, 128, 64, 64, 32):
            ops += [nn.Conv2d(cur, d, 3), nn.BatchNorm2d(d, affine=False), nn.ReLU()]
            cur = d
        ops += [nn.Conv2d(32, 32, 3)]
        self.ops = nn.ModuleList(ops)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for op in self.ops:
            if isinstance(op, nn.Conv3d):
                x = op(pad_cyl_2d(x, 3))
            elif isinstance(op, nn.Conv2d):
                if x.dim() == 5:
                    x = x[:, :, 0]                    # radial dim collapsed to 1
                x = op(pad_cyl_2d(x, 3))
            else:
                x = op(x)
        return x


class CostNet(nn.Module):
    """``CostNet(inchan=32, dim=20)`` (models/patchnet.py:129-147): ten
    unpadded Conv3ds over [B, 32, 20 shifts, 5 ele, 20 azi] -> [B, 20]."""

    PLAN = ((32, 32, (3, 3, 3)), (32, 64, (3, 3, 3)), (64, 64, (3, 1, 3)),
            (64, 128, (3, 1, 3)), (128, 128, (3, 1, 3)), (128, 64, (3, 1, 3)),
            (64, 64, (3, 1, 3)), (64, 32, (3, 1, 3)), (32, 32, (3, 1, 3)))

    def __init__(self, out_dim: int = 20):
        super().__init__()
        ops = []
        for cin, cout, k in self.PLAN:
            ops += [nn.Conv3d(cin, cout, k), nn.BatchNorm3d(cout, affine=False),
                    nn.ReLU()]
        ops += [nn.Conv3d(32, out_dim, (2, 1, 2))]
        self.ops = nn.ModuleList(ops)
        self.out_dim = out_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for op in self.ops:
            x = op(x)
        return x.reshape(x.shape[0], self.out_dim)
