"""Vector-Neuron layers (counterpart of ``buffer_tpu/nn/vn.py``).

VN features are [..., C, 3]: C vector channels of 3 components, the
reference's channel-major flat order (flat index c*3 + component) when
reshaped to [..., C*3].  Module and parameter names are the reference's
(``map_to_feat``, ``map_to_dir``, ``batchnorm.bn``), so reference state
dicts load directly.  Every batch norm goes through :func:`batch_norm`:
running statistics in eval mode, masked batch statistics in train mode.

Reference: models/vn_layers.py:12-222.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

EPS = 1e-6  # reference models/vn_layers.py:10


def _linear_vn(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Channel mixing of [..., Cin, 3] by a [Cout, Cin] weight."""
    return (x.transpose(-1, -2) @ weight.t()).transpose(-1, -2)


def batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch norm over the last axis (channels) of any shape, with the
    semantics of the JAX package's ``MaskedBatchNorm`` (nn/vn.py:53-100).

    Eval mode normalizes by the running statistics.  Train mode normalizes
    by the batch mean and biased variance over every other axis, restricted
    to ``mask`` (shaped like ``x`` without its channel axis) when one is
    given, and moves the running statistics in place: momentum
    ``bn.momentum`` (0.1), the unbiased variance ``var*cnt/max(cnt-1, 1)``."""
    if not bn.training:
        mean, var = bn.running_mean, bn.running_var
    else:
        dims = tuple(range(x.dim() - 1))
        if mask is None:
            cnt = float(x.numel() // x.shape[-1])
            mean = torch.mean(x, dim=dims)
            var = torch.mean((x - mean) ** 2, dim=dims)
            denom = max(cnt - 1.0, 1.0)
        else:
            m = mask.to(x.dtype)[..., None]
            cnt = torch.clamp(torch.sum(m), min=1.0)
            mean = torch.sum(x * m, dim=dims) / cnt
            var = torch.sum(m * (x - mean) ** 2, dim=dims) / cnt
            denom = torch.clamp(cnt - 1.0, min=1.0)
        with torch.no_grad():
            mom = bn.momentum
            unbiased = var * cnt / denom
            bn.running_mean.copy_((1 - mom) * bn.running_mean + mom * mean)
            bn.running_var.copy_((1 - mom) * bn.running_var + mom * unbiased)
            bn.num_batches_tracked.add_(1)
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + bn.eps))
    if bn.affine:
        y = y * bn.weight + bn.bias
    return y


class VNBatchNorm(nn.Module):
    """Batch norm of the vector norms, features rescaled to the normalized
    norm; identity for one channel, whose parameters still exist
    (models/vn_layers.py:108-130).  ``mask``, shaped like p without its
    last two axes, restricts the batch statistics in train mode."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        self.bn = nn.BatchNorm1d(features)

    def forward(self, p: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.features == 1:
            return p
        norm = torch.sqrt(torch.clamp(torch.sum(p * p, dim=-1), min=1e-24)) + EPS
        return p * (batch_norm(norm, self.bn, mask) / norm)[..., None]


class VNLinearLeakyReLU(nn.Module):
    """Linear -> VNBatchNorm -> direction-gated leaky ReLU
    (models/vn_layers.py:46-75); the gate direction comes from the input."""

    def __init__(self, cin: int, cout: int, negative_slope: float = 0.2):
        super().__init__()
        self.map_to_feat = nn.Linear(cin, cout, bias=False)
        self.batchnorm = VNBatchNorm(cout)
        self.map_to_dir = nn.Linear(cin, cout, bias=False)
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        p = self.batchnorm(_linear_vn(x, self.map_to_feat.weight), mask)
        d = _linear_vn(x, self.map_to_dir.weight)
        dot = torch.sum(p * d, dim=-1, keepdim=True)
        pos = (dot >= 0).to(p.dtype)
        dsq = torch.sum(d * d, dim=-1, keepdim=True)
        reflected = p - (dot / (dsq + EPS)) * d
        s = self.negative_slope
        return s * p + (1.0 - s) * (pos * p + (1.0 - pos) * reflected)


class VNStdFeature(nn.Module):
    """Learned invariant frame (models/vn_layers.py:169-222, the
    normalize_frame=False variant): [..., C, 3] -> invariant [..., C*3] in
    the reference order (c*3 + k)."""

    def __init__(self, cin: int, negative_slope: float = 0.0):
        super().__init__()
        self.vn1 = VNLinearLeakyReLU(cin, cin, negative_slope)
        self.vn2 = VNLinearLeakyReLU(cin, cin // 2, negative_slope)
        self.vn_lin = nn.Linear(cin // 2, 3, bias=False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        z = _linear_vn(self.vn2(self.vn1(x, mask), mask), self.vn_lin.weight)  # [..., 3, 3]
        std = x @ z.transpose(-1, -2)          # std[c, k] = sum_j x[c, j] z[k, j]
        return std.reshape(*std.shape[:-2], -1)


def masked_instance_norm(x: torch.Tensor, mask: torch.Tensor, dims: tuple,
                         eps: float = 1e-5) -> torch.Tensor:
    """Instance norm with statistics over ``dims`` restricted to ``mask``
    (both clouds together: the reference stacks them on one axis)."""
    m = mask.to(x.dtype)[..., None]
    cnt = torch.clamp(torch.sum(m, dim=dims, keepdim=True), min=1.0)
    mean = torch.sum(x * m, dim=dims, keepdim=True) / cnt
    var = torch.sum(m * (x - mean) ** 2, dim=dims, keepdim=True) / cnt
    return (x - mean) / torch.sqrt(var + eps)


class InvariantHead(nn.Sequential):
    """VNStdFeature -> Conv1d(3C->2C) -> IN -> Conv1d(2C->C) -> IN ->
    Conv1d(C->1) -> activation, numbered like the reference's Sequential
    (0, 1, 3, 5).  Instance-norm statistics span both clouds
    (models/point_learner.py:128-136, 163-171)."""

    def __init__(self, dim: int, activation: str):
        super().__init__(
            VNStdFeature(dim), nn.Conv1d(dim * 3, dim * 2, 1), nn.Identity(),
            nn.Conv1d(dim * 2, dim, 1), nn.Identity(), nn.Conv1d(dim, 1, 1))
        self.activation = activation

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, N, C, 3], mask [B, N] -> [B, N, 1]."""
        conv = lambda i, h: F.linear(h, self[i].weight[:, :, 0], self[i].bias)
        h = conv(1, self[0](x, mask))
        h = masked_instance_norm(h, mask, dims=(0, 1))
        h = masked_instance_norm(conv(3, h), mask, dims=(0, 1))
        y = conv(5, h)
        return torch.sigmoid(y) if self.activation == "sigmoid" else F.softplus(y)
