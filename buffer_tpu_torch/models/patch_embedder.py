"""MiniSpinNet descriptors: the inference front (counterpart of
``buffer_tpu/models/patch_embedder.py``).

1. patch extraction (:func:`extract_patch_planes`): a random 512-subset of
   each keypoint's des_r ball, filler slots and the last slot holding the
   keypoint (reference select_patches, patch_embedder.py:93-121);
2. alignment (:func:`align_rotation`): Rodrigues rotation taking the
   learned z-axis to +z for 3DMatch-family data, identity otherwise;
3. the fused SPT front (:func:`fused_point_features`): BN folded into the
   point MLP, the azimuth derotations folded into its weights, then the
   CUDA kernel ``spt_pooled_cuda``;
4. :class:`MiniSpinNet` on the pooled map: cylindrical CNN, attention
   pooling, L2-normalized descriptor and channel-normalized equivariant map.

The sampled SPT front and ``axis_align`` serve training and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from buffer_tpu_torch.core import gridmath, se3
from buffer_tpu_torch.core.numerics import safe_normalize
from buffer_tpu_torch.kernels.geom_cuda import spt_pooled_cuda
from buffer_tpu_torch.nn.cylindrical import CylindricalNet
from buffer_tpu_torch.ops.neighbors import ball_sample_planes


def extract_patch_planes(pts, pts_valid, prio, kpts, des_r: float,
                         patch_sample: int):
    """Patches as coordinate planes (x, y, z) [B, K, S] for clouds pts
    [B, N, 3] and keypoints kpts [B, K, 3], from the ball priorities prio
    [B, N]; filler slots and the last slot hold the keypoint."""
    x, y, z, valid = ball_sample_planes(kpts, pts, pts_valid, prio,
                                        float(des_r), patch_sample)
    S = x.shape[-1]
    col = torch.arange(S, device=x.device)
    keep = valid & (col != S - 1)
    return tuple(torch.where(keep, c, kpts[..., d:d + 1])
                 for d, c in enumerate((x, y, z)))


def align_rotation(dataset: str, z_axis: torch.Tensor) -> torch.Tensor:
    """Per-patch alignment [K, 3, 3] (patch_embedder.py:123-149)."""
    if dataset in ("3DMatch", "3DLoMatch"):
        target = torch.tensor([0.0, 0.0, 1.0], dtype=z_axis.dtype,
                              device=z_axis.device).expand_as(z_axis)
        return se3.rodrigues_a_to_b(z_axis, target)
    return torch.eye(3, dtype=z_axis.dtype,
                     device=z_axis.device).expand(z_axis.shape[0], 3, 3)


def fold_point_mlp(desc: "MiniSpinNet", azi_n: int):
    """The point MLP with its batch norm folded in and the azimuth
    derotations folded into the weights: (W_all [azi_n, 3, 16], b_eff [16],
    f0 [16] = relu(b_eff), the feature of an empty sample slot)."""
    conv, bn = desc.pnt_layer[0], desc.pnt_layer[1]
    W = conv.weight[:, :, 0, 0].t()                          # [3, 16]
    scale = bn.weight / torch.sqrt(bn.running_var + 1e-5)
    W_eff = W * scale[None, :]
    b_eff = (conv.bias - bn.running_mean) * scale + bn.bias
    R = torch.as_tensor(gridmath.azimuth_derotations(azi_n), dtype=W.dtype,
                        device=W.device)
    W_all = torch.einsum("aji,jc->aic", R, W_eff)           # R_a^T @ W_eff
    return W_all, b_eff, torch.relu(b_eff)


def fused_point_features(desc: "MiniSpinNet", u: torch.Tensor, planes, R_align,
                         rad_n: int, azi_n: int, ele_n: int, voxel_r: float,
                         voxel_sample: int) -> torch.Tensor:
    """SPT + point MLP + sample max for inference: per anchor, the
    top-priority in-ball point of each of voxel_sample patch segments
    (priorities u [S] shared by all patches), max-pooled.  planes (x, y, z)
    [K, S] are the unrotated normalized patch coordinates and R_align
    [K, 3, 3] their alignment.  Returns [K, rad_n, ele_n, azi_n, 16]."""
    W_all, b_eff, f0 = fold_point_mlp(desc, azi_n)
    return spt_pooled_cuda(W_all, b_eff, f0, u, planes, R_align, rad_n, azi_n,
                           ele_n, voxel_r, voxel_sample)


class MiniSpinNet(nn.Module):
    """Descriptor network (patch_embedder.py:17-91) on the pooled map."""

    def __init__(self, rad_n: int = 3, azi_n: int = 20, ele_n: int = 7):
        super().__init__()
        self.rad_n, self.azi_n, self.ele_n = rad_n, azi_n, ele_n
        self.pnt_layer = nn.Sequential(nn.Conv2d(3, 16, 1), nn.BatchNorm2d(16),
                                       nn.ReLU(True))
        self.pool_layer = nn.Sequential(
            nn.Conv2d(32, 16, 1), nn.BatchNorm2d(16), nn.ReLU(True),
            nn.Conv2d(16, 1, 1), nn.BatchNorm2d(1), nn.ReLU(True))
        self.conv_net = CylindricalNet()

    def forward(self, pooled: torch.Tensor):
        """pooled [K, rad, ele, azi, 16] -> (desc [K, 32], equi
        [K, ele, azi, 32])."""
        x = self.conv_net(pooled.permute(0, 4, 1, 2, 3))      # [K, 32, ele, azi]
        w = self.pool_layer(x)
        f = (x * w).mean(dim=(2, 3))
        desc = safe_normalize(f, dim=-1, eps=1e-12)
        equi = safe_normalize(x, dim=1, eps=1e-12)
        return desc, equi.permute(0, 2, 3, 1)
