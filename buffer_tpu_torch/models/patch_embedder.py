"""MiniSpinNet descriptors (counterpart of
``buffer_tpu/models/patch_embedder.py``).

The inference front:

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

The training front, the reference's own sampled path:
:func:`extract_patches` (the CUDA kernel ``ball_sample_points_cuda``),
:func:`axis_align`, optional :func:`so2_augment`, the sampled :func:`spt`
with its azimuth derotation, then :class:`MiniSpinNet` on the sampled
patches (point MLP, batch norm, ReLU, max over the samples).  Random draws
are inputs: ball and SPT priorities, SO(2) angles.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn

from buffer_tpu_torch.core import gridmath, se3
from buffer_tpu_torch.core.numerics import safe_normalize
from buffer_tpu_torch.kernels.geom_cuda import spt_pooled_cuda
from buffer_tpu_torch.nn.cylindrical import CylindricalNet
from buffer_tpu_torch.ops.neighbors import ball_sample_planes, ball_sample_points

BIG = 1e9


@functools.lru_cache(maxsize=None)
def spt_anchors(rad_n: int, azi_n: int, ele_n: int, dtype, device):
    """The SPT anchor centres of the unit grid, [rad_n*ele_n*azi_n, 3], on
    ``device`` (made once for each grid, dtype and device, so that no call
    copies host data)."""
    return torch.as_tensor(gridmath.get_voxel_coordinate(
        1.0, rad_n, azi_n, ele_n).reshape(-1, 3), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def azimuth_derotations(azi_n: int, dtype, device):
    """:func:`gridmath.azimuth_derotations` [azi_n, 3, 3] on ``device``
    (made once for each size, dtype and device)."""
    return torch.as_tensor(gridmath.azimuth_derotations(azi_n), dtype=dtype,
                           device=device)


def unit_axis(d: int, like: torch.Tensor) -> torch.Tensor:
    """The unit vector along axis ``d`` [3], with ``like``'s dtype and
    device (a fill on the device, not a copy of host data)."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[d]


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


def extract_patches(pts: torch.Tensor, pts_valid: torch.Tensor,
                    prio: torch.Tensor, kpts: torch.Tensor, des_r: float,
                    patch_sample: int) -> torch.Tensor:
    """Patches [B, K, S, 3] of clouds pts [B, N, 3] around keypoints kpts
    [B, K, 3] from the ball priorities prio [B, N], all clouds in one
    kernel launch; invalid slots and the last slot hold the keypoint
    (patch_embedder.py:44-69)."""
    gathered, valid = ball_sample_points(kpts, pts, pts_valid, prio,
                                         float(des_r), patch_sample)
    centre = kpts[:, :, None, :]
    patches = torch.where(valid[..., None], gathered, centre)
    return torch.cat([patches[:, :, :-1], centre], dim=2)


def axis_align(patches: torch.Tensor, dataset: str, z_axis: torch.Tensor):
    """patches [K, S, 3] with the centre last, z_axis [K, 3] ->
    (delta [K, S, 3] centred and aligned, rand_axis [K, 3], R [K, 3, 3])
    (patch_embedder.py:119-146): Rodrigues taking z_axis to +z for the
    3DMatch family, identity frames and rand_axis = x for KITTI and ETH."""
    center = patches[:, -1, :]
    delta = patches - center[:, None, :]
    if dataset in ("3DMatch", "3DLoMatch"):
        target = unit_axis(2, patches).expand_as(z_axis)
        R = se3.rodrigues_a_to_b(z_axis, target)
        rand_axis = safe_normalize(torch.cross(z_axis, target, dim=-1), dim=-1)
        return delta @ R, rand_axis, R
    K = patches.shape[0]
    rand_axis = unit_axis(0, patches).expand(K, 3)
    R = torch.eye(3, dtype=patches.dtype, device=patches.device).expand(K, 3, 3)
    return delta, rand_axis, R


def so2_augment(u: torch.Tensor, patches: torch.Tensor, rand_axis: torch.Tensor):
    """Rotation of each aligned patch about z by 2*pi*u, u [K] uniform
    (patch_embedder.py:359-368).  Returns (patches, rand_axis, aug [K,3,3])."""
    ang = u[:, None] * 2 * math.pi
    aa = torch.cat([torch.zeros_like(ang).expand(-1, 2), ang], dim=-1)
    aug = se3.angle_axis_to_rotation_matrix(aa)
    patches = patches @ aug.transpose(-1, -2)
    rand_axis = torch.einsum("kj,kij->ki", rand_axis, aug)
    return patches, rand_axis, aug


def spt(prio: torch.Tensor, delta_x: torch.Tensor, rad_n: int, azi_n: int,
        ele_n: int, voxel_r: float, voxel_sample: int,
        kpt_chunk: int = 128) -> torch.Tensor:
    """The sampled Spatial Point Transformer (patch_embedder.py:149-192):
    for each of the rad_n*ele_n*azi_n anchors, the voxel_sample
    highest-priority patch points within voxel_r (priorities prio [S]
    shared by all patches; ball test |p|^2 - 2 a.p + |a|^2 <= r^2 in that
    order), empty slots zero, then the azimuth derotation.  delta_x
    [K, S, 3] -> [K, A, voxel_sample, 3]."""
    dt, dev = delta_x.dtype, delta_x.device
    anchors = spt_anchors(rad_n, azi_n, ele_n, dt, dev)
    derot = azimuth_derotations(azi_n, dt, dev)
    a2 = torch.sum(anchors * anchors, dim=-1)
    r2 = voxel_r * voxel_r
    neg = torch.full((), -BIG, dtype=dt, device=dev)
    out = []
    for k0 in range(0, delta_x.shape[0], kpt_chunk):
        block = delta_x[k0:k0 + kpt_chunk]                          # [Kc, S, 3]
        d2 = (torch.sum(block * block, dim=-1)[:, None, :]
              - 2.0 * torch.einsum("ad,ksd->kas", anchors, block)
              + a2[None, :, None])                                   # [Kc, A, S]
        score = torch.where(d2 <= r2, prio[None, None, :], neg)
        vals, idx = torch.topk(score, voxel_sample, dim=-1)
        rows = torch.arange(block.shape[0], device=dev)[:, None, None]
        samp = block[rows, idx]                                      # [Kc, A, vs, 3]
        ok = (vals > -BIG / 10)[..., None]
        out.append(torch.where(ok, samp, torch.zeros_like(samp)))
    return gridmath.var_to_invar(torch.cat(out), derot, rad_n, azi_n, ele_n)


def align_rotation(dataset: str, z_axis: torch.Tensor) -> torch.Tensor:
    """Per-patch alignment [K, 3, 3] (patch_embedder.py:123-149)."""
    if dataset in ("3DMatch", "3DLoMatch"):
        target = unit_axis(2, z_axis).expand_as(z_axis)
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
    R = azimuth_derotations(azi_n, W.dtype, W.device)
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
    """Descriptor network (patch_embedder.py:17-91) with two fronts: the
    pooled map of the fused inference front, or the sampled patches of the
    training front."""

    def __init__(self, rad_n: int = 3, azi_n: int = 20, ele_n: int = 7):
        super().__init__()
        self.rad_n, self.azi_n, self.ele_n = rad_n, azi_n, ele_n
        self.pnt_layer = nn.Sequential(nn.Conv2d(3, 16, 1), nn.BatchNorm2d(16),
                                       nn.ReLU(True))
        self.pool_layer = nn.Sequential(
            nn.Conv2d(32, 16, 1), nn.BatchNorm2d(16), nn.ReLU(True),
            nn.Conv2d(16, 1, 1), nn.BatchNorm2d(1), nn.ReLU(True))
        self.conv_net = CylindricalNet()

    def forward(self, pooled: Optional[torch.Tensor] = None,
                inv_patches: Optional[torch.Tensor] = None):
        """pooled [K, rad, ele, azi, 16], or inv_patches [K, A, nsample, 3]
        from :func:`spt` (point MLP, batch norm, ReLU, max over the
        samples; patch_embedder.py:214-221) -> (desc [K, 32], equi
        [K, ele, azi, 32])."""
        if pooled is None:
            K = inv_patches.shape[0]
            h = self.pnt_layer(inv_patches.permute(0, 3, 1, 2))      # [K, 16, A, ns]
            h = torch.amax(h, dim=3).transpose(1, 2)                 # [K, A, 16]
            pooled = h.reshape(K, self.rad_n, self.ele_n, self.azi_n, 16)
        x = self.conv_net(pooled.permute(0, 4, 1, 2, 3))      # [K, 32, ele, azi]
        w = self.pool_layer(x)
        f = (x * w).mean(dim=(2, 3))
        desc = safe_normalize(f, dim=-1, eps=1e-12)
        equi = safe_normalize(x, dim=1, eps=1e-12)
        return desc, equi.permute(0, 2, 3, 1)
