"""Rotation-equivariant point U-Net (EFCNN) and saliency decoder (DetNet).

Counterpart of ``buffer_tpu/models/point_learner.py``: the reference
architecture (models/point_learner.py:4-14) run on the masked static
:class:`Pyramid` of padded per-cloud arrays [B, N_l, ...].  Shadow
neighbours (invalid slots) gather a zero row: zero feature, zero offset,
and they still count in the mean over the K neighbours, which keeps the
reference's shadow-counting denominator (point_learner.py:16-21).

Features are [B, N, C, 3]; parameter names are the reference's.  In train
mode every batch norm takes the JAX package's masks: a conv block the query
mask broadcast over its K neighbour slots, the unary and shortcut layers
the query mask, the decoder and heads their level's mask (JAX
point_learner.py:204, 223-237, 325-375).  Both clouds lie on the batch
axis and share one set of statistics; autograd flows through the gathers.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn as nn

from buffer_tpu_torch.nn.vn import InvariantHead, VNLinearLeakyReLU
from buffer_tpu_torch.ops.neighbors import gather_rows


class Pyramid(NamedTuple):
    """Static-shape 3-level conv pyramid; leading cloud axis B (src, tgt)."""

    points: Tuple[torch.Tensor, ...]          # [B, N_l, 3]
    masks: Tuple[torch.Tensor, ...]           # [B, N_l] bool
    neighbors: Tuple[torch.Tensor, ...]       # [B, N_l, K_l] int32
    neighbor_valid: Tuple[torch.Tensor, ...]  # [B, N_l, K_l] bool
    pools: Tuple[torch.Tensor, ...]           # [B, N_{l+1}, K_l] into level l
    pool_valid: Tuple[torch.Tensor, ...]
    upsamples: Tuple[torch.Tensor, ...]       # [B, N_l] into level l+1
    upsample_valid: Tuple[torch.Tensor, ...]
    features: torch.Tensor                    # [B, N_0, 3] input normals


def gather_neighborhood(s_pts, s_feat, q_pts, idx, valid, scale: float):
    """Neighbour features [B, Nq, K, C, 3] and scale-normalized centred
    offsets [B, Nq, K, 3]; shadow slots give zeros for both
    (models/point_learner.py:328-343)."""
    B, Ns = s_pts.shape[:2]
    idx = torch.where(valid, idx, torch.full_like(idx, Ns))
    C = s_feat.shape[-2]
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
    nbr_xyz = gather_rows(pad(s_pts), idx)
    nbr_f = gather_rows(pad(s_feat.reshape(B, Ns, C * 3)), idx)
    nbr_f = nbr_f.reshape(idx.shape + (C, 3))
    eqv = (nbr_xyz - q_pts[:, :, None, :]) / scale
    eqv = torch.where(valid[..., None], eqv, torch.zeros_like(eqv))
    return nbr_f, eqv


def _slot_mask(q_mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The query mask broadcast over the K neighbour slots."""
    return q_mask[:, :, None].expand(idx.shape)


class VNNConvBlock(nn.Module):
    """'VNN_first': mode-'6' channels (feature, offset, cross, mean offset)
    -> VNLinearLeakyReLU -> mean over neighbours (point_learner.py:268-416)."""

    def __init__(self, in_dim: int, out_dim: int, scale: float):
        super().__init__()
        self.scale = scale
        self.conv = VNLinearLeakyReLU(in_dim + 3, out_dim)

    def forward(self, x, q_pts, q_mask, s_pts, idx, valid):
        nbr_f, eqv = gather_neighborhood(s_pts, x, q_pts, idx, valid, self.scale)
        cros = torch.cross(nbr_f[..., 0, :], eqv, dim=-1)
        mean = eqv.mean(dim=2, keepdim=True).expand_as(eqv)
        inp = torch.cat([nbr_f, eqv[..., None, :], cros[..., None, :],
                         mean[..., None, :]], dim=-2)
        return self.conv(inp, _slot_mask(q_mask, idx)).mean(dim=2)


class VNNResnetBlock(nn.Module):
    """Mode-'1' bottleneck residual block (point_learner.py:419-582); the
    strided shortcut is the max over the gathered features, shadows at 0."""

    def __init__(self, in_dim: int, out_dim: int, scale: float, strided: bool):
        super().__init__()
        self.scale = scale
        self.strided = strided
        self.conv = VNLinearLeakyReLU(in_dim + 1, out_dim // 2)
        self.unary = VNLinearLeakyReLU(out_dim // 2, out_dim)
        self.unary_shortcut = VNLinearLeakyReLU(in_dim, out_dim)

    def forward(self, x, q_pts, q_mask, s_pts, idx, valid):
        nbr_f, eqv = gather_neighborhood(s_pts, x, q_pts, idx, valid, self.scale)
        h = self.conv(torch.cat([nbr_f, eqv[..., None, :]], dim=-2),
                      _slot_mask(q_mask, idx)).mean(dim=2)
        h = self.unary(h, q_mask)
        shortcut = nbr_f.max(dim=2).values if self.strided else x
        return h + self.unary_shortcut(shortcut, q_mask)


class VNBlock(nn.Module):
    """Pointwise decoder 'VN' block (point_learner.py:246-265)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.mlp = VNLinearLeakyReLU(in_dim, out_dim)

    def forward(self, x, mask):
        return self.mlp(x, mask)


def nearest_upsample(x: torch.Tensor, idx: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """closest_pool: copy the nearest coarse feature, zeros for shadows
    (point_learner.py:635-647).  x [B, Nc, C, 3], idx/valid [B, Nf]."""
    B, Nc, C, _ = x.shape
    up = gather_rows(x.reshape(B, Nc, C * 3), idx).reshape(idx.shape + (C, 3))
    return torch.where(valid[..., None, None], up, torch.zeros_like(up))


class _Decoder(nn.Module):
    """Shared decoder wiring (point_learner.py:78-119): up(2->1), VN(6d->2d),
    up(1->0), VN(3d->d); indices 0 and 2 are the reference's parameter-free
    upsample entries."""

    def __init__(self, fd: int):
        super().__init__()
        self.decoder_blocks = nn.ModuleList([
            nn.Identity(), VNBlock(fd * 6, fd * 2),
            nn.Identity(), VNBlock(fd * 3, fd)])

    def _decode(self, bottle, skips, pyr: Pyramid):
        x = nearest_upsample(bottle, pyr.upsamples[1], pyr.upsample_valid[1])
        x = self.decoder_blocks[1](torch.cat([x, skips[1]], dim=-2), pyr.masks[1])
        x = nearest_upsample(x, pyr.upsamples[0], pyr.upsample_valid[0])
        return self.decoder_blocks[3](torch.cat([x, skips[0]], dim=-2),
                                      pyr.masks[0])


class EFCNN(_Decoder):
    """Reference-axis U-Net (point_learner.py:154-204).  Returns (axis
    [B, N0, 3], eps [B, N0, 1], branch with the bottleneck and skips)."""

    def __init__(self, fd: int = 10, scale: float = 1.0):
        super().__init__(fd)
        # unused, as in the reference; a buffer, so no optimizer moves it
        self.register_buffer("epsilon", torch.tensor(-5.0))
        self.encoder_blocks = nn.ModuleList([
            VNNConvBlock(1, fd, scale),
            VNNResnetBlock(fd, fd, scale, True),
            VNNResnetBlock(fd, fd * 2, scale, False),
            VNNResnetBlock(fd * 2, fd * 2, scale, True),
            VNNResnetBlock(fd * 2, fd * 4, scale, False)])
        self.fc_layer = nn.ModuleList([VNLinearLeakyReLU(fd, fd // 2),
                                       VNLinearLeakyReLU(fd // 2, 1)])
        self.inv_layer = InvariantHead(fd, "sigmoid")

    def forward(self, pyr: Pyramid):
        pts, msk = pyr.points, pyr.masks
        nb, nv = pyr.neighbors, pyr.neighbor_valid
        enc = self.encoder_blocks
        x0 = enc[0](pyr.features[..., None, :], pts[0], msk[0], pts[0], nb[0], nv[0])
        x1 = enc[1](x0, pts[1], msk[1], pts[0], pyr.pools[0], pyr.pool_valid[0])
        x1 = enc[2](x1, pts[1], msk[1], pts[1], nb[1], nv[1])
        x2 = enc[3](x1, pts[2], msk[2], pts[1], pyr.pools[1], pyr.pool_valid[1])
        x2 = enc[4](x2, pts[2], msk[2], pts[2], nb[2], nv[2])
        x = self._decode(x2, (x0, x1), pyr)
        h = self.fc_layer[1](self.fc_layer[0](x, msk[0]), msk[0])
        eps = self.inv_layer(x, msk[0])
        return h[..., 0, :], eps, {"bottle": x2, "skips": (x0, x1)}


class DetNet(_Decoder):
    """Saliency decoder (point_learner.py:122-151) on EFCNN's bottleneck and
    skips; Softplus head.  Returns [B, N0, 1]."""

    def __init__(self, fd: int = 10):
        super().__init__(fd)
        # unused, as in the reference; a buffer, so no optimizer moves it
        self.register_buffer("epsilon", torch.tensor(-5.0))
        self.invar_layer = InvariantHead(fd, "softplus")

    def forward(self, pyr: Pyramid, branch):
        x = self._decode(branch["bottle"], branch["skips"], pyr)
        return self.invar_layer(x, pyr.masks[0])
