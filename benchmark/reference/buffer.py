"""The benchmark's plain reference of BUFFER's registration of one pair
(Ao et al., CVPR 2023; models/BUFFER.py:231-333 of the authors' code),
written from the method and its published settings, not from the port.

It reads the configuration file's ``model`` tree and the weights that the
benchmark made (a state dict under the authors' parameter names), and runs
in float64: the pyramid's normals and features, the equivariant point
network (EFCNN) and its saliency decoder (DetNet), MiniSpinNet on the
pooled patch map, mutual matching, the SO(2) cost volume, hypothesis
voting, RANSAC and the IRLS refinement.  The five operations that are
defined by their float32 comparisons -- the rank-banded and exact
neighbour searches, farthest point sampling, ball sampling and the SPT's
per-anchor winners -- run on float32 inputs through the frozen plain
versions in :mod:`benchmark.reference.kernels`.

``precision="tf32"`` runs the same code in float32 with TF32 on for
matmuls and convolutions: the control, one precision below the float32
with TF32 off that the configuration states.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.kernels import fps as kfps
from benchmark.reference.kernels import geom as kgeom
from benchmark.reference.kernels import knn as kknn

VN_EPS = 1e-6        # the authors' vn_layers.py EPS
BN_EPS = 1e-5        # PyTorch's batch- and instance-norm epsilon
HORN_ITERS = 60      # power-iteration steps of the quaternion fit
HORN_EPS = 1e-6


def settings(conf: dict) -> SimpleNamespace:
    """The configuration file's ``model`` tree with attribute access."""
    def ns(v):
        return SimpleNamespace(**{k: ns(x) for k, x in v.items()}) \
            if isinstance(v, dict) else v
    return ns(conf["model"])


class Draws(NamedTuple):
    """A request's random numbers, made by the benchmark from the seed."""

    ball_prio: torch.Tensor
    spt_prio: torch.Tensor
    ransac_gumbel: torch.Tensor
    ransac_gumbel_boost: Optional[torch.Tensor] = None


# --------------------------------------------------------------------------
# the parameters: names, shapes and how the benchmark draws them
# --------------------------------------------------------------------------


def _vn(p: str, cin: int, cout: int) -> list:
    return [(f"{p}.map_to_feat.weight", (cout, cin), "weight")] + _bn(
        f"{p}.batchnorm.bn", cout, True) + [
        (f"{p}.map_to_dir.weight", (cout, cin), "weight")]


def _bn(p: str, c: int, affine: bool) -> list:
    out = [(f"{p}.weight", (c,), "one"), (f"{p}.bias", (c,), "zero")] \
        if affine else []
    return out + [(f"{p}.running_mean", (c,), "zero"),
                  (f"{p}.running_var", (c,), "one"),
                  (f"{p}.num_batches_tracked", (), "count")]


def _conv(p: str, shape: tuple) -> list:
    return [(f"{p}.weight", shape, "weight"), (f"{p}.bias", shape[:1], "bias")]


def _head(p: str, d: int) -> list:
    return (_vn(f"{p}.0.vn1", d, d) + _vn(f"{p}.0.vn2", d, d // 2)
            + [(f"{p}.0.vn_lin.weight", (3, d // 2), "weight")]
            + _conv(f"{p}.1", (2 * d, 3 * d, 1)) + _conv(f"{p}.3", (d, 2 * d, 1))
            + _conv(f"{p}.5", (1, d, 1)))


def _decoder(p: str, d: int) -> list:
    return (_vn(f"{p}.decoder_blocks.1.mlp", 6 * d, 2 * d)
            + _vn(f"{p}.decoder_blocks.3.mlp", 3 * d, d))


ENCODER = ((1, 1, False), (1, 1, True), (1, 2, False), (2, 2, True),
           (2, 4, False))        # (in, out) in units of d; strided
MINISPIN = (64, 64, 128, 128, 64, 64, 32, 32)
COSTNET = ((32, 32, (3, 3, 3)), (32, 64, (3, 3, 3)), (64, 64, (3, 1, 3)),
           (64, 128, (3, 1, 3)), (128, 128, (3, 1, 3)), (128, 64, (3, 1, 3)),
           (64, 64, (3, 1, 3)), (64, 32, (3, 1, 3)), (32, 32, (3, 1, 3)))


def parameter_layout(s: SimpleNamespace) -> list:
    """(name, shape, kind) of every tensor of the model's state dict, in
    the authors' order.  ``weight``: a convolution's or linear map's
    weight; ``bias``: its bias; ``one``, ``zero``: batch-norm affine terms
    and running statistics at their initial values; ``count``: a batch
    norm's step counter; ``eps``: the unused learnable epsilon (-5)."""
    d = s.point.first_feats_dim // 3
    azi = s.patch.azi_n
    ref = [("Ref.epsilon", (), "eps")] + _decoder("Ref", d)
    for i, (a, b, strided) in enumerate(ENCODER):
        p = f"Ref.encoder_blocks.{i}"
        if i == 0:
            ref += _vn(f"{p}.conv", 4, d)
        else:
            ref += (_vn(f"{p}.conv", a * d + 1, b * d // 2)
                    + _vn(f"{p}.unary", b * d // 2, b * d)
                    + _vn(f"{p}.unary_shortcut", a * d, b * d))
    ref += (_vn("Ref.fc_layer.0", d, d // 2) + _vn("Ref.fc_layer.1", d // 2, 1)
            + _head("Ref.inv_layer", d))
    desc = (_conv("Desc.pnt_layer.0", (16, 3, 1, 1)) + _bn("Desc.pnt_layer.1", 16, True)
            + _conv("Desc.pool_layer.0", (16, 32, 1, 1))
            + _bn("Desc.pool_layer.1", 16, True)
            + _conv("Desc.pool_layer.3", (1, 16, 1, 1)) + _bn("Desc.pool_layer.4", 1, True))
    cin = 16
    for i, cout in enumerate(MINISPIN):
        shape = (cout, cin, 3, 3, 3) if i == 0 else (cout, cin, 3, 3)
        desc += _conv(f"Desc.conv_net.ops.{3 * i}", shape)
        if i < len(MINISPIN) - 1:
            desc += _bn(f"Desc.conv_net.ops.{3 * i + 1}", cout, False)
        cin = cout
    keypt = ([("Keypt.epsilon", (), "eps")] + _decoder("Keypt", d)
             + _head("Keypt.invar_layer", d))
    inlier = []
    for i, (a, b, k) in enumerate(COSTNET):
        inlier += (_conv(f"Inlier.conv.ops.{3 * i}", (b, a) + k)
                   + _bn(f"Inlier.conv.ops.{3 * i + 1}", b, False))
    inlier += _conv(f"Inlier.conv.ops.{3 * len(COSTNET)}", (azi, 32, 2, 1, 2))
    return ref + desc + keypt + inlier


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


class Net:
    """The weights by name, in the reference's dtype on its device."""

    def __init__(self, state: dict, dtype, device):
        self.w = {k: v.to(device=device, dtype=dtype) if v.is_floating_point()
                  else v.to(device) for k, v in state.items()}

    def __getitem__(self, k):
        return self.w[k]

    def bn(self, p: str, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Eval-mode batch norm of channel axis ``axis``."""
        shape = [1] * x.dim()
        shape[axis] = -1
        g = lambda n: self.w[f"{p}.{n}"].reshape(shape)
        y = (x - g("running_mean")) / torch.sqrt(g("running_var") + BN_EPS)
        if f"{p}.weight" in self.w:
            y = y * g("weight") + g("bias")
        return y


def vn_layer(net: Net, p: str, x: torch.Tensor, slope: float = 0.2):
    """VNLinearLeakyReLU on vector features x [..., C, 3]: a linear map of
    the channels, a batch norm of the vector lengths (none for one
    channel), and the leaky ReLU that removes the part of a feature
    pointing against its learned direction."""
    feat = torch.einsum("oc,...cv->...ov", net[f"{p}.map_to_feat.weight"], x)
    dirs = torch.einsum("oc,...cv->...ov", net[f"{p}.map_to_dir.weight"], x)
    if feat.shape[-2] > 1:
        length = torch.linalg.vector_norm(feat, dim=-1) + VN_EPS
        feat = feat * (net.bn(f"{p}.batchnorm.bn", length, -1) / length)[..., None]
    along = (feat * dirs).sum(-1, keepdim=True)
    against = torch.where(along < 0, along / ((dirs * dirs).sum(-1, keepdim=True)
                                              + VN_EPS), torch.zeros_like(along))
    return feat - (1.0 - slope) * against * dirs


def invariant_head(net: Net, p: str, x: torch.Tensor, mask: torch.Tensor,
                   act: str) -> torch.Tensor:
    """VNStdFeature (learned frame; the features in it are invariant), then
    three 1x1 convolutions with instance norms over both clouds' valid
    points between them.  x [2, N, C, 3] -> [2, N]."""
    z = vn_layer(net, f"{p}.0.vn2", vn_layer(net, f"{p}.0.vn1", x, 0.0), 0.0)
    frame = torch.einsum("kc,...cv->...kv", net[f"{p}.0.vn_lin.weight"], z)
    h = torch.einsum("...cv,...kv->...ck", x, frame).flatten(-2)
    m = mask.to(h.dtype)[..., None]

    def inorm(t):
        n = m.sum().clamp(min=1.0)
        mean = (t * m).sum((0, 1)) / n
        var = (((t - mean) ** 2) * m).sum((0, 1)) / n
        return (t - mean) / torch.sqrt(var + BN_EPS)

    lin = lambda i, t: t @ net[f"{p}.{i}.weight"][..., 0].t() + net[f"{p}.{i}.bias"]
    y = lin(5, inorm(lin(3, inorm(lin(1, h)))))[..., 0]
    return torch.sigmoid(y) if act == "sigmoid" else F.softplus(y)


def gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, N, ...] at idx [B, ...] -> [B, ..., ...]."""
    b = torch.arange(t.shape[0], device=t.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return t[b, idx.long()]


# --------------------------------------------------------------------------
# the pyramid
# --------------------------------------------------------------------------


def exact_knn(query, support, s_valid, k: int, radius, chunk: int = 2048):
    """The k nearest valid support points within ``radius`` (None: any),
    nearest first: (d2, idx, valid), idx 0 where not valid."""
    out = []
    sup = support.double()
    for q0 in range(0, query.shape[1], chunk):
        q = query[:, q0:q0 + chunk].double()
        d2 = ((q[:, :, None, :] - sup[:, None, :, :]) ** 2).sum(-1)
        bad = ~s_valid[:, None, :]
        if radius is not None:
            bad = bad | (d2 > radius * radius)
        d2 = d2.masked_fill(bad, math.inf)
        if d2.shape[-1] < k:
            d2 = F.pad(d2, (0, k - d2.shape[-1]), value=math.inf)
        out.append(torch.topk(d2, k, dim=-1, largest=False, sorted=True))
    d = torch.cat([o[0] for o in out], 1)
    i = torch.cat([o[1] for o in out], 1)
    ok = torch.isfinite(d)
    return d, torch.where(ok, i, torch.zeros_like(i)), ok


def knn(s, query, support, s_valid, q_valid, k: int, radius):
    """The pyramid's neighbour search: the rank-banded search where the
    configuration's band restricts it (or its window covers the support),
    else the exact one."""
    band, S = s.static.knn_band, support.shape[1]
    if band and kknn.banded_supported(S):
        rows, covers = kknn.banded_win_rows(S, band)
        if 2 * band < S or covers:
            return kknn.banded_knn_plain(query, support, s_valid, q_valid, k,
                                         radius, rows)
    if band and 2 * band < S:
        raise NotImplementedError("a band past the banded kernel's reach")
    return exact_knn(query, support, s_valid, k, radius)


def nearest(s, query, support, s_valid, q_valid):
    band, S = s.static.knn_band, support.shape[1]
    if band and 2 * band < S:
        if not kknn.banded_supported(S):
            raise NotImplementedError("a band past the banded kernel's reach")
        return kknn.banded_nn1_plain(query, support, s_valid, q_valid)
    return kgeom.nearest_plain(query, support, s_valid)


def pca_normals(pts, mask, idx, valid, dtype):
    """The eigenvector of the smallest eigenvalue of each neighbourhood's
    covariance, turned toward the origin (the sensor); 0 where invalid."""
    nb = gather(pts, torch.where(valid, idx, torch.zeros_like(idx))).to(dtype)
    w = valid.to(dtype)[..., None]
    mean = (nb * w).sum(2) / w.sum(2).clamp(min=1.0)
    c = (nb - mean[:, :, None]) * w
    cov = c.transpose(-1, -2) @ c
    # on the host: the card's batched solver refuses batches this large
    n = torch.linalg.eigh(cov.double().cpu())[1][..., 0].to(pts.device, dtype)
    n = torch.where(((n * pts.to(dtype)).sum(-1) > 0)[..., None], -n, n)
    return torch.where(mask[..., None], n, torch.zeros_like(n))


def pyramid(s, sds, sds_mask, lvl1, lvl1_mask, lvl2, lvl2_mask, dtype):
    """Points, masks, neighbour and pooling tables and upsampling indices
    of the three levels, and the input normals; radii r_l = voxel_size_0 x
    conv_radius x 2^l, upsampling within 2 r_l."""
    st = s.static
    r0 = s.data.voxel_size_0 * s.point.conv_radius
    pts, msk = (sds, lvl1, lvl2), (sds_mask, lvl1_mask, lvl2_mask)
    k0 = max(st.normal_knn, st.neighbor_caps[0])
    d2, idx, v = knn(s, sds, sds, sds_mask, sds_mask, k0, None)
    nk, kc = st.normal_knn, st.neighbor_caps[0]
    normals = pca_normals(sds, sds_mask, idx[..., :nk], v[..., :nk], dtype)
    nbr = [(idx[..., :kc], v[..., :kc] & (d2[..., :kc] <= r0 * r0)
            & sds_mask[..., None])]
    for lvl in (1, 2):
        _, i, ok = knn(s, pts[lvl], pts[lvl], msk[lvl], msk[lvl],
                       st.neighbor_caps[lvl], r0 * 2 ** lvl)
        nbr.append((i, ok & msk[lvl][..., None]))
    pool, up = [], []
    for lvl in (0, 1):
        r = r0 * 2 ** lvl
        _, i, ok = knn(s, pts[lvl + 1], pts[lvl], msk[lvl], msk[lvl + 1],
                       st.pool_caps[lvl], r)
        pool.append((i, ok & msk[lvl + 1][..., None]))
        ud2, ui = nearest(s, pts[lvl], pts[lvl + 1], msk[lvl + 1], msk[lvl])
        up.append((ui, (ud2 <= (2 * r) ** 2) & msk[lvl]))
    return SimpleNamespace(pts=[p.to(dtype) for p in pts], masks=msk, nbr=nbr,
                           pool=pool, up=up, normals=normals)


# --------------------------------------------------------------------------
# EFCNN and DetNet
# --------------------------------------------------------------------------


def neighbourhood(x, q_pts, s_pts, idx, valid, scale: float):
    """Neighbour features [2, Q, K, C, 3] and offsets [2, Q, K, 3] from the
    query, both 0 in slots that hold no neighbour."""
    w = valid.to(x.dtype)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    feats = gather(x, idx) * w[..., None, None]
    offs = (gather(s_pts, idx) - q_pts[:, :, None]) / scale * w[..., None]
    return feats, offs


def encoder_block(net, i: int, x, pyr, q: int, sl: int, scale: float):
    """Encoder block ``i`` from support level ``sl`` to query level ``q``
    (a strided block reads the pooling table)."""
    p = f"Ref.encoder_blocks.{i}"
    idx, valid = pyr.nbr[sl] if q == sl else pyr.pool[sl]
    feats, offs = neighbourhood(x, pyr.pts[q], pyr.pts[sl], idx, valid, scale)
    if i == 0:
        parts = [feats, offs[..., None, :],
                 torch.cross(feats[..., 0, :], offs, dim=-1)[..., None, :],
                 offs.mean(2, keepdim=True).expand_as(offs)[..., None, :]]
        return vn_layer(net, f"{p}.conv", torch.cat(parts, -2)).mean(2)
    h = vn_layer(net, f"{p}.conv", torch.cat([feats, offs[..., None, :]], -2))
    h = vn_layer(net, f"{p}.unary", h.mean(2))
    short = feats.amax(2) if q != sl else x
    return h + vn_layer(net, f"{p}.unary_shortcut", short)


def decode(net, p: str, bottle, skips, pyr):
    x = bottle
    for lvl, blk in ((1, 1), (0, 3)):
        idx, ok = pyr.up[lvl]
        x = gather(x, idx) * ok.to(x.dtype)[..., None, None]
        x = vn_layer(net, f"{p}.decoder_blocks.{blk}.mlp",
                     torch.cat([x, skips[lvl]], -2))
    return x


def axes_and_saliency(net, s, pyr):
    """EFCNN's reference axes, turned away from the sensor side and made
    unit, and DetNet's saliency on its bottleneck and skips."""
    sc = s.test.scale
    x0 = encoder_block(net, 0, pyr.normals[..., None, :], pyr, 0, 0, sc)
    x1 = encoder_block(net, 2, encoder_block(net, 1, x0, pyr, 1, 0, sc),
                       pyr, 1, 1, sc)
    x2 = encoder_block(net, 4, encoder_block(net, 3, x1, pyr, 2, 1, sc),
                       pyr, 2, 2, sc)
    h = decode(net, "Ref", x2, (x0, x1), pyr)
    axis = vn_layer(net, "Ref.fc_layer.1", vn_layer(net, "Ref.fc_layer.0", h))[..., 0, :]
    length = torch.linalg.vector_norm(axis, dim=-1, keepdim=True).clamp(min=1e-12)
    axis = axis / length
    axis = torch.where(((axis * pyr.pts[0]).sum(-1) > 0)[..., None], -axis, axis)
    score = invariant_head(net, "Keypt.invar_layer",
                           decode(net, "Keypt", x2, (x0, x1), pyr),
                           pyr.masks[0], "softplus")
    return axis, score


# --------------------------------------------------------------------------
# MiniSpinNet
# --------------------------------------------------------------------------


def to_z(axis: torch.Tensor) -> torch.Tensor:
    """R [K, 3, 3] with ``axis @ R`` = +z: the transpose of the rotation
    about axis x z that takes the unit ``axis`` to z."""
    z = torch.zeros_like(axis)
    z[:, 2] = 1.0
    k = torch.cross(axis, z, dim=-1)
    sin = torch.linalg.vector_norm(k, dim=-1)
    cos = axis[:, 2]
    k = k / sin.clamp(min=1e-12)[:, None]
    K = torch.zeros(axis.shape[0], 3, 3, dtype=axis.dtype, device=axis.device)
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(1, 2)
    ang = torch.atan2(sin, cos)[:, None, None]
    rot = torch.eye(3, dtype=axis.dtype, device=axis.device) \
        + torch.sin(ang) * K + (1 - torch.cos(ang)) * (K @ K)
    return rot.transpose(1, 2)


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    c, s_ = torch.cos(angle), torch.sin(angle)
    R = torch.zeros(angle.shape + (3, 3), dtype=angle.dtype, device=angle.device)
    R[..., 0, 0], R[..., 0, 1], R[..., 1, 0], R[..., 1, 1] = c, -s_, s_, c
    R[..., 2, 2] = 1.0
    return R


def point_mlp_columns(net: Net, azi_n: int):
    """The point MLP (1x1 convolution, batch norm) as one affine map per
    azimuth bin, each sample first turned back by its bin's angle: (W
    [azi_n, 3, 16], b [16], relu(b), the feature of an empty slot)."""
    W = net["Desc.pnt_layer.0.weight"][:, :, 0, 0]                  # [16, 3]
    g = net["Desc.pnt_layer.1.weight"] / torch.sqrt(
        net["Desc.pnt_layer.1.running_var"] + BN_EPS)
    b = (net["Desc.pnt_layer.0.bias"] - net["Desc.pnt_layer.1.running_mean"]) \
        * g + net["Desc.pnt_layer.1.bias"]
    back = rot_z(-2 * math.pi / azi_n * torch.arange(
        azi_n, dtype=W.dtype, device=W.device))                     # [azi, 3, 3]
    cols = torch.einsum("oc,acd->ado", W * g[:, None], back)        # x -> W g back x
    return cols, b, torch.relu(b)


def cylinder_pad(x: torch.Tensor) -> torch.Tensor:
    """One cell around azimuth (wrapping) and elevation (zeros)."""
    x = torch.cat([x[..., -1:], x, x[..., :1]], -1)
    return F.pad(x, (0, 0, 1, 1))


def minispinnet(net: Net, pooled: torch.Tensor, chunk: int = 512):
    """pooled [M, rad, ele, azi, 16] -> (descriptors [M, 32] unit,
    equivariant maps [M, ele, azi, 32] unit along channels)."""
    descs, equis = [], []
    n = len(MINISPIN)
    for c0 in range(0, pooled.shape[0], chunk):
        x = pooled[c0:c0 + chunk].permute(0, 4, 1, 2, 3)
        for i in range(n):
            p = f"Desc.conv_net.ops.{3 * i}"
            conv = F.conv3d if i == 0 else F.conv2d
            x = conv(cylinder_pad(x), net[f"{p}.weight"], net[f"{p}.bias"])
            if i == 0:
                x = x[:, :, 0]
            if i < n - 1:
                x = torch.relu(net.bn(f"Desc.conv_net.ops.{3 * i + 1}", x, 1))
        h = torch.relu(net.bn("Desc.pool_layer.1", F.conv2d(
            x, net["Desc.pool_layer.0.weight"], net["Desc.pool_layer.0.bias"]), 1))
        att = torch.relu(net.bn("Desc.pool_layer.4", F.conv2d(
            h, net["Desc.pool_layer.3.weight"], net["Desc.pool_layer.3.bias"]), 1))
        f = (x * att).mean((2, 3))
        descs.append(f / torch.linalg.vector_norm(f, dim=1, keepdim=True).clamp(min=1e-12))
        e = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)
        equis.append(e.permute(0, 2, 3, 1))
    return torch.cat(descs), torch.cat(equis)


def describe(net, s, draws, raw, raw_mask, kpts, kaxes, dtype):
    """Both clouds' keypoints described in one batch: patches (ball
    sampling), alignment of each keypoint's axis to z (3DMatch family; the
    identity otherwise), the SPT's winners with the point MLP, and
    MiniSpinNet.  Returns (desc [2K, 32], equi [2K, ele, azi, 32],
    R [2K, 3, 3])."""
    p = s.patch
    K = kpts.shape[1]
    if s.data.dataset in ("3DMatch", "3DLoMatch"):
        R = to_z(kaxes.reshape(2 * K, 3))
    else:
        R = torch.eye(3, dtype=dtype, device=kpts.device).expand(2 * K, 3, 3)
    x, y, z, ok = kgeom.ball_sample_planes_plain(
        kpts, raw, raw_mask, draws.ball_prio, float(p.des_r),
        p.num_points_per_patch)
    S = x.shape[-1]
    keep = ok & (torch.arange(S, device=x.device) != S - 1)
    planes = tuple(((torch.where(keep, c, kpts[..., d:d + 1]) - kpts[..., d:d + 1])
                    / p.des_r).reshape(2 * K, S) for d, c in enumerate((x, y, z)))
    cols, b, empty = point_mlp_columns(net, p.azi_n)
    pooled = kgeom.spt_pooled_plain(
        cols.float(), b.float(), empty.float(), draws.spt_prio, planes,
        R.float(), p.rad_n, p.azi_n, p.ele_n, p.delta / p.rad_n,
        p.voxel_sample)
    desc, equi = minispinnet(net, pooled.to(dtype))
    return desc, equi, R


# --------------------------------------------------------------------------
# matching, the cost volume, voting, RANSAC and IRLS
# --------------------------------------------------------------------------


def mutual(s_des, t_des, s_ok, t_ok):
    """Each source keypoint's most similar target keypoint, and whether the
    choice is mutual (both valid)."""
    sim = (s_des @ t_des.t()).masked_fill(~(s_ok[:, None] & t_ok[None, :]),
                                          -math.inf)
    fwd, back = sim.argmax(1), sim.argmax(0)
    ar = torch.arange(sim.shape[0], device=sim.device)
    return fwd, (back[fwd] == ar) & s_ok & t_ok[fwd]


def azimuths(net: Net, s, s_equi, t_equi, chunk: int = 256):
    """The cost volume (every azimuth shift of the source map less the
    target's, on the elevation band without its two end rings), CostNet,
    and the expected azimuth bin under its softmax."""
    azi, ele = s.patch.azi_n, s.patch.ele_n
    bins = torch.arange(azi, dtype=s_equi.dtype, device=s_equi.device)
    out = []
    for c0 in range(0, s_equi.shape[0], chunk):
        a = s_equi[c0:c0 + chunk, 1:ele - 1]
        b = t_equi[c0:c0 + chunk, 1:ele - 1]
        vol = torch.stack([a.roll(i, dims=2) - b for i in range(azi)], 1)
        x = vol.permute(0, 4, 1, 2, 3)                     # [M, C, shift, ele, azi]
        for i in range(len(COSTNET) + 1):
            p = f"Inlier.conv.ops.{3 * i}"
            x = F.conv3d(x, net[f"{p}.weight"], net[f"{p}.bias"])
            if i < len(COSTNET):
                x = torch.relu(net.bn(f"Inlier.conv.ops.{3 * i + 1}", x, 1))
        out.append((torch.softmax(x.reshape(x.shape[0], azi), -1) * bins).sum(-1))
    return torch.cat(out)


def residual2(R, t, src, tgt):
    """|R_h src_m + t_h - tgt_m|^2 [H, M]."""
    return ((torch.einsum("hij,mj->hmi", R, src) + t[:, None] - tgt) ** 2).sum(-1)


def horn(A, B, w=None):
    """Weighted rigid fit B ~ R A + t by Horn's quaternion method: the
    quaternion is the dominant eigenvector of the 4x4 matrix of the
    cross-covariance, taken by HORN_ITERS steps of shifted power iteration
    from (1, 1, 1, 1).  A, B [H, N, 3], w [H, N] -> [H, 4, 4]."""
    if w is None:
        w = torch.ones(A.shape[:2], dtype=A.dtype, device=A.device)
    ws = w.sum(1)[:, None] + HORN_EPS
    ca = (A * w[..., None]).sum(1) / ws
    cb = (B * w[..., None]).sum(1) / ws
    M = torch.einsum("hn,hni,hnj->hij", w, A - ca[:, None], B - cb[:, None])
    tr = M[:, 0, 0] + M[:, 1, 1] + M[:, 2, 2]
    delta = torch.stack([M[:, 1, 2] - M[:, 2, 1], M[:, 2, 0] - M[:, 0, 2],
                         M[:, 0, 1] - M[:, 1, 0]], -1)
    N = torch.zeros(A.shape[0], 4, 4, dtype=A.dtype, device=A.device)
    N[:, 0, 0] = tr
    N[:, 0, 1:] = delta
    N[:, 1:, 0] = delta
    eye3 = torch.eye(3, dtype=A.dtype, device=A.device)
    N[:, 1:, 1:] = M + M.transpose(1, 2) - tr[:, None, None] * eye3
    shift = 2 * torch.sqrt((M * M).sum((1, 2)) + HORN_EPS)
    N = N + shift[:, None, None] * torch.eye(4, dtype=A.dtype, device=A.device)
    q = torch.ones(A.shape[0], 4, dtype=A.dtype, device=A.device)
    for _ in range(HORN_ITERS):
        q = torch.einsum("hij,hj->hi", N, q)
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp(min=HORN_EPS)
    w0, x, y, z = q.unbind(1)
    R = torch.stack([
        torch.stack([w0 * w0 + x * x - y * y - z * z, 2 * (x * y - w0 * z),
                     2 * (x * z + w0 * y)], -1),
        torch.stack([2 * (x * y + w0 * z), w0 * w0 - x * x + y * y - z * z,
                     2 * (y * z - w0 * x)], -1),
        torch.stack([2 * (x * z - w0 * y), 2 * (y * z + w0 * x),
                     w0 * w0 - x * x - y * y + z * z], -1)], 1)
    T = torch.zeros(A.shape[0], 4, 4, dtype=A.dtype, device=A.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = cb - torch.einsum("hij,hj->hi", R, ca)
    T[:, 3, 3] = 1.0
    return T


def vote(s, src, tgt, R_s, R_t, ind, mutual_ok):
    """One hypothesis a match (R = R_t Rz(bin angle) R_s^T, t = tgt - R
    src), each scored by the mutual matches it carries within the lever-arm
    threshold |src| pi/azi_n inlier_th; the first best hypothesis's
    inliers."""
    azi = s.patch.azi_n
    R = R_t @ rot_z(ind * (2 * math.pi / azi) + 1e-6) @ R_s.transpose(1, 2)
    t = tgt - torch.einsum("hij,hj->hi", R, src)
    lim = torch.linalg.vector_norm(src, dim=-1) * (math.pi / azi) * s.match.inlier_th
    hit = (residual2(R, t, src, tgt) < lim * lim) & mutual_ok
    score = torch.where(mutual_ok, hit.sum(1), torch.full_like(hit.sum(1), -1))
    return hit[score.argmax()]


def ransac(s, gumbel, src, tgt, ok):
    """Triplets drawn over the ``ok`` matches by the Gumbel noise, each
    fitted, kept if its edges agree within similar_th and it fits its own
    points within dist_th, scored by the ``ok`` matches within dist_th;
    the first best is refitted on its inliers.  Identity with fewer than 3
    matches or no kept triplet.  Returns (pose, inliers)."""
    dist, sim = s.match.dist_th, s.match.similar_th
    pick = (gumbel + torch.where(ok, 0.0, -math.inf).to(gumbel.dtype)).argmax(-1)
    a, b = src[pick], tgt[pick]                                   # [H, 3, 3]
    T = horn(a, b)
    R, t = T[:, :3, :3], T[:, :3, 3]
    ea = torch.linalg.vector_norm(a - a.roll(1, 1), dim=-1)
    eb = torch.linalg.vector_norm(b - b.roll(1, 1), dim=-1)
    kept = ((ea > sim * eb) & (eb > sim * ea)).all(-1)
    fit = torch.einsum("hij,hnj->hni", R, a) + t[:, None] - b
    kept = kept & (torch.linalg.vector_norm(fit, dim=-1) < dist).all(-1)
    inl = (residual2(R, t, src, tgt) < dist * dist) & ok
    score = torch.where(kept, inl.sum(1), torch.full_like(inl.sum(1), -1))
    best = score.argmax()
    inliers = inl[best]
    eye = torch.eye(4, dtype=src.dtype, device=src.device)
    if int(ok.sum()) < 3 or int(score[best]) <= 0:
        return eye, torch.zeros_like(inliers)
    if int(inliers.sum()) >= 3:
        return horn(src[None], tgt[None], inliers.to(src.dtype)[None])[0], inliers
    return T[best], inliers


def irls(pose, src, tgt, ok, th: float, iters: int):
    """``iters`` rounds: the matches within ``th`` of the current pose,
    weighted 1 / (1 + (d / th)^2), refit; a round with fewer than 3 keeps
    the pose."""
    for _ in range(iters):
        d = torch.linalg.vector_norm(src @ pose[:3, :3].t() + pose[:3, 3] - tgt,
                                     dim=-1)
        inl = (d < th) & ok
        if int(inl.sum()) >= 3:
            w = inl.to(src.dtype) / (1 + (d / th) ** 2)
            pose = horn(src[None], tgt[None], w[None])[0]
    return pose


# --------------------------------------------------------------------------
# one pair
# --------------------------------------------------------------------------


@contextlib.contextmanager
def _tf32(on: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class Reference:
    """BUFFER with the benchmark's weights on ``device``."""

    def __init__(self, conf: dict, state: dict, device, precision: str = "fp64"):
        if precision not in ("fp64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.s = settings(conf)
        self.dev = torch.device(device)
        self.precision = precision
        self.dtype = torch.float64 if precision == "fp64" else torch.float32
        self.net = Net(state, self.dtype, self.dev)

    def register(self, prepared: dict, draws: Draws) -> dict:
        """prepared: the pair's padded arrays (numpy, float32 points and
        bool masks) -> {pose, num_mutual, num_inliers, kpts, kpt_valid}."""
        with torch.no_grad(), _tf32(self.precision == "tf32"):
            return self._register(prepared, draws)

    def _register(self, prepared, draws):
        s, dt, net = self.s, self.dtype, self.net
        a = {k: torch.as_tensor(v).to(self.dev) for k, v in prepared.items()}
        pyr = pyramid(s, a["sds"], a["sds_mask"], a["lvl1"], a["lvl1_mask"],
                      a["lvl2"], a["lvl2_mask"], dt)
        axis, score = axes_and_saliency(net, s, pyr)
        eligible = a["sds_mask"] & (score > s.point.keypts_th)
        K = s.point.num_keypts
        kidx = kfps.fps_plain(a["sds"], eligible, K)
        kvalid = torch.arange(K, device=self.dev)[None] < eligible.sum(1)[:, None]
        kpts = gather(a["sds"], kidx)                              # float32
        desc, equi, R = describe(net, s, draws, a["raw"], a["raw_mask"],
                                 kpts, gather(axis, kidx), dt)
        fwd, ok = mutual(desc[:K], desc[K:], kvalid[0], kvalid[1])
        src, tgt = kpts[0].to(dt), kpts[1].to(dt)[fwd]
        ind = azimuths(net, s, equi[:K], equi[K:][fwd])
        voted = vote(s, src, tgt, R[:K], R[K:][fwd], ind, ok)
        boost = s.static.low_match_boost and int(ok.sum()) < s.static.low_match_th
        gumbel = draws.ransac_gumbel_boost if boost else draws.ransac_gumbel
        pose, inliers = ransac(s, gumbel.to(self.dev), src, tgt, voted)
        if s.test.pose_refine:
            th = 1.2 if s.data.dataset == "KITTI" else 0.10
            iters = s.static.refine_iters * (2 if boost else 1)
            pose = irls(pose, src, tgt, ok, th, iters)
        return {"pose": pose.cpu(), "num_mutual": ok.sum().cpu(),
                "num_inliers": inliers.sum().cpu(), "kpts": kpts.cpu(),
                "kpt_valid": kvalid.cpu()}
