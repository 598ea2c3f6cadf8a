"""PCA surface normals (counterpart of ``buffer_tpu/ops/normals.py``).

:func:`smallest_eigvec_sym3` is the reference's closed-form (Cardano)
symmetric 3x3 eigensolver, kept instead of ``torch.linalg.eigh`` so the
eigenvector's sign and rounding follow the reference; it also gives the
patch z-axis of :func:`cal_z_axis`."""

from __future__ import annotations

import math
from typing import Optional

import torch

from buffer_tpu_torch.core.numerics import safe_norm
from buffer_tpu_torch.ops.neighbors import gather_rows, radius_knn

EPS = 1e-12


def _det3(B: torch.Tensor) -> torch.Tensor:
    return (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))


def smallest_eigvec_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3]:
    trigonometric eigenvalues, then the largest row of
    (A - lam1 I)(A - lam2 I); +z for a degenerate matrix."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    A01, A02, A12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = A01 ** 2 + A02 ** 2 + A12 ** 2
    d0 = A[..., 0, 0] - q
    d1 = A[..., 1, 1] - q
    d2 = A[..., 2, 2] - q
    p2 = d0 ** 2 + d1 ** 2 + d2 ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=EPS))
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = (A - q[..., None, None] * eye) / p[..., None, None]
    r = _det3(B) / 2.0
    phi = torch.arccos(torch.clamp(r, -1.0, 1.0)) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    M = (A - lam1[..., None, None] * eye) @ (A - lam2[..., None, None] * eye)
    norms = torch.sum(M * M, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(M, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    n = safe_norm(v, dim=-1, keepdim=True)
    fallback = eye[2].expand(v.shape)
    return torch.where(n > 1e-10, v / torch.clamp(n, min=EPS), fallback)


def estimate_normals(points: torch.Tensor, valid: torch.Tensor, knn: int = 30,
                     chunk: int = 4096,
                     viewpoint: Optional[torch.Tensor] = None) -> torch.Tensor:
    """kNN-PCA normals oriented toward ``viewpoint`` (default: the origin,
    Open3D's ``orient_normals_towards_camera_location()``): the exact dense
    :func:`~buffer_tpu_torch.ops.neighbors.radius_knn` with no radius, then
    :func:`normals_from_neighbors`.  points [N, 3] or [B, N, 3], valid
    [N] or [B, N] -> normals of the same shape (zeros for invalid)."""
    single = points.dim() == 2
    if single:
        points, valid = points[None], valid[None]
    _, idx, nvalid = radius_knn(points, points, valid, k=knn, radius=None,
                                query_chunk=chunk)
    n = normals_from_neighbors(points, valid, idx, nvalid, viewpoint)
    return n[0] if single else n


def normals_from_neighbors(points: torch.Tensor, valid: torch.Tensor,
                           idx: torch.Tensor, nvalid: torch.Tensor,
                           viewpoint: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """PCA normals from kNN tables, oriented toward ``viewpoint`` [3]
    (default: the origin; Open3D's estimate_normals +
    orient_normals_towards_camera_location()).

    points [B, N, 3], valid [B, N], idx/nvalid [B, N, k] -> [B, N, 3]
    (zeros for invalid points)."""
    nbrs = gather_rows(points, idx)                      # [B, N, k, 3]
    w = nvalid.to(points.dtype)[..., None]
    cnt = torch.clamp(torch.sum(w, dim=-2), min=1.0)
    mean = torch.sum(nbrs * w, dim=-2) / cnt
    centered = (nbrs - mean[..., None, :]) * w
    cov = centered.transpose(-1, -2) @ centered          # [B, N, 3, 3]
    n = smallest_eigvec_sym3(cov)
    vp = 0.0 if viewpoint is None else viewpoint
    flip = torch.sum(n * (vp - points), dim=-1) < 0
    n = torch.where(flip[..., None], -n, n)
    return torch.where(valid[..., None], n, torch.zeros_like(n))


def cal_z_axis(local_cor: torch.Tensor, ref_point: torch.Tensor) -> torch.Tensor:
    """Patch z-axis (``buffer_tpu/ops/normals.py:233-247``; reference
    utils/common.py:709-726): the smallest principal direction of the
    *uncentred* covariance of local_cor [B, N, 3], flipped where
    ``sum(-z * ref_point) < 0`` (ref_point [B, 3]).  Returns [B, 3]."""
    cov = local_cor.transpose(-1, -2) @ local_cor        # [B, 3, 3]
    z = smallest_eigvec_sym3(cov)
    flip = torch.sum(-z * ref_point, dim=-1) < 0
    return torch.where(flip[:, None], -z, z)
