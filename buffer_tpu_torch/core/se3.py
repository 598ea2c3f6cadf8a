"""SE(3) utilities (counterpart of ``buffer_tpu/core/se3.py``).

Batched over leading dimensions.  The 3x3/4x4 products are tiny, so they
run in plain fp32 matmuls (TF32 stays off on the registration path)."""

from __future__ import annotations

import math

import torch

from buffer_tpu_torch.core.numerics import safe_norm, safe_normalize

EPS = 1e-8
# kabsch_quat's regulariser and power steps (the reference's; the CUDA
# solver in kernels/pose_cuda.py takes the same)
KABSCH_EPS = 1e-6
KABSCH_ITERS = 60


def transform(pts: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """``R @ p + t`` for pts [..., N, 3] and trans [..., 4, 4]."""
    R = trans[..., :3, :3]
    t = trans[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def decompose_trans(trans: torch.Tensor):
    """Split [..., 4, 4] into (R [..., 3, 3], t [..., 3, 1])
    (utils/SE3.py:59-71)."""
    return trans[..., :3, :3], trans[..., :3, 3:4]


def integrate_trans(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] from R [..., 3, 3] and t [..., 3] or [..., 3, 1]."""
    t = t.reshape(R.shape[:-2] + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype,
                       device=R.device)[3].expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def concatenate(trans1: torch.Tensor, trans2: torch.Tensor) -> torch.Tensor:
    """The composition ``trans1 @ trans2`` of two SE(3) transforms
    (utils/SE3.py:98-112)."""
    return trans1 @ trans2


def inverse(trans: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse: (R^T, -R^T t)."""
    R, t = decompose_trans(trans)
    Rt = R.transpose(-1, -2)
    return integrate_trans(Rt, -(Rt @ t))


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def angle_axis_to_rotation_matrix(angle_axis: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map [..., 3] -> [..., 3, 3] (kornia's
    convention)."""
    theta = safe_norm(angle_axis, dim=-1, keepdim=True)
    axis = angle_axis / torch.clamp(theta, min=EPS)
    k = _skew(axis)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = _eye_like(angle_axis, angle_axis.shape[:-1] + (3, 3))
    return eye + s * k + (1.0 - c) * (k @ k)


def rodrigues_a_to_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotations aligning ``a`` [B, 3] to ``b`` [B, 3], TRANSPOSED, as the
    reference's ``RodsRotatFormula`` returns them (``p @ R`` maps the
    a-frame to the b-frame)."""
    c = torch.cross(a, b, dim=-1)
    cos = torch.sum(a * b, dim=-1) / torch.clamp(
        safe_norm(a, dim=-1) * safe_norm(b, dim=-1), min=EPS)
    theta = torch.arccos(torch.clamp(cos, -1.0, 1.0))[:, None, None]
    c = safe_normalize(c, dim=-1, eps=EPS)
    k = _skew(c)
    eye = _eye_like(a, k.shape)
    R = eye + torch.sin(theta) * k + (1.0 - torch.cos(theta)) * (k @ k)
    return R.transpose(-1, -2)


def angles_to_rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Euler composition Rz @ Ry @ Rx of ``angles`` [..., 3]."""
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one = torch.ones_like(ax)
    zero = torch.zeros_like(ax)
    Rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cx, -sx], -1),
                      torch.stack([zero, sx, cx], -1)], -2)
    Ry = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    Rz = torch.stack([torch.stack([cz, -sz, zero], -1),
                      torch.stack([sz, cz, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return (Rz @ Ry) @ Rx


def random_rotation(u: torch.Tensor, num_axis: int,
                    augment_rotation: float = 1.0) -> torch.Tensor:
    """SO(3) (num_axis=3) or about-z (num_axis=1) rotation from the uniform
    draws ``u`` [3] in [0, 1) (utils/SE3.py:5-30: angles uniform in
    [0, 2pi*aug])."""
    angles = u * 2 * math.pi * augment_rotation
    if num_axis == 0:
        return torch.eye(3, dtype=u.dtype, device=u.device)
    if num_axis == 1:
        mask = torch.eye(3, dtype=u.dtype, device=u.device)[2]
        return angles_to_rotation_matrix(angles * mask)
    zero = torch.zeros_like(angles[0])
    Rx = angles_to_rotation_matrix(torch.stack([angles[0], zero, zero]))
    Ry = angles_to_rotation_matrix(torch.stack([zero, angles[1], zero]))
    Rz = angles_to_rotation_matrix(torch.stack([zero, zero, angles[2]]))
    return (Rx @ Ry) @ Rz


def rotation_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z), w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    q1 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)
    case = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)[..., None]
    q = torch.where(case == 0, q0, torch.where(case == 1, q1,
                                               torch.where(case == 2, q2, q3)))
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], -1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], -1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], -1)
    return torch.stack([r0, r1, r2], -2)


def kabsch_quat(A: torch.Tensor, B: torch.Tensor,
                weights: torch.Tensor | None = None,
                eps: float = KABSCH_EPS,
                iters: int = KABSCH_ITERS) -> torch.Tensor:
    """Weighted rigid alignment by Horn's quaternion method: the rotation
    is the dominant eigenvector of the 4x4 Davenport matrix, found by
    shifted power iteration (the same iteration count and shift as the
    reference, so both packages land on the same rotation).

    A, B: [bs, N, 3]; weights: [bs, N].  Returns [bs, 4, 4] with
    ``B ~= R @ A + t``."""
    if weights is None:
        weights = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    w = weights[..., None]
    wsum = torch.sum(weights, dim=-1, keepdim=True)[..., None] + eps
    cA = torch.sum(A * w, dim=-2, keepdim=True) / wsum
    cB = torch.sum(B * w, dim=-2, keepdim=True) / wsum
    H = ((A - cA) * w).transpose(-1, -2) @ (B - cB)          # [bs, 3, 3]

    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    K = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)                                                     # [bs, 4, 4]
    shift = 2.0 * torch.sqrt(torch.sum(H * H, dim=(-2, -1)) + eps)
    Ks = K + shift[..., None, None] * torch.eye(4, dtype=A.dtype,
                                                device=A.device)
    q = torch.ones(A.shape[:-2] + (4,), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        q = (Ks @ q[..., None])[..., 0]
        q = q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)),
                            min=eps)
    R = quaternion_to_rotation_matrix(q)
    t = cB.transpose(-1, -2) - R @ cA.transpose(-1, -2)
    return integrate_trans(R, t[..., 0])


def kabsch(A: torch.Tensor, B: torch.Tensor, weights: torch.Tensor | None = None,
           eps: float = 1e-6) -> torch.Tensor:
    """Weighted rigid alignment by SVD (``buffer_tpu/core/se3.py:253-281``;
    reference ``rigid_transform_3d``, models/BUFFER.py:424-464): weighted
    centroids, H = (A - cA)^T W (B - cB), ``torch.linalg.svd`` and the
    det-sign correction R = V diag(1, 1, d) U^T.

    A, B: [bs, N, 3]; weights: [bs, N] (>= 0).  Returns [bs, 4, 4] with
    ``B ~= R @ A + t``."""
    if weights is None:
        weights = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    w = weights[..., None]
    wsum = torch.sum(weights, dim=-1, keepdim=True)[..., None] + eps
    cA = torch.sum(A * w, dim=-2, keepdim=True) / wsum
    cB = torch.sum(B * w, dim=-2, keepdim=True) / wsum
    H = ((A - cA) * w).transpose(-1, -2) @ (B - cB)
    U, _, Vt = torch.linalg.svd(H, full_matrices=False)
    V = Vt.transpose(-1, -2)
    d = torch.linalg.det(V @ U.transpose(-1, -2))
    diag = torch.cat([torch.ones(d.shape + (2,), dtype=A.dtype,
                                 device=A.device), d[..., None]], dim=-1)
    R = (V * diag[..., None, :]) @ U.transpose(-1, -2)
    t = cB.transpose(-1, -2) - R @ cA.transpose(-1, -2)
    return integrate_trans(R, t[..., 0])
