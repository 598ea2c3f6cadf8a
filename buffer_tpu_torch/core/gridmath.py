"""Cylindrical anchor grid and azimuth derotations of the Spatial Point
Transformer (counterpart of ``buffer_tpu/core/gridmath.py``).  Both tables
are static and built with numpy (reference utils/common.py:248-262,
:390-428, :483-493)."""

from __future__ import annotations

import numpy as np


def s2_grid(n_alpha: int, n_beta: int) -> np.ndarray:
    """Rings around the equator: [n_beta*n_alpha, 2] of (beta, alpha)."""
    beta = np.linspace(0, np.pi, num=n_beta, endpoint=False) + np.pi / n_beta / 2
    alpha = np.linspace(0, 2 * np.pi, num=n_alpha, endpoint=False) + np.pi / n_alpha
    B, A = np.meshgrid(beta, alpha, indexing="ij")
    return np.stack((B.flatten(), A.flatten()), axis=1)


def sphere_to_cartesian(coords: np.ndarray, radius: float) -> np.ndarray:
    beta, alpha = coords[..., 0], coords[..., 1]
    st, ct = np.sin(beta), np.cos(beta)
    sp, cp = np.sin(alpha), np.cos(alpha)
    return np.stack([radius * st * cp, radius * st * sp, radius * ct], axis=-1)


def get_voxel_coordinate(radius: float, rad_n: int, azi_n: int, ele_n: int) -> np.ndarray:
    """SPT anchor centres [rad_n, ele_n*azi_n, 3]: the s2 grid at rad_n
    shell radii ``(i + 0.5)/rad_n * radius``."""
    grid = s2_grid(n_alpha=azi_n, n_beta=ele_n)
    on_s2 = sphere_to_cartesian(grid, radius)
    on_s2 = np.repeat(on_s2[None], rad_n, axis=0)
    scale = (np.arange(rad_n) / rad_n + 1 / (2 * rad_n)).reshape(rad_n, 1, 1)
    return scale * on_s2


def azimuth_derotations(azi_n: int) -> np.ndarray:
    """[azi_n, 3, 3] rotations Rz(-i * 2pi/azi_n) taking azimuth bin i back
    to bin 0."""
    ang = -np.arange(azi_n) * (2 * np.pi / azi_n)
    c, s = np.cos(ang), np.sin(ang)
    R = np.zeros((azi_n, 3, 3))
    R[:, 0, 0], R[:, 0, 1] = c, -s
    R[:, 1, 0], R[:, 1, 1] = s, c
    R[:, 2, 2] = 1.0
    return R
