# Frozen copy of buffer_tpu_torch/core/gridmath.py at commit c88a0e7761321c01585f758b60ff2700171e6a6a: the
# plain versions of the port's kernels, which define what each kernel
# computes (launchers and plans left out).  The benchmark's reference calls
# them for the kernels' semantics only.  Do not edit.
"""Cylindrical anchor grid of the Spatial Point Transformer, the table the
fused SPT kernel's plain version reads (counterpart of
``buffer_tpu/core/gridmath.py``; reference utils/common.py:248-262); the
derotations are left out."""

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
