"""Synthetic fragment pairs for smoke tests and measurements."""

from __future__ import annotations

import numpy as np
import torch

from buffer_tpu_torch.config import Config
from buffer_tpu_torch.core import se3
from buffer_tpu_torch.data.preprocess import prepare_pair


def surface_pair(cfg: Config, seed: int, device=None):
    """A 3DMatch-like fragment pair, the surface generator of the reference's
    bench.py: a wavy surface patch ~3 m x 3 m at ~2 cm spacing (up to 60000
    points), the second cloud rigidly moved by a random rotation and
    t = (0.4, -0.2, 0.3).  Returns (PairInputs on ``device``, T [4, 4])."""
    rs = np.random.RandomState(seed)
    n_raw = min(cfg.static.raw_points, 60000)
    ext = 1.5 * np.sqrt(n_raw / 60000.0)
    raw = rs.uniform(-ext, ext, (n_raw, 3)).astype(np.float32)
    raw[:, 2] = (0.5 * np.sin(2.0 * raw[:, 0]) + 0.4 * np.cos(1.7 * raw[:, 1])
                 + 0.15 * np.sin(6.0 * raw[:, 0] * raw[:, 1])
                 + 0.2 * np.tanh(raw[:, 0] + 0.5 * raw[:, 1])
                 + 0.1 * np.exp(-4 * ((raw[:, 0] - 0.4) ** 2
                                      + (raw[:, 1] + 0.3) ** 2)) + 2.0)
    R = se3.random_rotation(torch.from_numpy(rs.rand(3).astype(np.float32)), 3)
    T = se3.integrate_trans(R, torch.tensor([0.4, -0.2, 0.3])).numpy()
    tgt = (raw @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    inputs = prepare_pair(cfg, raw, tgt, rs=rs, already_downsampled=True,
                          device=device)
    return inputs, T
