"""Indoor room fragment pairs, drawn from a ``numpy.random.RandomState``: the
scene ``room`` of a traffic mix (``"scene"``), found by this file's name.

A frozen copy of the raw-cloud generator of
``buffer_tpu_torch/data/synthetic.py`` at commit
c88a0e7761321c01585f758b60ff2700171e6a6a (``make_room_pair`` without its
``prepare_pair`` call, and ``_shoemake_rotation``): the same draws in the
same order.  The port's ``prepare_pair`` is what the benchmark measures, so
it is not part of this file.  Do not edit: a new scene is a new file.
"""

from __future__ import annotations

import numpy as np


def room_pair(rs: np.random.RandomState, overlap=0.7, noise=0.005,
              clutter=0.1, n=50000, ext=1.4):
    """Two partially overlapping noisy views of a small room: a wavy floor,
    3-5 boxes resting on it (five exposed faces each) and a back wall, with
    off-surface clutter and a uniform SO(3) motion; every draw from ``rs``.
    ``overlap`` is the true overlap share of each view; ``n`` and ``ext``
    scale the scene.  Returns (source [N, 3], target [M, 3] float32, T
    [4, 4] mapping source onto target)."""
    parts = []
    rs_f1, rs_f2 = rs.uniform(1.2, 2.5), rs.uniform(1.0, 2.2)
    rs_th = rs.uniform(0, 2 * np.pi)

    def floor_pts(m):
        p = rs.uniform(-ext, ext, (m, 3)).astype(np.float32)
        p[:, 2] = (0.35 * np.sin(rs_f1 * p[:, 0]) + 0.3 * np.cos(rs_f2 * p[:, 1])
                   + 0.2 * np.tanh(2.0 * (np.cos(rs_th) * p[:, 0]
                                          + np.sin(rs_th) * p[:, 1])) + 2.0)
        return p

    def box_pts(m, cx, cy, sx, sy, sz, ang):
        # five exposed faces of a box on the floor, area-weighted
        areas = np.array([sx * sy, sx * sz, sx * sz, sy * sz, sy * sz])
        face = rs.choice(5, m, p=areas / areas.sum())
        u, v = rs.rand(m).astype(np.float32), rs.rand(m).astype(np.float32)
        p = np.zeros((m, 3), np.float32)
        top = face == 0
        p[top] = np.stack([(u[top] - .5) * sx, (v[top] - .5) * sy,
                           np.full(top.sum(), sz, np.float32)], -1)
        for f, sgn in ((1, -.5), (2, .5)):
            i = face == f
            p[i] = np.stack([(u[i] - .5) * sx,
                             np.full(i.sum(), sgn * sy, np.float32),
                             v[i] * sz], -1)
        for f, sgn in ((3, -.5), (4, .5)):
            i = face == f
            p[i] = np.stack([np.full(i.sum(), sgn * sx, np.float32),
                             (u[i] - .5) * sy, v[i] * sz], -1)
        ca, sa = np.cos(ang), np.sin(ang)
        rot = np.array([[ca, -sa], [sa, ca]], np.float32)
        p[:, :2] = p[:, :2] @ rot.T
        base = 2.0 + 0.35 * np.sin(rs_f1 * cx) + 0.3 * np.cos(rs_f2 * cy)
        p += np.array([cx, cy, base - 0.02], np.float32)
        return p

    n_boxes = rs.randint(3, 6)
    boxes = [(rs.uniform(-ext * .75, ext * .75), rs.uniform(-ext * .75, ext * .75),
              rs.uniform(.25, .7), rs.uniform(.25, .7), rs.uniform(.2, .6),
              rs.uniform(0, np.pi)) for _ in range(n_boxes)]
    wall_y = rs.uniform(ext * .75, ext * .95) * rs.choice([-1, 1])

    n_floor = int(n * 0.55)
    n_wall = int(n * 0.12)
    n_box = (n - n_floor - n_wall) // n_boxes
    parts.append(floor_pts(n_floor))
    wx = rs.uniform(-ext, ext, n_wall).astype(np.float32)
    wz = rs.uniform(0, 1.0, n_wall).astype(np.float32)
    parts.append(np.stack(
        [wx, np.full(n_wall, wall_y, np.float32) + 0.08 * np.sin(3.1 * wx),
         2.0 + wz], -1))
    for bx in boxes:
        parts.append(box_pts(n_box, *bx))
    pts = np.concatenate(parts).astype(np.float32)

    # each view keeps a band of x; the half-width h makes ``overlap`` the
    # true shared share of each view
    h = ext * overlap / (2.0 - overlap)
    jit_s = 1.0 + 0.15 * (rs.rand() - 0.5)
    jit_t = 1.0 + 0.15 * (rs.rand() - 0.5)
    src = pts[pts[:, 0] <= h * jit_s]
    tgt_w = pts[pts[:, 0] >= -h * jit_t]

    def add_clutter(x):
        m = int(len(x) * clutter)
        c = rs.uniform(-ext, ext, (m, 3)).astype(np.float32)
        c[:, 2] = rs.uniform(1.0, 3.0, m)
        return np.concatenate([x, c])

    src = add_clutter(src)
    tgt_w = add_clutter(tgt_w)
    src = src + rs.randn(len(src), 3).astype(np.float32) * noise
    tgt_w = tgt_w + rs.randn(len(tgt_w), 3).astype(np.float32) * noise

    R = _shoemake_rotation(rs)
    t = rs.uniform(-0.5, 0.5, 3).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    tgt = (tgt_w @ R.T + t).astype(np.float32)
    return src, tgt, T


def _shoemake_rotation(rs: np.random.RandomState) -> np.ndarray:
    """A uniform SO(3) rotation from three numpy uniforms (Shoemake's
    quaternion), float32."""
    u1, u2, u3 = rs.rand(3)
    qx = np.sqrt(1 - u1) * np.sin(2 * np.pi * u2)
    qy = np.sqrt(1 - u1) * np.cos(2 * np.pi * u2)
    qz = np.sqrt(u1) * np.sin(2 * np.pi * u3)
    qw = np.sqrt(u1) * np.cos(2 * np.pi * u3)
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ], np.float32)


make = room_pair
