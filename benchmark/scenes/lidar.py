"""Outdoor LiDAR sweep pairs, drawn from a ``numpy.random.RandomState``: the
scene ``lidar`` of a traffic mix (``"scene"``), found by this file's name.

A frozen copy of the raw-cloud generator of
``buffer_tpu_torch/data/synthetic.py`` at commit
c88a0e7761321c01585f758b60ff2700171e6a6a (``make_lidar_pair`` without its
``prepare_pair`` call, ``lidar_scene`` and ``_lidar_view``): the same draws in the
same order.  The port's ``prepare_pair`` is what the benchmark measures, so
it is not part of this file.  Do not edit: a new scene is a new file.
"""

from __future__ import annotations

import numpy as np


def _lidar_view(rs, origin, scene, r_max=42.0, r_min=2.5, n_ground=60000,
                struct_frac=0.5, noise=0.01):
    """One LiDAR view of ``scene`` from ``origin``: ground points in polar
    coordinates with a ~1/r density falloff, structures sampled on their
    surfaces, range-gated; returned in the sensor frame."""
    ox, oy, oz = origin
    gz, walls, poles, boxes = scene

    u = rs.rand(n_ground).astype(np.float32)
    r = r_min + (r_max - r_min) * u ** 0.75
    th = rs.uniform(0, 2 * np.pi, n_ground).astype(np.float32)
    gx = ox + r * np.cos(th)
    gy = oy + r * np.sin(th)
    parts = [np.stack([gx, gy, gz(gx, gy)], -1)]
    for (p0, p1, h) in walls:
        seg = np.asarray(p1, np.float32) - np.asarray(p0, np.float32)
        L = float(np.hypot(seg[0], seg[1]))
        m = int(140 * L * h * struct_frac)      # ~140 pts/m^2 before gating
        if m == 0:
            continue
        uu = rs.rand(m).astype(np.float32)
        vv = rs.rand(m).astype(np.float32)
        x = p0[0] + uu * seg[0]
        y = p0[1] + uu * seg[1]
        parts.append(np.stack([x, y, gz(x, y) + vv * h], -1))
    for (cx, cy, rad, h) in poles:
        m = int(600 * h * struct_frac)
        phi = rs.uniform(0, 2 * np.pi, m).astype(np.float32)
        x = cx + rad * np.cos(phi)
        y = cy + rad * np.sin(phi)
        z = gz(np.full(m, cx, np.float32),
               np.full(m, cy, np.float32)) + rs.rand(m).astype(np.float32) * h
        parts.append(np.stack([x, y, z], -1))
    for (cx, cy, sx, sy, sz, ang) in boxes:
        m = int(90 * (2 * (sx + sy) * sz + sx * sy) * struct_frac)
        face = rs.choice(5, m)
        uu, vv = rs.rand(m).astype(np.float32), rs.rand(m).astype(np.float32)
        p = np.zeros((m, 3), np.float32)
        top = face == 0
        p[top] = np.stack([(uu[top] - .5) * sx, (vv[top] - .5) * sy,
                           np.full(int(top.sum()), sz, np.float32)], -1)
        for f, sgn in ((1, -.5), (2, .5)):
            i = face == f
            p[i] = np.stack([(uu[i] - .5) * sx,
                             np.full(int(i.sum()), sgn * sy, np.float32),
                             vv[i] * sz], -1)
        for f, sgn in ((3, -.5), (4, .5)):
            i = face == f
            p[i] = np.stack([np.full(int(i.sum()), sgn * sx, np.float32),
                             (uu[i] - .5) * sy, vv[i] * sz], -1)
        ca, sa = np.cos(ang), np.sin(ang)
        p[:, :2] = p[:, :2] @ np.array([[ca, sa], [-sa, ca]], np.float32)
        base = gz(np.full(m, cx, np.float32), np.full(m, cy, np.float32))
        p += np.stack([np.full(m, cx, np.float32),
                       np.full(m, cy, np.float32), base], -1)
        parts.append(p)

    pts = np.concatenate(parts).astype(np.float32)
    rng = np.hypot(pts[:, 0] - ox, pts[:, 1] - oy)
    pts = pts[(rng > r_min) & (rng < r_max)]
    pts = pts + rs.randn(len(pts), 3).astype(np.float32) * noise
    pts[:, 2] -= oz
    pts[:, 0] -= ox
    pts[:, 1] -= oy
    return pts


def lidar_scene(rs: np.random.RandomState):
    """An outdoor scene of :func:`lidar_pair`: undulating ground, building
    facades along a road on +x, poles and parked cars, as the
    ``(ground height function, walls, poles, boxes)`` that
    :func:`_lidar_view` samples."""
    f1, f2 = rs.uniform(0.05, 0.10), rs.uniform(0.04, 0.09)
    a1, a2 = rs.uniform(0.2, 0.45), rs.uniform(0.2, 0.4)

    def gz(x, y):
        return (a1 * np.sin(f1 * x) + a2 * np.cos(f2 * y)
                + 0.06 * np.sin(0.31 * (x + 0.6 * y))).astype(np.float32)

    walls = []
    for _ in range(rs.randint(5, 9)):
        x0 = rs.uniform(-30, 45)
        side = rs.choice([-1, 1])
        y0 = side * rs.uniform(8, 25)
        L = rs.uniform(8, 25)
        ang = rs.uniform(-0.25, 0.25)
        walls.append(((x0, y0), (x0 + L * np.cos(ang), y0 + L * np.sin(ang)),
                      rs.uniform(4.0, 9.0)))
    poles = [(rs.uniform(-30, 45), rs.choice([-1, 1]) * rs.uniform(4, 20),
              rs.uniform(0.1, 0.25), rs.uniform(3.0, 7.0))
             for _ in range(rs.randint(12, 25))]
    boxes = [(rs.uniform(-30, 45), rs.choice([-1, 1]) * rs.uniform(2.5, 18),
              rs.uniform(3.5, 4.8), rs.uniform(1.7, 2.1),
              rs.uniform(1.4, 1.8), rs.uniform(0, np.pi))
             for _ in range(rs.randint(6, 14))]
    return gz, walls, poles, boxes


def lidar_pair(rs: np.random.RandomState, dist=10.0, noise=0.01,
               yaw=None):
    """Two LiDAR views of one :func:`lidar_scene` from sensor origins
    ``dist`` metres apart along the road, each point with Gaussian ``noise``
    (m), the target rotated by ``yaw`` (drawn uniformly when None) and a
    small tilt; every draw from ``rs``.  Returns (source, target [N, 3]
    float32 in their sensor frames, T [4, 4] mapping source onto
    target)."""
    scene = lidar_scene(rs)
    o0 = np.array([0.0, 0.0, 1.73], np.float32)
    heading = rs.uniform(-0.2, 0.2)
    o1 = o0 + np.array([dist * np.cos(heading), dist * np.sin(heading),
                        rs.uniform(-0.3, 0.3)], np.float32)
    src = _lidar_view(rs, o0, scene, noise=noise)
    tgt_raw = _lidar_view(rs, o1, scene, noise=noise)

    if yaw is None:
        yaw = rs.uniform(0, 2 * np.pi)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float32)
    tilt = rs.uniform(-0.02, 0.02, 2)
    cx_, sx_ = np.cos(tilt[0]), np.sin(tilt[0])
    cyt, syt = np.cos(tilt[1]), np.sin(tilt[1])
    Rt = (np.array([[1, 0, 0], [0, cx_, -sx_], [0, sx_, cx_]], np.float32)
          @ np.array([[cyt, 0, syt], [0, 1, 0], [-syt, 0, cyt]], np.float32))
    R = (Rz @ Rt).astype(np.float32)
    # tgt_raw is in the o1 sensor frame already, so the target cloud is
    # R (p_w - o1) and the source-to-target map x -> R (x - (o1 - o0))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, (-R @ (o1 - o0)).astype(np.float32)
    tgt = (tgt_raw @ R.T).astype(np.float32)
    return src, tgt, T


make = lidar_pair
