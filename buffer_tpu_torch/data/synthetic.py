"""Synthetic fragment pairs for smoke tests, gates and measurements:
bench.py's 3DMatch pairs (:func:`bench_pair`, any seed: the bench's and
the measurement scripts' pair), 3DMatch-like surface pairs of any seed
(:func:`surface_pair`: bench.py's surface, a rotation of its own), a
3DMatch-like room pair and a KITTI-like LiDAR pair (numpy copies of the
generators of ``buffer_tpu/data/synthetic.py``, same draws in the same
order; ``lidar_pair(cfg, 13)`` is bench.py's KITTI pair), and
:func:`icp_check_gt`, an independent check of a pair's ground truth."""

from __future__ import annotations

import numpy as np
import torch

from buffer_tpu_torch.config import Config
from buffer_tpu_torch.core import se3
from buffer_tpu_torch.data.preprocess import prepare_pair


def wavy_surface(rs: np.random.RandomState, n: int, ext: float) -> np.ndarray:
    """[n, 3] float32 points of bench.py's wavy surface over
    [-ext, ext]^2 (uniform in x and y)."""
    raw = rs.uniform(-ext, ext, (n, 3)).astype(np.float32)
    raw[:, 2] = (0.5 * np.sin(2.0 * raw[:, 0]) + 0.4 * np.cos(1.7 * raw[:, 1])
                 + 0.15 * np.sin(6.0 * raw[:, 0] * raw[:, 1])
                 + 0.2 * np.tanh(raw[:, 0] + 0.5 * raw[:, 1])
                 + 0.1 * np.exp(-4 * ((raw[:, 0] - 0.4) ** 2
                                      + (raw[:, 1] + 0.3) ** 2)) + 2.0)
    return raw


# bench.py:57's rotation: the float32 values of the JAX package's
# se3.random_rotation(jax.random.PRNGKey(11), 3), which no numpy or torch
# draw reproduces; each literal is the shortest that parses back to the
# same float32 (tests/test_torch_bench.py holds them bit for bit)
BENCH_ROTATION = np.array([[-0.14030285, 0.98311013, 0.117514044],
                           [-0.26357946, 0.0773187, -0.961534],
                           [-0.9543799, -0.16588026, 0.2482796]], np.float32)
BENCH_TRANSLATION = (0.4, -0.2, 0.3)


def _surface_raw(cfg: Config, rs: np.random.RandomState) -> np.ndarray:
    """bench.py's surface at ``cfg``'s plan: up to 60000 points, the extent
    scaled so that the spacing stays ~2 cm."""
    n_raw = min(cfg.static.raw_points, 60000)
    return wavy_surface(rs, n_raw, 1.5 * np.sqrt(n_raw / 60000.0))


def _moved_pair(cfg: Config, raw, R: torch.Tensor, rs, device):
    """(PairInputs of ``raw`` and ``raw`` moved by ``R`` and
    BENCH_TRANSLATION, T [4, 4]); ``prepare_pair`` draws from ``rs``."""
    T = se3.integrate_trans(R, torch.tensor(BENCH_TRANSLATION)).numpy()
    tgt = (raw @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    inputs = prepare_pair(cfg, raw, tgt, rs=rs, already_downsampled=True,
                          device=device)
    return inputs, T


def bench_pair(cfg: Config, device=None, seed: int = 0):
    """bench.py's 3DMatch pair (``bench.synthetic_pair(cfg, seed)``,
    bench.py:34-63), array for array: :func:`wavy_surface` from
    ``RandomState(seed)``, the second cloud moved by BENCH_ROTATION and
    t = (0.4, -0.2, 0.3) whatever the seed (bench.py draws ``PRNGKey(11)``
    for every seed), then ``prepare_pair`` on the same stream.  Returns
    (PairInputs on ``device``, T [4, 4] float32)."""
    rs = np.random.RandomState(seed)
    raw = _surface_raw(cfg, rs)
    return _moved_pair(cfg, raw, torch.from_numpy(BENCH_ROTATION), rs, device)


def surface_pair(cfg: Config, seed: int, device=None):
    """A 3DMatch-like fragment pair on bench.py's surface: a wavy surface
    patch ~3 m x 3 m at ~2 cm spacing (up to 60000 points) from
    ``RandomState(seed)``, the second cloud rigidly moved by a rotation
    drawn from the same stream (``rs.rand(3)``, where bench.py takes a JAX
    key) and t = (0.4, -0.2, 0.3).  So the surface of seed 0 is bench.py's
    but the pair is not: the rotation and every later draw of
    ``prepare_pair`` differ; :func:`bench_pair` is bench.py's pair.
    Returns (PairInputs on ``device``, T [4, 4])."""
    rs = np.random.RandomState(seed)
    raw = _surface_raw(cfg, rs)
    R = se3.random_rotation(torch.from_numpy(rs.rand(3).astype(np.float32)), 3)
    return _moved_pair(cfg, raw, R, rs, device)


def make_room_pair(cfg: Config, rs: np.random.RandomState, overlap=0.7,
                   noise=0.005, clutter=0.1, n=50000, ext=1.4, device=None):
    """Two partially overlapping noisy views of a small room: a wavy floor,
    3-5 boxes resting on it (five exposed faces each) and a back wall, with
    off-surface clutter and a uniform SO(3) motion.  Every draw comes from
    ``rs``, in the order of the JAX package's generator.  ``overlap`` is
    the true overlap share of each view; ``n`` and ``ext`` scale the scene.
    Returns (PairInputs on ``device``, T [4, 4] mapping source onto
    target)."""
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
    inputs = prepare_pair(cfg, src, tgt, rs=rs, already_downsampled=True,
                          device=device)
    return inputs, T


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


def icp_check_gt(inputs, T_gt, max_dist, max_src=6000, min_match=0.25):
    """Checks a synthetic pair's ground-truth pose with one trimmed
    nearest-neighbour Kabsch step, sharing no code with the generators.

    Warps the second-downsample source cloud by ``T_gt``, gates nearest
    neighbours at ``max_dist``, keeps residuals under 3x their median and
    solves one Kabsch for the remaining correction.  A right ``T_gt`` gives
    a correction at the scale of the sampling noise; a wrong one collapses
    the matched share (rte = inf) or raises the median matched residual,
    which separates where the correction alone can alias along smooth
    surfaces, so gate ``med`` over many pairs.

    Returns ``(rte_m, rre_deg, match_frac, med_residual_m)``."""
    from scipy.spatial import cKDTree

    T = np.asarray(T_gt, np.float64)
    host = lambda t: t.detach().cpu().numpy()
    src = host(inputs.sds[0])[host(inputs.sds_mask[0])]
    tgt = host(inputs.sds[1])[host(inputs.sds_mask[1])]
    if len(src) > max_src:
        src = src[:: len(src) // max_src]
    warped = src @ T[:3, :3].T + T[:3, 3]
    d, nn = cKDTree(tgt).query(warped, k=1, distance_upper_bound=max_dist)
    ok = np.isfinite(d)
    inf = float("inf")
    if ok.mean() < min_match or ok.sum() < 50:
        return inf, inf, float(ok.mean()), inf
    med = np.median(d[ok])
    keep = ok & (d < 3.0 * med + 1e-9)
    a, b = warped[keep], tgt[nn[keep]]
    ca, cb = a.mean(0), b.mean(0)
    H = (a - ca).T @ (b - cb)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.linalg.det(Vt.T @ U.T)])
    R = Vt.T @ D @ U.T
    t = cb - R @ ca
    rte = float(np.linalg.norm(t))
    rre = float(np.degrees(np.arccos(np.clip(
        (np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))
    return rte, rre, float(ok.mean()), float(med)


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


def lidar_pair(cfg: Config, seed: int, device=None):
    """A KITTI-like pair: two LiDAR views (about 100k points each, before
    the 5 cm downsample, 1 cm noise) of one outdoor scene -- undulating
    ground, building facades along a road, poles, parked cars -- from sensor
    origins 10 m apart, related by a yaw plus a small tilt (KITTI's >= 10 m
    odometry pairs): :func:`make_lidar_pair` drawing from
    ``RandomState(seed)``.  Returns (PairInputs on ``device``, T [4, 4])
    with T mapping the source sensor frame onto the target's."""
    return make_lidar_pair(cfg, np.random.RandomState(seed), device=device)


def make_lidar_pair(cfg: Config, rs: np.random.RandomState, dist=10.0,
                    noise=0.01, yaw=None, device=None):
    """Two LiDAR views of one :func:`lidar_scene` from sensor origins
    ``dist`` metres apart along the road, each point with Gaussian
    ``noise`` (m), the target rotated by ``yaw`` (drawn uniformly when
    None) and a small tilt: SO(2)-dominant motion, as KITTI's z-only
    augmentation (``KITTI/dataset.py:53-70, 132-141``).  Every draw comes
    from ``rs``, in the order of ``buffer_tpu/data/synthetic.py:298-367``.
    Returns (PairInputs on ``device``, T [4, 4]) with T mapping the source
    sensor frame onto the target's."""
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
    inputs = prepare_pair(cfg, src, tgt, rs=rs, already_downsampled=False,
                          device=device)
    return inputs, T
