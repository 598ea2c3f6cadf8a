"""Floating-point operations of one registered pair, counted from the
configuration's shapes (a multiply and an add for each weight over each
output element), as the program computes them: on the padded static plan.

- :func:`cylindrical_flops`: MiniSpinNet's cylindrical CNN over both
  clouds' keypoints (one Conv3d, then seven Conv2d, each 3x3 with
  cylindrical padding; ``profile_micro``'s count, 0.356 TFLOP a 3DMatch
  pair);
- :func:`costnet_flops`: the cost volume's CostNet, ten unpadded Conv3d
  over every match (0.240 TFLOP);
- :func:`conv_flops`: both, the convolutions of ``conv_roofline``;
- :func:`model_flops`: those, the attention pooling's 1x1 convolutions,
  the Vector-Neuron layers of EFCNN and DetNet and the descriptor
  similarity of mutual matching: the model work of ``mfu``.  It leaves out
  the point MLP of the fused SPT front (data dependent), the search, the
  solver and the element-wise work, so it counts low.

The layer plans are BUFFER's (models/patchnet.py, models/point_learner.py),
as the port's ``nn/cylindrical.py`` and ``models/point_learner.py`` at
commit c88a0e7761321c01585f758b60ff2700171e6a6a run them.
"""

from __future__ import annotations

CYL_PLAN = ((16, 64), (64, 64), (64, 128), (128, 128), (128, 64), (64, 64),
            (64, 32), (32, 32))
COST_PLAN = ((32, 32, (3, 3, 3)), (32, 64, (3, 3, 3)), (64, 64, (3, 1, 3)),
             (64, 128, (3, 1, 3)), (128, 128, (3, 1, 3)),
             (128, 64, (3, 1, 3)), (64, 64, (3, 1, 3)), (64, 32, (3, 1, 3)),
             (32, 32, (3, 1, 3)), (32, 20, (2, 1, 2)))


def cylindrical_layers(m: dict) -> list:
    """FLOPs of each convolution of the cylindrical CNN."""
    p = m["patch"]
    B = 2 * m["point"]["num_keypts"]
    out = []
    for i, (cin, cout) in enumerate(CYL_PLAN):
        if i == 0:   # Conv3d 3x3x3, radial axis unpadded, the rest padded
            pos, taps = (p["rad_n"] - 2) * p["ele_n"] * p["azi_n"], 27
        else:        # Conv2d 3x3, padded
            pos, taps = p["ele_n"] * p["azi_n"], 9
        out.append(2 * B * cout * pos * cin * taps)
    return out


def costnet_layers(m: dict) -> list:
    """FLOPs of each convolution of CostNet over [K, 32, shifts, ele-2,
    azi]."""
    p = m["patch"]
    K = m["point"]["num_keypts"]
    dims = [p["azi_n"], p["ele_n"] - 2, p["azi_n"]]
    out = []
    for cin, cout, k in COST_PLAN:
        dims = [d - kk + 1 for d, kk in zip(dims, k)]
        n = dims[0] * dims[1] * dims[2]
        out.append(2 * K * cout * n * cin * k[0] * k[1] * k[2])
    return out


def cylindrical_flops(m: dict) -> int:
    return sum(cylindrical_layers(m))


def costnet_flops(m: dict) -> int:
    return sum(costnet_layers(m))


def conv_flops(m: dict) -> int:
    return cylindrical_flops(m) + costnet_flops(m)


def _vn(cin: int, cout: int, items: int) -> int:
    """A VNLinearLeakyReLU: two channel maps of [items, cin, 3]."""
    return 2 * 2 * cin * cout * 3 * items


def point_learner_flops(m: dict) -> int:
    """EFCNN (encoder, decoder, heads) and DetNet (decoder, head) on both
    clouds' padded pyramid levels."""
    st = m["static"]
    fd = m["point"]["first_feats_dim"] // 3
    B = 2
    n0, n1, n2 = st["points_l0"], st["points_l1"], st["points_l2"]
    k0, k1, k2 = st["neighbor_caps"]
    p0, p1 = st["pool_caps"]
    enc = (_vn(1 + 3, fd, n0 * k0)
           + _vn(fd + 1, fd // 2, n1 * p0) + _vn(fd // 2, fd, n1) + _vn(fd, fd, n1)
           + _vn(fd + 1, fd, n1 * k1) + _vn(fd, 2 * fd, n1) + _vn(fd, 2 * fd, n1)
           + _vn(2 * fd + 1, fd, n2 * p1) + _vn(fd, 2 * fd, n2)
           + _vn(2 * fd, 2 * fd, n2)
           + _vn(2 * fd + 1, 2 * fd, n2 * k2) + _vn(2 * fd, 4 * fd, n2)
           + _vn(2 * fd, 4 * fd, n2))
    dec = _vn(6 * fd, 2 * fd, n1) + _vn(3 * fd, fd, n0)
    inv_head = (_vn(fd, fd, n0) + _vn(fd, fd // 2, n0)
                + 2 * n0 * (3 * fd * 2 * fd + 2 * fd * fd + fd))
    heads = _vn(fd, fd // 2, n0) + _vn(fd // 2, 1, n0)
    return B * (enc + 2 * dec + 2 * inv_head + heads)


def model_flops(m: dict) -> int:
    p = m["patch"]
    K = m["point"]["num_keypts"]
    pool = 2 * (2 * K) * p["ele_n"] * p["azi_n"] * (32 * 16 + 16 * 1)
    similarity = 2 * K * K * 32
    return conv_flops(m) + pool + point_learner_flops(m) + similarity
