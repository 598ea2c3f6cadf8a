"""Per-layer device time of one registration's front on the card
(counterpart of the repository's ``scripts/profile_micro.py``):

    python -m buffer_tpu_torch.scripts.profile_micro [--config {3DMatch,KITTI}]
        [--torch-weights DIR]

On the pair, weights and draws of ``profile_stages`` (full static plan,
``full_fp32()``), the rows (:func:`micro_bodies`) are: the level-0 kNN of
one cloud by the preset's route (the banded kernel at the shipped band),
EFCNN's encoder blocks 0-4, its decoder and heads (axis + inv), DetNet,
patch extraction (``extract_patch_planes``: the ball kernel, both clouds in
one launch), the axis alignment (``align_rotation``), the fused front
(``fused_point_features``: the SPT kernel), MiniSpinNet's network on the
pooled map (the cylindrical CNN, attention pooling and normalization),
then each convolution of the cylindrical CNN (8) and of the cost volume's
CostNet (10), each with its batch norm and ReLU, with its fp32 operations
and its share of the fp32 peak.  The pyramid, FPS and matching between the
rows run eagerly, untimed.  Each row runs on what the rows before it
produced and is timed by
:func:`~buffer_tpu_torch.utils.profiling.graph_time`.  Before timing, the
chained rows are held bit-equal to ``model.Ref``, ``model.Keypt``,
``describe_both`` and the two networks' ``forward``; a difference raises.

Prints one JSON line: the card (name, power limit) and each row's ms (the
convolutions with FLOPs, TFLOP/s and share of 67 TFLOP/s).  Runs on the
CUDA card only.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence

import torch

from buffer_tpu_torch.scripts.profile_stages import Row

PEAK_FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores


def conv_flops(conv, out: torch.Tensor) -> int:
    """Floating-point operations of ``conv`` producing ``out``: a multiply
    and an add for each weight over each output element."""
    k = 1
    for n in conv.kernel_size:
        k *= n
    return 2 * out.numel() * (conv.in_channels // conv.groups) * k


def micro_bodies(model, inputs, draws) -> List[Row]:
    """The per-layer rows, in pipeline order, each run once here on the
    outputs of the rows before it (the pyramid, FPS and mutual matching in
    between run eagerly and are not rows).  Call under ``torch.no_grad()``
    and ``full_fp32()``."""
    from buffer_tpu_torch.models import patch_embedder as pe
    from buffer_tpu_torch.ops.neighbors import radius_knn
    from buffer_tpu_torch.pipeline import registration as reg
    from buffer_tpu_torch.pipeline.pyramid import build_pyramid_and_normals
    cfg, st, p = model.cfg, model.cfg.static, model.cfg.patch
    K = cfg.point.num_keypts
    rows: List[Row] = []

    def row(name, body, conv=None):
        out = body()
        rows.append(Row(name, body, None if conv is None else conv_flops(conv, out)))
        return out

    levels = (None if inputs.lvl1 is None else
              (inputs.lvl1, inputs.lvl1_mask, inputs.lvl2, inputs.lvl2_mask))
    pyr = build_pyramid_and_normals(cfg, inputs.sds, inputs.sds_mask, levels)

    sds, msk = inputs.sds[:1], inputs.sds_mask[:1]
    row("L0 kNN (one cloud)", lambda: radius_knn(
        sds, sds, msk, k=max(st.normal_knn, st.neighbor_caps[0]), radius=None,
        query_chunk=st.knn_chunk, band=st.knn_band or None, query_valid=msk))

    ref = model.Ref
    x = pyr.features[..., None, :]
    enc = []
    for i in range(len(ref.encoder_blocks)):
        x = row(f"EFCNN block {i}", lambda i=i, x=x: ref.encode(i, x, pyr))
        enc.append(x)
    x0, x1, x2 = enc[0], enc[2], enc[4]
    dec = row("EFCNN decoder", lambda: ref.decode(x2, (x0, x1), pyr))
    axis, _ = row("EFCNN heads (axis + inv)",
                  lambda: ref.heads(dec, pyr.masks[0]))
    branch = {"bottle": x2, "skips": (x0, x1)}
    score = row("DetNet (Keypt)", lambda: model.Keypt(pyr, branch))[..., 0]

    axis = reg.orient_axes(axis, inputs.sds)
    _, kvalid, kpts, kaxes = reg.detect_keypoints(cfg, inputs.sds,
                                                  inputs.sds_mask, score, axis)
    planes = row("extract patches (both clouds)", lambda: pe.extract_patch_planes(
        inputs.raw, inputs.raw_mask, draws.ball_prio, kpts, p.des_r,
        p.num_points_per_patch))
    R_all = row("axis align", lambda: pe.align_rotation(
        cfg.data.dataset, kaxes.reshape(2 * K, 3)))

    def front():
        unit = tuple(((c - kpts[..., d:d + 1]) / p.des_r).reshape(2 * K, -1)
                     for d, c in enumerate(planes))
        return pe.fused_point_features(
            model.Desc, draws.spt_prio, unit, R_all, p.rad_n, p.azi_n, p.ele_n,
            p.delta / p.rad_n, p.voxel_sample)

    pooled = row("fused front (SPT)", front)
    desc, equi = row("MiniSpinNet network", lambda: model.Desc(pooled))

    cyl = model.Desc.conv_net
    x = pooled.permute(0, 4, 1, 2, 3)
    for i, layer in enumerate(cyl.layers):
        x = row(f"cylindrical conv {i}", lambda i=i, x=x: cyl.layer(i, x),
                layer[0])

    s_des, t_des = desc[:K], desc[K:]
    s_equi, t_equi = equi[:K], equi[K:]
    t_R = R_all.reshape(2, K, 3, 3)[1]
    _, tgt, *_ = reg.match_keypoints(kpts, kvalid, s_des, t_des, t_R)
    band = slice(1, p.ele_n - 1)
    net = model.Inlier.conv
    x = model.Inlier.cost(s_equi[:, band], t_equi[:, band][tgt])
    for i, layer in enumerate(net.layers):
        x = row(f"cost volume conv {i}", lambda i=i, x=x: net.layer(i, x),
                layer[0])
    return rows


def chain_mismatches(model, inputs, draws, rows: Sequence[Row]) -> list:
    """What the chained rows give differently from the modules they split:
    the heads' axis and eps and the encoder's branch against ``model.Ref``,
    DetNet's saliency against ``model.Keypt``, the network's descriptors
    and maps and the alignment against ``describe_both`` on the same
    keypoints, the last cylindrical and cost-volume convolutions against
    ``CylindricalNet`` and ``CostNet`` on the rows' inputs.  Returns the
    differing names."""
    from buffer_tpu_torch.pipeline import registration as reg
    from buffer_tpu_torch.pipeline.pyramid import build_pyramid_and_normals
    with torch.no_grad(), reg.full_fp32():
        cfg = model.cfg
        out = {r.name: r.body() for r in rows}
        levels = (None if inputs.lvl1 is None else
                  (inputs.lvl1, inputs.lvl1_mask, inputs.lvl2, inputs.lvl2_mask))
        pyr = build_pyramid_and_normals(cfg, inputs.sds, inputs.sds_mask, levels)
        axis, eps, branch = model.Ref(pyr)
        score = model.Keypt(pyr, branch)
        _, kvalid, kpts, kaxes = reg.detect_keypoints(
            cfg, inputs.sds, inputs.sds_mask, score[..., 0],
            reg.orient_axes(axis, inputs.sds))
        (s_des, s_equi, s_R), (t_des, t_equi, t_R) = reg.describe_both(
            model, cfg, draws, inputs.raw, inputs.raw_mask, kpts, kaxes)
        _, tgt, *_ = reg.match_keypoints(kpts, kvalid, s_des, t_des, t_R)
        band = slice(1, cfg.patch.ele_n - 1)
        pooled = out["fused front (SPT)"]
        n_cyl = len(model.Desc.conv_net.layers)
        last_cost = f"cost volume conv {len(model.Inlier.conv.layers) - 1}"
        out[last_cost] = out[last_cost].reshape(out[last_cost].shape[0], -1)
        want = {
            "EFCNN heads (axis + inv)": (axis, eps),
            "EFCNN block 0": branch["skips"][0], "EFCNN block 2": branch["skips"][1],
            "EFCNN block 4": branch["bottle"],
            "DetNet (Keypt)": score,
            "MiniSpinNet network": (torch.cat([s_des, t_des]),
                                    torch.cat([s_equi, t_equi])),
            "axis align": torch.cat([s_R, t_R]),
            f"cylindrical conv {n_cyl - 1}": model.Desc.conv_net(
                pooled.permute(0, 4, 1, 2, 3)),
            last_cost: model.Inlier.conv(
                model.Inlier.cost(s_equi[:, band], t_equi[:, band][tgt])),
        }
        leaves = torch.utils._pytree.tree_leaves
        return [k for k, w in want.items()
                if not all(a.dtype == b.dtype and torch.equal(a, b)
                           for a, b in zip(leaves(out[k]), leaves(w)))]


def run(model, inputs, draws) -> dict:
    """The profile (see the module's docstring) as a dict."""
    from buffer_tpu_torch.pipeline.registration import full_fp32
    from buffer_tpu_torch.utils.profiling import graph_time
    with torch.no_grad(), full_fp32():
        rows = micro_bodies(model, inputs, draws)
        bad = chain_mismatches(model, inputs, draws, rows)
        if bad:
            raise RuntimeError(f"profile_micro: the chained rows differ from "
                               f"the modules in {bad}")
        timed = []
        for r in rows:
            t = {"name": r.name, "ms": graph_time(r.body)}
            if r.flops is not None:
                rate = r.flops / (t["ms"] * 1e-3)
                t.update(flops=r.flops, tflops_per_s=rate / 1e12,
                         share_of_fp32_peak=rate / PEAK_FP32_FLOPS)
            timed.append(t)
    conv = lambda prefix: [t for t in timed if t["name"].startswith(prefix)]
    return {"config": model.cfg.data.dataset, "rows": timed,
            "chain_bit_equal": True,
            "cylindrical_ms": sum(t["ms"] for t in conv("cylindrical conv")),
            "cylindrical_flops": sum(t["flops"] for t in conv("cylindrical conv")),
            "cost_volume_ms": sum(t["ms"] for t in conv("cost volume conv")),
            "cost_volume_flops": sum(t["flops"] for t in conv("cost volume conv")),
            "notes": ["extract patches: both clouds in one launch (the JAX "
                      "script's row is one cloud)",
                      "conv rows: each convolution with its batch norm and "
                      "ReLU; flops count the convolution's multiply-adds"]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m buffer_tpu_torch.scripts.profile_micro")
    ap.add_argument("--config", default="3DMatch", choices=("3DMatch", "KITTI"))
    ap.add_argument("--torch-weights", default=None,
                    help="reference snapshot directory with <stage>/best.pth "
                         "(default: seeded random weights)")
    args = ap.parse_args(argv)

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.scripts.profile_stages import (bench_model,
                                                         profile_pair)
    from buffer_tpu_torch.utils.profiling import card_line

    dev = resolve_device(None)
    cuda.build_all()
    cfg = make_cfg(args.config)
    model, weights = bench_model(cfg, args.torch_weights, dev)
    inputs, _, draws = profile_pair(cfg, dev)
    out = run(model, inputs, draws)
    print(json.dumps({"card": card_line(), "weights": weights, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
