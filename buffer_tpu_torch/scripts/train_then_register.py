"""Train all four stages from scratch on synthetic room scenes, then register
held-out pairs with the trained weights (counterpart of the repository's
``scripts/train_then_register.py``):

    python -m buffer_tpu_torch.scripts.train_then_register \\
        [--train-pairs 48] [--epochs 4] [--eval-pairs 24] [--json PATH] \\
        [--assert-recall R] [--device cpu]

The closed loop that loss-drop tests cannot give: the trainer, the stage
losses, the stage sequencing and the batch statistics together must give a
model that registers.  Chance recall on these scenes is ~0 (a uniform SO(3)
motion against the 0.3 m / 15 degree thresholds).  Runs on the ``small_cfg``
plan (4096 level-0 points, 384 keypoints); the scenes keep 2 cm surface
density so that des_r = 0.3 patches stay local.  Each held-out pair also
gets a diagnosis of the learned stages under the ground truth: mutual
matches, the share of them within 2 v0 (Desc), the axes' co-rotation
cosine on correct matches (Ref), and the winning hypothesis' vote count
(Inlier).

Scenes come from ``RandomState(3)`` (training, then validation pairs) and
``RandomState(31)`` (held-out pairs), each stage's epoch order from
``RandomState(17)``, the training draws from a generator seeded with 7 and
each held-out pair's draws from one seeded with 1000 + its index.  Runs on
the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Parses ``argv`` (default: the command line), trains, registers and
    prints the recall; returns the exit code (1 when ``--assert-recall``
    is not met)."""
    from buffer_tpu_torch.kernels.cuda import BUILD_DIR

    ap = argparse.ArgumentParser(
        prog="python -m buffer_tpu_torch.scripts.train_then_register")
    ap.add_argument("--train-pairs", type=int, default=48)
    ap.add_argument("--eval-pairs", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--out", default=str(BUILD_DIR / "train_then_register"))
    ap.add_argument("--json", default=None)
    ap.add_argument("--assert-recall", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    from buffer_tpu_torch import config, resolve_device
    from buffer_tpu_torch.data.synthetic import make_room_pair
    from buffer_tpu_torch.eval.metrics import rte_rre
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.pipeline import registration
    from buffer_tpu_torch.train.trainer import TrainBatch, Trainer

    dev = resolve_device(args.device)
    cfg = config.small_cfg()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, epoch=args.epochs))
    model = BufferModel(cfg, seed=0).to(dev)

    def scene(rs):
        overlap = rs.uniform(0.55, 0.9)
        noise = rs.uniform(0.0, 0.006)
        clutter = rs.uniform(0.0, 0.06)
        return make_room_pair(cfg, rs, overlap, noise, clutter, n=20000,
                              ext=0.9, device=dev)

    def batches(rs, n):
        return [TrainBatch(inputs, torch.as_tensor(T, dtype=torch.float32,
                                                   device=dev))
                for inputs, T in (scene(rs) for _ in range(n))]

    print("generating scenes...", flush=True)
    t0 = time.time()
    rs = np.random.RandomState(3)
    train_batches = batches(rs, args.train_pairs)
    # validation is disjoint from training: the same stream, fresh draws
    val_batches = batches(rs, max(2, args.train_pairs // 8))
    rs_eval = np.random.RandomState(31)
    eval_pairs = [scene(rs_eval) for _ in range(args.eval_pairs)]
    scenes_s = time.time() - t0

    # stage-sequential training; the weights carry over between stages as
    # the reference's load-best-and-freeze merge (ThreeDMatch/train.py:31-47)
    t0 = time.time()
    for stage in cfg.train.all_stage:
        st0 = time.time()
        trainer = Trainer(cfg.with_stage(stage), model, stage,
                          os.path.join(args.out, "snap"), device=dev)
        rs_ep = np.random.RandomState(17)
        trainer.fit(
            lambda epoch: iter([train_batches[i] for i in
                                rs_ep.permutation(len(train_batches))]),
            lambda epoch: iter(val_batches),
            generator=torch.Generator(device=dev).manual_seed(7))
        print(f"stage {stage}: {args.epochs} epochs x {len(train_batches)} "
              f"pairs in {time.time() - st0:.1f}s, best {trainer.best:.4f}",
              flush=True)
    train_s = time.time() - t0

    # the held-out pairs with the trained weights, and the stage diagnosis
    model.eval()
    states = []
    diag = {"mutual": [], "correct_match_rate": [], "axis_cos": [],
            "vote_inliers": []}
    inl_th = 2.0 * cfg.data.voxel_size_0
    t1 = time.time()
    for i, (inputs, T) in enumerate(eval_pairs):
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        res, inter = registration.register_pair(
            model, inputs, registration.make_draws(cfg, gen, dev), device=dev,
            return_intermediates=True)
        rte, rre = rte_rre(res.pose.cpu().numpy().astype(np.float64),
                           np.asarray(T, np.float64))
        ok = rte < 0.3 and rre < 15.0
        states.append(ok)
        Tm = np.asarray(T)
        kpts = inter["kpts"].cpu().numpy()                 # [2, K, 3]
        mut = inter["matches"].mutual.cpu().numpy()
        tgt_idx = inter["matches"].tgt_idx.long().cpu().numpy()
        src_w = kpts[0] @ Tm[:3, :3].T + Tm[:3, 3]
        derr = np.linalg.norm(src_w - kpts[1][tgt_idx], axis=-1)
        correct = (derr < inl_th) & mut
        nm = max(int(mut.sum()), 1)
        axis = inter["axis"].cpu().numpy()                 # [2, S0, 3]
        kidx = inter["kidx"].long().cpu().numpy()
        s_ax = axis[0][kidx[0]] @ Tm[:3, :3].T
        t_ax = axis[1][kidx[1]][tgt_idx]
        cosv = np.abs(np.sum(s_ax * t_ax, axis=-1))
        diag["mutual"].append(int(mut.sum()))
        diag["correct_match_rate"].append(float(correct.sum() / nm))
        diag["axis_cos"].append(
            float(np.mean(cosv[correct])) if correct.any() else 0.0)
        diag["vote_inliers"].append(
            int(inter["vote_inliers"].sum().item()))
        print(f"eval pair {i:2d} mutual={int(res.num_mutual):4d} "
              f"correct={int(correct.sum()):4d} axis_cos="
              f"{diag['axis_cos'][-1]:.3f} RTE={rte:.4f} RRE={rre:.3f} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
    eval_s = time.time() - t1
    recall = float(np.mean(states))
    diag_summary = {k: round(float(np.mean(v)), 4) for k, v in diag.items()}
    print(f"\ntrained-from-scratch recall: {recall:.3f} over {len(states)} "
          f"pairs ({train_s + eval_s:.0f}s of training and registration)")
    print(f"stage diagnosis: {diag_summary}")
    print(json.dumps({"scenes_s": scenes_s, "train_s": train_s,
                      "eval_s": eval_s, "device": str(dev)}))

    if args.json:
        rec = {"metric": "trained_from_scratch_recall",
               "value": round(recall, 4), "unit": "recall@0.3m/15deg",
               "pairs": len(states), "train_pairs": args.train_pairs,
               "epochs": args.epochs, "diagnosis": diag_summary}
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec))
    if args.assert_recall is not None and recall < args.assert_recall:
        print(f"FAIL: recall {recall:.3f} < {args.assert_recall}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
