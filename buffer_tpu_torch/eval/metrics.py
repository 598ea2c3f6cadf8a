"""Registration metrics and Redwood-format trajectory I/O (counterpart of
``buffer_tpu/eval/metrics.py``).

Host-side evaluation math of the reference (``ThreeDMatch/test.py:18-196``):
DGR's RTE/RRE recall, the 3DMatch/Redwood registration-recall protocol
(covariance-weighted transform error against ``gt.info``), and the
``.log``/``.info`` readers and writer
(http://redwood-data.org/indoor/fileformat.html).  numpy on float64
throughout, except :func:`mat2quat`, which is fp32 as in the reference.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from buffer_tpu_torch.core import se3


def rte_rre(pose: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """DGR errors (ThreeDMatch/test.py:266-270): RTE = |t - t_gt|,
    RRE = arccos((tr(R^T R_gt) - 1) / 2) in degrees."""
    rte = float(np.linalg.norm(pose[:3, 3] - gt[:3, 3]))
    cos = (np.trace(pose[:3, :3].T @ gt[:3, :3]) - 1.0) / 2.0
    rre = float(np.degrees(np.arccos(np.clip(cos, -1 + 1e-16, 1 - 1e-16))))
    return rte, rre


def dgr_recall(states: np.ndarray) -> Dict[str, float]:
    """states: [N, 3] rows of (success, rte, rre) (ThreeDMatch/test.py:279-285);
    TE and RE average the successful pairs only."""
    ok = states[:, 0] == 1
    return {
        "recall": float(ok.mean()) if len(states) else 0.0,
        "TE": float(states[ok, 1].mean()) if ok.any() else float("nan"),
        "RE": float(states[ok, 2].mean()) if ok.any() else float("nan"),
    }


def mat2quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), w >= 0 (nibabel's
    convention, ThreeDMatch/test.py:107).  Computed in fp32, as the
    reference computes it, so that the thresholds of
    :func:`evaluate_registration` decide as the reference's do."""
    q = se3.rotation_matrix_to_quaternion(
        torch.as_tensor(np.asarray(R, np.float32)))
    return q.numpy()


def compute_transformation_err(trans: np.ndarray, info: np.ndarray) -> float:
    """Covariance-weighted RMSE proxy (ThreeDMatch/test.py:92-111)."""
    t = trans[:3, 3]
    q = mat2quat(trans[:3, :3])
    er = np.concatenate([t, q[1:]], axis=0)
    p = er.reshape(1, 6) @ info @ er.reshape(6, 1) / info[0, 0]
    return float(p.item())


def evaluate_registration(num_fragment: int, result: np.ndarray,
                          result_pairs: np.ndarray, gt_pairs: np.ndarray,
                          gt: np.ndarray, gt_info: np.ndarray,
                          err2: float = 0.2):
    """(precision, recall) of one scene (ThreeDMatch/test.py:114-173).
    Only non-consecutive gt pairs count; gt row 0 can never be marked (the
    reference tests ``gt_mask > 0`` on row indices)."""
    err2 = err2 ** 2
    gt_mask = np.zeros((num_fragment, num_fragment), dtype=np.int64)
    for idx in range(gt_pairs.shape[0]):
        i, j = int(gt_pairs[idx, 0]), int(gt_pairs[idx, 1])
        if j - i > 1:
            gt_mask[i, j] = idx
    n_gt = np.sum(gt_mask > 0)

    good = 0
    n_res = 0
    for idx in range(result_pairs.shape[0]):
        i, j = int(result_pairs[idx, 0]), int(result_pairs[idx, 1])
        if gt_mask[i, j] > 0:
            n_res += 1
            gt_idx = gt_mask[i, j]
            p = compute_transformation_err(
                np.linalg.inv(gt[gt_idx]) @ result[idx], gt_info[gt_idx])
            if p <= err2:
                good += 1
    if n_res == 0:
        n_res = int(1e6)
    precision = good / n_res
    recall = good / max(n_gt, 1)
    return precision, recall


# ---------------------------------------------------------------------------
# Redwood .log / .info files
# ---------------------------------------------------------------------------

def load_log(path: str) -> Dict[str, np.ndarray]:
    """gt.log -> {'i_j': 4x4}, keyed as the reference's loadlog
    (utils/tools.py:45-60)."""
    with open(path) as f:
        lines = [l for l in f.read().splitlines() if l.strip()]
    out = {}
    for i in range(0, len(lines), 5):
        head = lines[i].split()
        out[f"{int(head[0])}_{int(head[1])}"] = np.array(
            [[float(v) for v in lines[i + r + 1].split()] for r in range(4)])
    return out


def read_trajectory(path: str, dim: int = 4):
    """(pairs [N, 3] str, traj [N, 4, 4] float32) (ThreeDMatch/test.py:18-55)."""
    with open(path) as f:
        lines = f.readlines()
    keys = lines[0::dim + 1]
    final_keys = [k.replace("\t", " ").split()[:3] for k in keys]
    traj = [line.replace("\t", " ").split()[:dim]
            for i, line in enumerate(lines) if i % (dim + 1) != 0]
    traj = np.asarray(traj, dtype=np.float32).reshape(-1, dim, dim)
    return np.asarray(final_keys), traj


def read_trajectory_info(path: str, dim: int = 6):
    """(n_fragments, cov [N, 6, 6] float32) (ThreeDMatch/test.py:58-89)."""
    with open(path) as fid:
        contents = fid.readlines()
    n_pairs = len(contents) // 7
    info_list = []
    n_frame = 0
    for i in range(n_pairs):
        n_frame = int(contents[i * 7].strip().split()[2])
        info_list.append(np.concatenate([
            np.fromstring(contents[i * 7 + 1 + r], sep=" \t").reshape(1, -1)
            for r in range(6)], axis=0))
    cov = np.asarray(info_list, dtype=np.float32).reshape(-1, dim, dim)
    return n_frame, cov


def write_trajectory(path: str, entries: Sequence[Tuple[str, str, np.ndarray]]):
    """Writes Redwood-format entries (src_id, tgt_id, 4x4 INVERSE pose: the
    reference writes inv(est), ThreeDMatch/test.py:254-261), each value as
    ``str(float)``.

    Truncates the file: the harness writes each scene's trajectory once a
    run, and appending would duplicate entries across runs into one log
    directory and corrupt the registration recall."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for src_id, tgt_id, trans in entries:
            f.write(f"{src_id}\t {tgt_id}\t  1\n")
            for r in range(4):
                f.write("\t ".join(str(trans[r, c]) for c in range(4))
                        + "\t \n")
