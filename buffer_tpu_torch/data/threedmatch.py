"""3DMatch / 3DLoMatch fragment-pair datasets (counterpart of
``buffer_tpu/data/threedmatch.py``; reference ``ThreeDMatch/dataset.py``).

Training pairs come from the Predator-processed overlap pickle under
``<root>/train``; test pairs from the benchmark scenes' ``gt.log`` files.
Items are numpy dicts on the host; :func:`~buffer_tpu_torch.data.preprocess.prepare_pair`
turns them into padded tensors.
"""

from __future__ import annotations

import os
import pickle
from os.path import join
from typing import Dict, List, Optional

import numpy as np

from buffer_tpu_torch.config import Config
from buffer_tpu_torch.data.host import voxel_subsample_host
from buffer_tpu_torch.data.ply import read_ply_points
from buffer_tpu_torch.eval.metrics import load_log

TEST_SCENES = [
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
]


def _np_rotation(rs: np.random.RandomState, num_axis: int) -> np.ndarray:
    """A random rotation from three uniform angles (utils/SE3.py:5-30):
    identity for ``num_axis`` 0, about z for 1, Rx @ Ry @ Rz otherwise."""
    angles = rs.rand(3) * 2 * np.pi
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    if num_axis == 0:
        return np.eye(3)
    if num_axis == 1:
        return Rz
    return Rx @ Ry @ Rz


class ThreeDMatchDataset:
    """split in {'train', 'val', 'test'} (ThreeDMatch/dataset.py:25-77).

    ``rs`` feeds the training split's swap, rotation and jitter draws; left
    None, every item draws from a fresh unseeded ``RandomState`` as the
    reference does.  The test split draws nothing."""

    def __init__(self, split: str, config: Config,
                 rs: Optional[np.random.RandomState] = None):
        self.config = config
        self.split = split
        self.rs = rs
        self.files: List[List[str]] = []
        self.poses: List[np.ndarray] = []
        root = config.data.root
        if split != "test":
            self.root = join(root, "train")
            with open(join(self.root, "3DMatch_train_overlap.pkl"), "rb") as f:
                overlap = pickle.load(f)
            with open(join(self.root, f"{split}_3dmatch.txt")) as f:
                scene_list = f.read().split()
            for key in overlap:
                src_id, tgt_id = key.split("@")
                if src_id.split("/")[0] in scene_list:
                    self.files.append([src_id, tgt_id])
        else:
            self.root = join(root, "test")
            if config.data.dataset == "3DMatch":
                gtbase = join(self.root, "3DMatch", "gt_result")
            else:  # 3DLoMatch
                gtbase = join(self.root, "3DLoMatch")
            # the benchmark's scenes where present; otherwise the scenes
            # found on disk (a tree of other scenes takes the same path)
            scenes = [s for s in TEST_SCENES if os.path.isdir(join(gtbase, s))]
            if not scenes and os.path.isdir(gtbase):
                scenes = sorted(s for s in os.listdir(gtbase)
                                if os.path.isdir(join(gtbase, s)))
            for scene in scenes:
                gt = load_log(join(gtbase, scene, "gt.log"))
                pcdpath = f"3DMatch/fragments/{scene}"
                for key, pose in gt.items():
                    id1, id2 = key.split("_")
                    self.files.append([join(pcdpath, f"cloud_bin_{id1}"),
                                       join(pcdpath, f"cloud_bin_{id2}")])
                    self.poses.append(pose)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> Dict:
        cfg = self.config
        rs = self.rs if self.rs is not None else np.random.RandomState()
        src_id, tgt_id = self.files[index]
        if self.split != "test" and rs.rand() > 0.5:
            src_id, tgt_id = tgt_id, src_id

        src_pts = read_ply_points(join(self.root, src_id) + ".ply")
        src_pts = voxel_subsample_host(src_pts, cfg.data.downsample)
        tgt_pts = read_ply_points(join(self.root, tgt_id) + ".ply")
        tgt_pts = voxel_subsample_host(tgt_pts, cfg.data.downsample)

        if self.split != "test":
            R = _np_rotation(rs, 3)
            aug = np.eye(4)
            aug[:3, :3] = R
            tgt_pts = tgt_pts @ R.T
            src_pose = np.load(join(self.root, src_id) + ".pose.npy")
            tgt_pose = np.load(join(self.root, tgt_id) + ".pose.npy")
            relt_pose = aug @ np.linalg.inv(tgt_pose) @ src_pose
            noise = cfg.train.augmentation_noise
            src_pts = src_pts + (rs.rand(*src_pts.shape) - 0.5) * noise
            tgt_pts = tgt_pts + (rs.rand(*tgt_pts.shape) - 0.5) * noise
        else:
            relt_pose = np.linalg.inv(self.poses[index])

        return {
            "src_fds_pts": src_pts.astype(np.float32),
            "tgt_fds_pts": tgt_pts.astype(np.float32),
            "relt_pose": relt_pose.astype(np.float32),
            "src_id": src_id,
            "tgt_id": tgt_id,
        }
