"""ETH generalization test set, test split only (counterpart of
``buffer_tpu/data/eth.py``; reference
``generalization/ThreeD2ETH/dataset.py:25-119``): four outdoor scenes, pairs
and ground truth from each scene's ``gt.log``.
"""

from __future__ import annotations

from os.path import join
from typing import Dict, List

import numpy as np

from buffer_tpu_torch.config import Config
from buffer_tpu_torch.data.host import voxel_subsample_host
from buffer_tpu_torch.data.ply import read_ply_points
from buffer_tpu_torch.eval.metrics import load_log

ETH_SCENES = ["gazebo_summer", "gazebo_winter", "wood_autumn", "wood_summer"]


class ETHDataset:
    def __init__(self, split: str, config: Config):
        if split != "test":
            raise ValueError("ETH is an evaluation set: split must be 'test'")
        self.config = config
        self.root = config.data.root
        self.files: List[List[str]] = []
        self.poses: List[np.ndarray] = []
        for scene in ETH_SCENES:
            gt = load_log(join(self.root, scene, "gt.log"))
            for key, pose in gt.items():
                id1, id2 = key.split("_")
                self.files.append([join(scene, f"Hokuyo_{id1}"),
                                   join(scene, f"Hokuyo_{id2}")])
                self.poses.append(pose)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> Dict:
        cfg = self.config
        src_id, tgt_id = self.files[index]
        src = read_ply_points(join(self.root, src_id) + ".ply")
        tgt = read_ply_points(join(self.root, tgt_id) + ".ply")
        src = voxel_subsample_host(src, cfg.data.downsample)
        tgt = voxel_subsample_host(tgt, cfg.data.downsample)
        return {
            "src_fds_pts": src.astype(np.float32),
            "tgt_fds_pts": tgt.astype(np.float32),
            "relt_pose": np.linalg.inv(self.poses[index]).astype(np.float32),
            "src_id": src_id,
            "tgt_id": tgt_id,
        }
