"""KITTI odometry registration pairs (counterpart of
``buffer_tpu/data/kitti.py``; reference ``KITTI/dataset.py``).

Pairs of velodyne scans are mined from the odometry poses (the frame before
the first one more than 10 m away, KITTI/dataset.py:45-75).  The ground
truth is the velo2cam-chained pose refined by point-to-point ICP and cached
as ``<root>/icp/<drive>_<t0>_<t1>.npy``.  Training augments by SO(3) for
the Ref stage and SO(2) (about z) otherwise; the known bad test pair
(8, 15, 58) is removed.  :func:`icp_point_to_point` (scipy cKDTree
correspondences + Kabsch) stands in for the reference's Open3D ICP
(KITTI/dataset.py:104-108).

The ICP cache lives in the data root and is trusted when present: a tree
whose scans change must be written afresh, cache included.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from buffer_tpu_torch.config import Config
from buffer_tpu_torch.data.host import voxel_subsample_host
from buffer_tpu_torch.data.threedmatch import _np_rotation


def velo2cam() -> np.ndarray:
    """Velodyne -> camera extrinsics, TRANSPOSED as the reference's property
    returns them (KITTI/dataset.py:196-208)."""
    R = np.array([
        7.533745e-03, -9.999714e-01, -6.166020e-04, 1.480249e-02,
        7.280733e-04, -9.998902e-01, 9.998621e-01, 7.523790e-03,
        1.480755e-02]).reshape(3, 3)
    T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01]).reshape(3, 1)
    return np.vstack((np.hstack([R, T]), [0, 0, 0, 1])).T


def icp_point_to_point(src: np.ndarray, tgt: np.ndarray, max_dist: float = 0.20,
                       max_iter: int = 200, tol: float = 1e-7) -> np.ndarray:
    """Point-to-point ICP: nearest-neighbour correspondences within
    ``max_dist``, then Kabsch; stops when the mean squared distance changes
    by less than ``tol``.  Returns the 4x4 correction mapping ``src`` onto
    ``tgt``."""
    from scipy.spatial import cKDTree

    tree = cKDTree(tgt)
    T = np.eye(4)
    cur = src.copy()
    prev_err = np.inf
    for _ in range(max_iter):
        d, nn = tree.query(cur, k=1, distance_upper_bound=max_dist)
        ok = np.isfinite(d)
        if ok.sum() < 10:
            break
        a, b = cur[ok], tgt[nn[ok]]
        ca, cb = a.mean(0), b.mean(0)
        H = (a - ca).T @ (b - cb)
        U, S, Vt = np.linalg.svd(H)
        D = np.diag([1.0, 1.0, np.linalg.det(Vt.T @ U.T)])
        R = Vt.T @ D @ U.T
        t = cb - R @ ca
        step = np.eye(4)
        step[:3, :3], step[:3, 3] = R, t
        cur = cur @ R.T + t
        T = step @ T
        err = float((d[ok] ** 2).mean())
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return T


class KITTIDataset:
    """split in {'train', 'val', 'test'}.  ``rs`` feeds the training split's
    jitter and rotation draws; left None, every item draws from a fresh
    unseeded ``RandomState`` as the reference does."""

    DATA_FILES = {"train": "train_kitti.txt", "val": "val_kitti.txt",
                  "test": "test_kitti.txt"}
    # sequence splits of the KITTI odometry registration protocol
    DEFAULT_SEQS = {"train": range(0, 6), "val": range(6, 8),
                    "test": range(8, 11)}

    def __init__(self, split: str, config: Config,
                 rs: Optional[np.random.RandomState] = None):
        self.config = config
        self.split = split
        self.rs = rs
        self.pc_path = os.path.join(config.data.root, "dataset")
        self.icp_path = os.path.join(config.data.root, "icp")
        os.makedirs(self.icp_path, exist_ok=True)
        self.files: List[Tuple[int, int, int]] = []
        self._odometry_cache: Dict[int, np.ndarray] = {}
        self._mine_pairs(split)

    def _seq_list(self, split: str):
        path = os.path.join(self.config.data.root, self.DATA_FILES[split])
        if os.path.exists(path):
            with open(path) as f:
                return [int(s) for s in f.read().split()]
        return list(self.DEFAULT_SEQS[split])

    def _mine_pairs(self, split: str) -> None:
        for drive_id in self._seq_list(split):
            fnames = glob.glob(
                self.pc_path + "/sequences/%02d/velodyne/*.bin" % drive_id)
            if not fnames:
                continue
            inames = sorted(int(os.path.split(f)[-1][:-4]) for f in fnames)
            Ts = self.get_positions(drive_id)[:, :3, 3]
            pdist = np.sqrt(((Ts[None] - Ts[:, None]) ** 2).sum(-1))
            more_than_10 = pdist > 10
            curr = inames[0]
            while curr in inames:
                nxt = np.where(more_than_10[curr][curr:curr + 100])[0]
                if len(nxt) == 0:
                    curr += 1
                    continue
                nxt = int(nxt[0]) + curr - 1
                if nxt in inames:
                    self.files.append((drive_id, curr, nxt))
                    curr = nxt + 1
                else:
                    curr += 1
        if split == "test" and (8, 15, 58) in self.files:
            self.files.remove((8, 15, 58))   # known bad pair (dataset.py:72)

    def get_positions(self, drive: int) -> np.ndarray:
        """[T, 4, 4] camera poses of a drive (``poses/<drive>.txt``)."""
        if drive not in self._odometry_cache:
            data = np.genfromtxt(self.pc_path + "/poses/%02d.txt" % drive)
            self._odometry_cache[drive] = np.concatenate(
                [data.reshape(-1, 3, 4),
                 np.tile(np.array([[[0, 0, 0, 1.0]]]), (len(data), 1, 1))],
                axis=1)
        return self._odometry_cache[drive]

    def _velodyne(self, drive: int, t: int) -> np.ndarray:
        fname = self.pc_path + "/sequences/%02d/velodyne/%06d.bin" % (drive, t)
        return np.fromfile(fname, dtype=np.float32).reshape(-1, 4)[:, :3]

    def gt_pose(self, drive: int, t0: int, t1: int,
                xyz0: np.ndarray, xyz1: np.ndarray) -> np.ndarray:
        """ICP-refined ground truth, cached on disk (KITTI/dataset.py:95-117)."""
        fname = os.path.join(self.icp_path, "%d_%d_%d.npy" % (drive, t0, t1))
        if os.path.exists(fname):
            return np.load(fname)
        pos = self.get_positions(drive)
        M = (velo2cam() @ pos[t0].T @ np.linalg.inv(pos[t1].T)
             @ np.linalg.inv(velo2cam())).T
        xyz0_t = xyz0 @ M[:3, :3].T + M[:3, 3]
        # ICP on 5 cm subsamples: the refinement needs ~cm accuracy
        sub0 = voxel_subsample_host(xyz0_t.astype(np.float32), 0.05)
        sub1 = voxel_subsample_host(xyz1.astype(np.float32), 0.05)
        reg = icp_point_to_point(sub0, sub1, max_dist=0.20, max_iter=200)
        # the reference's composition order (KITTI/dataset.py:110)
        M2 = M @ reg
        np.save(fname, M2)
        return M2

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> Dict:
        cfg = self.config
        drive, t0, t1 = self.files[index]
        xyz0 = self._velodyne(drive, t0)
        xyz1 = self._velodyne(drive, t1)
        trans = self.gt_pose(drive, t0, t1, xyz0, xyz1)

        if self.split != "test":
            rs = self.rs if self.rs is not None else np.random.RandomState()
            noise = cfg.train.augmentation_noise
            xyz0 = xyz0 + (rs.rand(*xyz0.shape) - 0.5) * noise
            xyz1 = xyz1 + (rs.rand(*xyz1.shape) - 0.5) * noise

        src = voxel_subsample_host(xyz0.astype(np.float32), cfg.data.downsample)
        tgt = voxel_subsample_host(xyz1.astype(np.float32), cfg.data.downsample)

        if self.split != "test":
            # SO(3) for Ref, SO(2) otherwise (KITTI/dataset.py:132-141)
            R = _np_rotation(rs, 3 if cfg.stage == "Ref" else 1)
            aug = np.eye(4)
            aug[:3, :3] = R
            tgt = tgt @ R.T
            relt_pose = aug @ trans
        else:
            relt_pose = trans

        return {
            "src_fds_pts": src.astype(np.float32),
            "tgt_fds_pts": tgt.astype(np.float32),
            "relt_pose": relt_pose.astype(np.float32),
            "src_id": f"{drive:02d}/{t0}",
            "tgt_id": f"{drive:02d}/{t1}",
        }
