"""Configuration for buffer_tpu_torch.

A copy of the JAX package's configuration (``buffer_tpu/config.py``): the
same typed dataclass trees, field names, defaults and presets, so one
preset means the same model and static plan in both packages.  The
history behind each default lives beside the reference copy; only the
meaning of each field is repeated here.

``StaticConfig`` keeps its padded-shape plan: the port runs the same
static shapes with validity masks so its outputs line up with the
reference tensor for tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Mirrors ``_C.data`` (ThreeDMatch/config.py:8-15)."""

    dataset: str = "3DMatch"
    root: str = "data/ThreeDMatch"
    downsample: float = 0.02          # first voxel downsampling
    voxel_size_0: float = 0.035       # second voxel downsampling
    voxel_size_1: float = 0.035       # model's native voxel size (for scale)
    max_numPts: int = 30000
    manual_seed: int = 123


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors ``_C.train`` (ThreeDMatch/config.py:18-26)."""

    epoch: int = 10
    max_iter: int = 50000
    batch_size: int = 1
    num_workers: int = 0
    pos_num: int = 512
    augmentation_noise: float = 0.001
    pretrain_model: str = ""
    all_stage: Tuple[str, ...] = ("Ref", "Desc", "Keypt", "Inlier")


@dataclass(frozen=True)
class TestConfig:
    """Mirrors ``_C.test`` (ThreeDMatch/config.py:29-32).  ``scale``
    (= voxel_size_0 / voxel_size_1) divides every conv neighbourhood
    offset."""

    scale: float = 1.0
    experiment_id: str = "tpu"
    pose_refine: bool = True


@dataclass(frozen=True)
class OptimConfig:
    """Mirrors ``_C.optim`` (ThreeDMatch/config.py:35-39)."""

    lr: Dict[str, float] = field(
        default_factory=lambda: {"Ref": 0.005, "Desc": 0.001, "Keypt": 0.001, "Inlier": 0.001}
    )
    lr_decay: float = 0.50
    weight_decay: float = 1e-6
    scheduler_interval: Dict[str, int] = field(
        default_factory=lambda: {"Ref": 1, "Desc": 2, "Keypt": 1, "Inlier": 1}
    )


@dataclass(frozen=True)
class PointConfig:
    """Mirrors ``_C.point`` (ThreeDMatch/config.py:42-48)."""

    in_points_dim: int = 3
    in_feats_dim: int = 3
    first_feats_dim: int = 32
    conv_radius: float = 2.0
    keypts_th: float = 0.1
    num_keypts: int = 1500


@dataclass(frozen=True)
class PatchConfig:
    """Mirrors ``_C.patch`` (ThreeDMatch/config.py:51-58)."""

    des_r: float = 0.3
    num_points_per_patch: int = 512
    rad_n: int = 3
    azi_n: int = 20
    ele_n: int = 7
    delta: float = 0.8
    voxel_sample: int = 10


@dataclass(frozen=True)
class MatchConfig:
    """Mirrors ``_C.match`` (ThreeDMatch/config.py:61-66);
    ``hypotheses`` is the batch of RANSAC hypotheses scored at once."""

    dist_th: float = 0.10
    inlier_th: float = 1.0 / 3.0
    similar_th: float = 0.8
    confidence: float = 0.999
    iter_n: int = 50000
    hypotheses: int = 1024


@dataclass(frozen=True)
class StaticConfig:
    """The padded-shape plan: every ragged array of the reference is padded
    to these sizes and carried with a validity mask."""

    # per-cloud padded point counts of the 3-level conv pyramid
    points_l0: int = 30720
    points_l1: int = 10240
    points_l2: int = 3072
    # padded size of the raw (first-downsample) cloud used for patches
    raw_points: int = 65536
    # neighbour-list caps per level and pool caps per strided block
    neighbor_caps: Tuple[int, int, int] = (16, 16, 16)
    pool_caps: Tuple[int, int] = (16, 16)
    # matches kept after mutual matching
    max_matches: int = 1500
    # IRLS refinement rounds
    refine_iters: int = 10
    # kNN used for PCA normal estimation
    normal_knn: int = 16
    # chunk size of tiled distance computations
    knn_chunk: int = 4096
    # half-width of the rank window of the banded neighbour search on
    # Morton-ordered clouds; 0 disables.  Ignored when 2*band >= support
    # (dispatch: ops/neighbors.py).
    knn_band: int = 4096
    # inference descriptor front: fused SPT (True) vs sampled SPT (False)
    fused_desc: bool = True
    # dynamic solver budget: below low_match_th mutual matches RANSAC runs
    # 4x hypotheses and IRLS 2x rounds
    low_match_boost: bool = True
    low_match_th: int = 400
    # pairs per step in the reference's bench; unused by the port
    pair_batch: int = 1
    pair_unroll: int = 3


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    point: PointConfig = field(default_factory=PointConfig)
    patch: PatchConfig = field(default_factory=PatchConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    static: StaticConfig = field(default_factory=StaticConfig)
    stage: str = "test"

    def with_stage(self, stage: str) -> "Config":
        return replace(self, stage=stage)

    def replace(self, **kw) -> "Config":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

def threedmatch_cfg() -> Config:
    """3DMatch preset (ThreeDMatch/config.py)."""
    return Config()


def threedlomatch_cfg() -> Config:
    """3DLoMatch: 3DMatch with the low-overlap split."""
    c = threedmatch_cfg()
    return c.replace(data=replace(c.data, dataset="3DLoMatch"))


def kitti_cfg() -> Config:
    """KITTI odometry preset (KITTI/config.py)."""
    return Config(
        data=DataConfig(
            dataset="KITTI", root="data/KITTI", downsample=0.05,
            voxel_size_0=0.30, voxel_size_1=0.30, max_numPts=40000,
        ),
        train=TrainConfig(epoch=50, augmentation_noise=0.01),
        test=TestConfig(scale=1.0, experiment_id="tpu-kitti", pose_refine=False),
        optim=OptimConfig(
            scheduler_interval={"Ref": 5, "Desc": 10, "Keypt": 5, "Inlier": 5}
        ),
        point=PointConfig(keypts_th=0.5),
        patch=PatchConfig(des_r=3.0),
        match=MatchConfig(dist_th=0.30, inlier_th=2.0, similar_th=0.9,
                          confidence=1.0),
        static=StaticConfig(points_l0=40960, points_l1=20480, points_l2=6144,
                            raw_points=131072, pair_unroll=1),
    )


def _gen(base: Config, dataset: str, root: str, voxel_size_0: float,
         voxel_size_1: float, downsample: float, max_pts: int,
         pose_refine: bool, keypts_th: float, des_r: float,
         match: MatchConfig, static: StaticConfig) -> Config:
    return base.replace(
        data=DataConfig(dataset=dataset, root=root, downsample=downsample,
                        voxel_size_0=voxel_size_0, voxel_size_1=voxel_size_1,
                        max_numPts=max_pts),
        test=TestConfig(scale=voxel_size_0 / voxel_size_1,
                        experiment_id=base.test.experiment_id,
                        pose_refine=pose_refine),
        point=replace(base.point, keypts_th=keypts_th),
        patch=replace(base.patch, des_r=des_r),
        match=match,
        static=static,
    )


def threed2eth_cfg() -> Config:
    """ETH data with 3DMatch weights (generalization/ThreeD2ETH/config.py)."""
    return _gen(threedmatch_cfg(), "ETH", "data/ETH", 0.15, 0.03, 0.05,
                30000, False, 0.5, 1.0,
                MatchConfig(dist_th=0.20, inlier_th=1.5, similar_th=0.9,
                            confidence=1.0),
                StaticConfig())


def threed2kitti_cfg() -> Config:
    """KITTI data with 3DMatch weights (generalization/ThreeD2KITTI/config.py)."""
    return _gen(threedmatch_cfg(), "KITTI", "data/KITTI", 0.30, 0.03, 0.05,
                40000, False, 0.5, 3.0,
                MatchConfig(dist_th=0.30, inlier_th=2.0, similar_th=0.9,
                            confidence=1.0),
                StaticConfig(points_l0=40960, points_l1=16384, points_l2=6144,
                             raw_points=131072))


def kitti2threed_cfg() -> Config:
    """3DLoMatch data with KITTI weights (generalization/KITTI2ThreeD/config.py)."""
    c = kitti_cfg()
    return _gen(c, "3DLoMatch", "data/ThreeDMatch", 0.035, 0.30, 0.02,
                30000, True, 0.0, 0.3,
                MatchConfig(dist_th=0.10, inlier_th=1.0 / 3.0, similar_th=0.8,
                            confidence=0.999),
                StaticConfig())


def kitti2eth_cfg() -> Config:
    """ETH data with KITTI weights (generalization/KITTI2ETH/config.py)."""
    c = kitti_cfg()
    return _gen(c, "ETH", "data/ETH", 0.15, 0.30, 0.05,
                30000, False, 0.5, 1.0,
                MatchConfig(dist_th=0.20, inlier_th=2.0, similar_th=0.9,
                            confidence=1.0),
                StaticConfig())


PRESETS = {
    "3DMatch": threedmatch_cfg,
    "3DLoMatch": threedlomatch_cfg,
    "KITTI": kitti_cfg,
    "ThreeD2ETH": threed2eth_cfg,
    "ThreeD2KITTI": threed2kitti_cfg,
    "KITTI2ThreeD": kitti2threed_cfg,
    "KITTI2ETH": kitti2eth_cfg,
}


def make_cfg(name: str = "3DMatch") -> Config:
    return PRESETS[name]()


def unbanded(cfg: Config) -> Config:
    """``cfg`` with ``static.knn_band = 0``: the exact unbanded neighbour
    search everywhere (dense radius-kNN, exact 1-NN upsamples)."""
    return cfg.replace(static=replace(cfg.static, knn_band=0))


def tiny_cfg() -> Config:
    """A miniature static plan for tests (same fields as the reference's)."""
    c = threedmatch_cfg()
    return c.replace(
        point=replace(c.point, num_keypts=64),
        static=StaticConfig(points_l0=512, points_l1=256, points_l2=128,
                            raw_points=1024, neighbor_caps=(16, 16, 16),
                            pool_caps=(16, 16), max_matches=64,
                            normal_knn=8, knn_chunk=256,
                            low_match_boost=False),
        match=replace(c.match, hypotheses=128),
        train=replace(c.train, pos_num=32),
    )


def shrink_static(cfg: Config) -> Config:
    """Any preset with the miniature test plan of :func:`tiny_cfg`, keeping
    every data and semantic field (voxel sizes, thresholds, dataset)."""
    t = tiny_cfg()
    return cfg.replace(
        static=t.static,
        point=replace(cfg.point, num_keypts=t.point.num_keypts),
        match=replace(cfg.match, hypotheses=t.match.hypotheses),
        train=replace(cfg.train, pos_num=t.train.pos_num),
    )
