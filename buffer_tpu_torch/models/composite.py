"""Composite BUFFER model (counterpart of ``buffer_tpu/models/composite.py``;
reference ``buffer``, models/BUFFER.py:69-79).

One ``nn.Module`` with the reference's four stages as attributes, so its
state dict carries the reference key names (``Ref.encoder_blocks.0...``)
and reference checkpoints load directly.  The model is built in eval mode
(batch norms use running statistics); training puts the active stage in
train mode (``pipeline/train_forward.stage_loss``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from buffer_tpu_torch.config import Config
from buffer_tpu_torch.models.heads import CostVolume
from buffer_tpu_torch.models.patch_embedder import MiniSpinNet
from buffer_tpu_torch.models.point_learner import EFCNN, DetNet


class BufferModel(nn.Module):
    def __init__(self, cfg: Config, seed: int = 0):
        """Builds the four stages on the CPU with PyTorch's default
        initialization drawn from the CPU generator seeded by ``seed`` (the
        caller's generator state is restored); batch-norm statistics start
        at mean 0, variance 1.  Move the model with ``.to(device)``."""
        super().__init__()
        self.cfg = cfg
        fd = cfg.point.first_feats_dim // 3
        p = cfg.patch
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.Ref = EFCNN(fd, cfg.test.scale)
            self.Desc = MiniSpinNet(p.rad_n, p.azi_n, p.ele_n)
            self.Keypt = DetNet(fd)
            self.Inlier = CostVolume(p.azi_n)
        self.eval()
