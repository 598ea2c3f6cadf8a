"""Checkpoints of the four stages (counterpart of
``buffer_tpu/train/checkpoint.py``).

A checkpoint is the whole model's state dict under the reference's key
names (``Ref.encoder_blocks.0...``), written with ``torch.save``.  The
layout is the reference's snapshot scheme: ``{save_dir}/{stage}/best.pth``
and ``{save_dir}/{stage}/{epoch}.pth`` per stage (ThreeDMatch/trainer.py:
322-326), and a composition takes each stage from its own best file
(ThreeDMatch/test.py:207-214, :func:`merge_stage_checkpoints`).
"""

from __future__ import annotations

import os
from typing import Dict

import torch


def save(model: torch.nn.Module, path: str) -> None:
    """The model's state dict, moved to the CPU, to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)


def load(path: str) -> Dict[str, torch.Tensor]:
    """A state dict written by :func:`save` (CPU tensors)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def merge_stage_checkpoints(paths: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """Per-stage checkpoint files {stage: path} -> one state dict in which
    every stage's entries come from its own file."""
    merged = {}
    for stage, path in paths.items():
        merged.update({k: v for k, v in load(path).items()
                       if k.startswith(stage + ".")})
    return merged
