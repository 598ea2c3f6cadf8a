"""Reference snapshots -> a :class:`BufferModel` (counterpart of the
reference-snapshot half of ``buffer_tpu/compat/torch_convert.py``).

The reference saves the *whole* composite state dict in each trained
stage's ``best.pth`` and composes a model by keeping, from each stage's
file, the keys that contain the stage's name (``ThreeDMatch/test.py:207-214``,
``ThreeDMatch/train.py:37-47``).  The port's modules carry the reference's
key names, so the merged dict loads as it is; no layout conversion.
"""

from __future__ import annotations

from typing import Dict

import torch

from buffer_tpu_torch import resolve_device
from buffer_tpu_torch.config import Config
from buffer_tpu_torch.models.composite import BufferModel


def _counter(key: str) -> bool:
    return key.endswith("num_batches_tracked")


def load_reference_checkpoint(paths: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """The reference's key-substring merge of per-stage ``best.pth`` files;
    ``paths``: stage name -> file.  CPU tensors."""
    merged: Dict[str, torch.Tensor] = {}
    for stage, path in paths.items():
        sd = torch.load(path, map_location="cpu", weights_only=True)
        merged.update({k: v for k, v in sd.items() if stage in k})
    return merged


def load_reference_model(cfg: Config, paths: Dict[str, str],
                         device=None) -> BufferModel:
    """A :class:`BufferModel` of ``cfg`` holding the merged snapshot of
    ``paths``, on ``device`` (default: the CUDA card), in eval mode.

    Batch-norm ``num_batches_tracked`` counters are ignored on both sides
    (the model keeps its own).  Raises when the files miss any other
    parameter or buffer of the model, or hold a key the model does not
    have: no weight may keep its random initial value unnoticed."""
    sd = {k: v for k, v in load_reference_checkpoint(paths).items()
          if not _counter(k)}
    model = BufferModel(cfg)
    own = model.state_dict()
    missing = sorted(k for k in own if not _counter(k) and k not in sd)
    unexpected = sorted(k for k in sd if k not in own)
    if missing or unexpected:
        raise KeyError(f"reference snapshot does not match the model: "
                       f"missing {missing[:8]} ({len(missing)} in all), "
                       f"unexpected {unexpected[:8]} ({len(unexpected)} in all)")
    own.update(sd)
    model.load_state_dict(own)
    return model.to(resolve_device(device))
