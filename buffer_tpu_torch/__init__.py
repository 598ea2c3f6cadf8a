"""buffer_tpu_torch: BUFFER point-cloud registration in PyTorch and CUDA.

The port of ``buffer_tpu`` (JAX, Pallas on a TPU) to one NVIDIA H100.  It
mirrors the JAX package module for module; every Pallas kernel on the
ported path is a CUDA C++ kernel here (``csrc/``, bound in ``kernels/``).
This package imports ``torch`` and numpy only.

Entry points take ``device=None``, which means the CUDA card; they raise
when none is present and never fall back to the CPU on their own.  Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (with its index); raises when a
    CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device present; pass device='cpu' to "
                               "run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
