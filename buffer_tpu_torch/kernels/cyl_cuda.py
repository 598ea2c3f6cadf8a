"""The copies around the descriptor and cost-volume convolutions in
inference, each one launch of ``csrc/cyl.cu``: conv 0's cylindrical
padding, written channels last as the convolution kernel
(``kernels/conv_cuda.py``) reads it, and the cost volume in one pass.  The
convolution kernel writes every later padded input in its own store.

None replaces a TPU kernel: the JAX package leaves these steps to XLA
(``replaces`` names the JAX function: ``pad_cyl_2d``, ``CostVolume``),
which fuses them, while in PyTorch each is a library pass or several over
the whole map (concatenations; 20 rolls, a stack and a broadcast
subtraction).  The plain versions are the operations the kernels replace,
as train mode runs them: ``nn/cylindrical.py``'s ``pad_cyl_2d`` and
``models/heads.py``'s ``cost_volume``.  Each kernel value is a copy or one
float32 subtraction of those passes, so kernel and plain version agree bit
for bit (the padded map in another memory layout).  Each wrapper takes its
plain version for CPU tensors only; a CUDA tensor goes to the kernel or
raises.  A map of ``LAUNCH_ELEMENTS`` elements or more is split along its
batch, one launch a part; an empty batch launches nothing.  Neither has a
backward: each raises when an input asks for a gradient.
"""

from __future__ import annotations

import torch

from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels.cuda import I, P

CYL_PAD = cuda.register(cuda.Kernel(
    "cyl_pad", "buffer_tpu_torch/csrc/cyl.cu", "cyl_pad_launch",
    [P, I, I, I, I, I, I, I, I, I, I, P, P],
    "buffer_tpu/nn/cylindrical.py:39"))
COST_VOLUME = cuda.register(cuda.Kernel(
    "cost_volume", "buffer_tpu_torch/csrc/cyl.cu", "cost_volume_launch",
    [P, P, I, I, I, I, I, I, I, I, I, I, I, I, P, P],
    "buffer_tpu/models/heads.py:30"))


def _check_map(name: str, x: torch.Tensor) -> None:
    if x.dim() not in (4, 5) or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be float32 [B, C, H, W] or "
                         f"[B, C, D, H, W], not {x.dtype} {tuple(x.shape)}")


def _check_card(name: str, x: torch.Tensor) -> None:
    """x on a CUDA device in any strides within 32-bit offsets."""
    cuda.check_no_grad(name, x)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must lie on a CUDA device")
    if max(x.stride()) >= 2 ** 31:
        raise ValueError(f"{name}: strides past 32 bits")


# the launchers' bound on the elements of one launch (32-bit indices,
# launch-fixed divisors held exact below it)
LAUNCH_ELEMENTS = 1 << 30


def _parts(name: str, n: int, per: int) -> list:
    """Slices of a batch of n items of ``per`` elements each, every part
    below ``LAUNCH_ELEMENTS`` elements: one part at the main path's sizes,
    none for an empty map."""
    if n == 0 or per == 0:
        return []
    if per >= LAUNCH_ELEMENTS:
        raise ValueError(f"{name}: one item of {per} elements is past a "
                         "launch")
    step = (LAUNCH_ELEMENTS - 1) // per
    return [slice(b, min(b + step, n)) for b in range(0, n, step)]


def padded_empty(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised map of ``pad_cyl_2d(x, 3)``'s shape, stored
    channels last ([B, (R,) H + 2, W + 2, C] in memory)."""
    xs = x if x.dim() == 5 else x.unsqueeze(2)
    B, C, R, H, W = xs.shape
    out = torch.empty((B, R, H + 2, W + 2, C), dtype=torch.float32,
                      device=x.device).permute(0, 4, 1, 2, 3)
    return out if x.dim() == 5 else out[:, :, 0]


def _pad(x: torch.Tensor) -> torch.Tensor:
    """x's padded map, channels last: one launch a part of the batch."""
    xs = x if x.dim() == 5 else x.unsqueeze(2)
    B, C, R, H, W = xs.shape
    out = padded_empty(x)
    for part in _parts("cyl_pad", B, C * R * (H + 2) * (W + 2)):
        xp = xs[part]
        CYL_PAD.launch(xp.data_ptr(), xp.shape[0], C, R, H, W, *xs.stride(),
                       out[part].data_ptr(), cuda.stream_handle(x))
    return out


def cyl_pad_plain(x: torch.Tensor) -> torch.Tensor:
    """:func:`cyl_pad_cuda` as train mode runs it: ``pad_cyl_2d(x, 3)``."""
    # imported here: nn/cylindrical.py imports this module
    from buffer_tpu_torch.nn.cylindrical import pad_cyl_2d
    return pad_cyl_2d(x, 3)


def cyl_pad_cuda(x: torch.Tensor) -> torch.Tensor:
    """Conv 0's input: x [B, C, H, W] or [B, C, R, H, W] (any strides) ->
    ``pad_cyl_2d(x, 3)``, [..., H + 2, W + 2], stored channels last."""
    _check_map("cyl_pad", x)
    if x.device.type == "cpu":
        return cyl_pad_plain(x)
    _check_card("cyl_pad", x)
    return _pad(x)


def cost_volume_cuda(des1: torch.Tensor, des2: torch.Tensor) -> torch.Tensor:
    """The volume CostNet reads: des1, des2 [M, E, A, C] (any strides) ->
    [M, C, A (shift), E, A] with ``vol[m, :, s, e, a] = des1[m, e, (a - s)
    mod A] - des2[m, e, a]``, stored channels last ([M, A, E, A, C] in
    memory), the values and layout of ``models/heads.py:cost_volume``, its
    plain version."""
    if not (des1.dim() == 4 and des2.shape == des1.shape
            and des1.dtype == des2.dtype == torch.float32):
        raise ValueError("cost_volume: des1 and des2 must be float32 "
                         f"[M, E, A, C] alike, not {tuple(des1.shape)} and "
                         f"{tuple(des2.shape)}")
    if des1.device.type == "cpu":
        # imported here: models/heads.py imports this module
        from buffer_tpu_torch.models.heads import cost_volume
        return cost_volume(des1, des2)
    _check_card("cost_volume", des1)
    _check_card("cost_volume", des2)
    if des2.device != des1.device:
        raise ValueError("cost_volume: des1 and des2 must lie on one device")
    M, E, A, C = des1.shape
    vol = torch.empty((M, A, E, A, C), dtype=torch.float32,
                      device=des1.device)
    if M:
        COST_VOLUME.launch(des1.data_ptr(), des2.data_ptr(), M, E, A, C,
                           *des1.stride(), *des2.stride(), vol.data_ptr(),
                           cuda.stream_handle(des1))
    return vol.permute(0, 4, 1, 2, 3)
