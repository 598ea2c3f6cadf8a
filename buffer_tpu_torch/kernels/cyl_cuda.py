"""The copies around the descriptor and cost-volume convolutions in
inference, each one launch of ``csrc/cyl.cu``: the cylindrical padding of
every ``CylindricalNet`` convolution's input, written with the bias, batch
norm and ReLU of the convolution before it; ``CostNet``'s bias, batch
norms and ReLUs in place; the cost volume in one pass.

None replaces a TPU kernel: the JAX package leaves these steps to XLA
(``replaces`` names the JAX function: ``pad_cyl_2d``, ``CostNet``,
``CostVolume``), which fuses them, while in PyTorch each is a library
pass or several over the whole map (concatenations, 20 rolls and a stack,
a broadcast subtraction, the convolution's bias, a batch norm and a ReLU
apiece).  The convolutions stay cuDNN's: on the card a wrapper runs its
convolution without the bias, which PyTorch adds after cuDNN as a pass of
its own, and adds it in the kernel.  The plain versions are the operations
the kernels replace, as train mode runs them: ``nn/cylindrical.py``'s
``pad_cyl_2d`` after the convolution, batch norm and ReLU modules, and
``models/heads.py``'s ``cost_volume``.  Each kernel value is one float32
operation of those passes, in the same memory layout, so kernel and plain
version agree bit for bit.  Each wrapper takes its plain version for CPU
tensors only; a CUDA tensor goes to the kernel or raises.  A map of
``LAUNCH_ELEMENTS`` elements or more is split along its batch, one launch
a part; an empty batch launches nothing.  None has a backward: each
raises when an input asks for a gradient.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels.cuda import F as Fl, I, P

CYL_PAD = cuda.register(cuda.Kernel(
    "cyl_pad", "buffer_tpu_torch/csrc/cyl.cu", "cyl_pad_launch",
    [P, I, I, I, I, I, I, I, I, I, I, P, P, P, Fl, I, P, P],
    "buffer_tpu/nn/cylindrical.py:39"))
BN_RELU = cuda.register(cuda.Kernel(
    "bn_relu", "buffer_tpu_torch/csrc/cyl.cu", "bn_relu_launch",
    [P, I, I, I, P, P, P, Fl, P], "buffer_tpu/nn/cylindrical.py:96"))
COST_VOLUME = cuda.register(cuda.Kernel(
    "cost_volume", "buffer_tpu_torch/csrc/cyl.cu", "cost_volume_launch",
    [P, P, I, I, I, I, I, I, I, I, I, I, I, I, P, P],
    "buffer_tpu/models/heads.py:30"))


def padded_format(x: torch.Tensor) -> torch.memory_format:
    """The memory format of ``pad_cyl_2d(x, 3)``, whose concatenations keep
    x's: channels last where the channels are x's innermost dimension."""
    if x.shape[1] > 1 and x.stride(1) == 1:
        return torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    return torch.contiguous_format


def _check_map(name: str, x: torch.Tensor) -> None:
    if x.dim() not in (4, 5) or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be float32 [B, C, H, W] or "
                         f"[B, C, D, H, W], not {x.dtype} {tuple(x.shape)}")


def _check_layer(name: str, conv: nn.Module, bn: nn.Module,
                 x: torch.Tensor) -> None:
    """A convolution (zero padding) of x's channels and the eval-mode
    batch norm without affine terms after it."""
    if not (isinstance(conv, (nn.Conv2d, nn.Conv3d))
            and conv.padding_mode == "zeros"
            and x.dim() == conv.weight.dim() and x.shape[1] == conv.in_channels):
        raise ValueError(f"{name}: {conv} does not take x {tuple(x.shape)}")
    if not (isinstance(bn, nn.modules.batchnorm._BatchNorm) and not bn.affine
            and bn.running_mean is not None and not bn.training
            and bn.num_features == conv.out_channels):
        raise ValueError(f"{name}: {bn} is not an eval-mode batch norm "
                         f"without affine terms over {conv.out_channels} "
                         "channels")


def _check_card(name: str, x: torch.Tensor, *params: torch.Tensor) -> None:
    """x on a CUDA device in any strides within 32-bit offsets, the
    parameters contiguous float32 beside it."""
    cuda.check_no_grad(name, x, *params)
    if params:
        cuda.check_cuda(name, *params)
    if x.device.type != "cuda" or any(t.device != x.device for t in params):
        raise ValueError(f"{name}: all tensors must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in params):
        raise ValueError(f"{name}: parameters must be float32")
    if max(x.stride()) >= 2 ** 31:
        raise ValueError(f"{name}: strides past 32 bits")


def _layer_params(conv: nn.Module, bn: nn.Module) -> tuple:
    return (conv.weight, bn.running_mean, bn.running_var) + (
        () if conv.bias is None else (conv.bias,))


def _without_bias(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The convolution as cuDNN computes it, before PyTorch adds the
    bias."""
    fn = F.conv2d if isinstance(conv, nn.Conv2d) else F.conv3d
    return fn(x, conv.weight, None, conv.stride, conv.padding, conv.dilation,
              conv.groups)


def _ptr(t):
    return None if t is None else t.data_ptr()


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


def _pad(y: torch.Tensor, conv=None, bn=None) -> torch.Tensor:
    """y's padded map in its memory format, with the bias of ``conv``
    added and ``bn`` and a ReLU applied first where given: one launch a
    part of the batch."""
    ys = y if y.dim() == 5 else y.unsqueeze(2)
    B, C, R, H, W = ys.shape
    fmt = padded_format(y)
    out = torch.empty((*y.shape[:-2], H + 2, W + 2), dtype=torch.float32,
                      device=y.device, memory_format=fmt)
    for part in _parts("cyl_pad", B, C * R * (H + 2) * (W + 2)):
        x = ys[part]
        CYL_PAD.launch(x.data_ptr(), x.shape[0], C, R, H, W, *ys.stride(),
                       _ptr(None if conv is None else conv.bias),
                       _ptr(None if bn is None else bn.running_mean),
                       _ptr(None if bn is None else bn.running_var),
                       0.0 if bn is None else bn.eps,
                       int(fmt != torch.contiguous_format),
                       out[part].data_ptr(), cuda.stream_handle(y))
    return out


def _bn_relu(y: torch.Tensor, conv, bn) -> torch.Tensor:
    """The bias of ``conv``, ``bn`` and a ReLU over y in place: one launch
    a part of the batch."""
    if y.is_contiguous():
        inner = math.prod(y.shape[2:])
    elif y.is_contiguous(memory_format=(torch.channels_last if y.dim() == 4
                                        else torch.channels_last_3d)):
        inner = 1
    else:
        raise ValueError("bn_relu: the convolution's output is neither "
                         "channels first nor channels last")
    for part in _parts("bn_relu", y.shape[0], y[:1].numel()):
        x = y[part]
        BN_RELU.launch(x.data_ptr(), x.numel(), y.shape[1], inner,
                       _ptr(conv.bias), bn.running_mean.data_ptr(),
                       bn.running_var.data_ptr(), bn.eps,
                       cuda.stream_handle(y))
    return y


def cyl_pad_plain(x: torch.Tensor) -> torch.Tensor:
    """:func:`cyl_pad_cuda` as train mode runs it: ``pad_cyl_2d(x, 3)``."""
    # imported here: nn/cylindrical.py imports this module
    from buffer_tpu_torch.nn.cylindrical import pad_cyl_2d
    return pad_cyl_2d(x, 3)


def cyl_pad_cuda(x: torch.Tensor) -> torch.Tensor:
    """Conv 0's input: x [B, C, H, W] or [B, C, R, H, W] (any strides) ->
    ``pad_cyl_2d(x, 3)``, [..., H + 2, W + 2] in its memory format
    (:func:`padded_format`)."""
    _check_map("cyl_pad", x)
    if x.device.type == "cpu":
        return cyl_pad_plain(x)
    _check_card("cyl_pad", x)
    return _pad(x)


def conv_pad_plain(conv: nn.Module, bn: nn.Module,
                   x: torch.Tensor) -> torch.Tensor:
    """:func:`conv_pad_cuda` through the modules:
    ``pad_cyl_2d(relu(bn(conv(x))), 3)``."""
    return cyl_pad_plain(torch.relu(bn(conv(x))))


def conv_pad_cuda(conv: nn.Module, bn: nn.Module,
                  x: torch.Tensor) -> torch.Tensor:
    """A cylindrical convolution with its bias, batch norm and ReLU, and
    the next convolution's padded input: ``pad_cyl_2d(relu(bn(conv(x))),
    3)`` in the memory format of the convolution's output; the epilogue is
    one launch."""
    _check_map("conv_pad", x)
    _check_layer("conv_pad", conv, bn, x)
    if x.device.type == "cpu":
        return conv_pad_plain(conv, bn, x)
    _check_card("conv_pad", x, *_layer_params(conv, bn))
    return _pad(_without_bias(conv, x), conv, bn)


def conv_bn_relu_plain(conv: nn.Module, bn: nn.Module,
                       x: torch.Tensor) -> torch.Tensor:
    """``relu(bn(conv(x)))`` through the modules."""
    return torch.relu(bn(conv(x)))


def conv_bn_relu_cuda(conv: nn.Module, bn: nn.Module,
                      x: torch.Tensor) -> torch.Tensor:
    """A convolution with its bias, batch norm and ReLU:
    ``relu(bn(conv(x)))``; the epilogue is one launch over the
    convolution's output (dense, channels first or last), in place."""
    _check_map("conv_bn_relu", x)
    _check_layer("conv_bn_relu", conv, bn, x)
    if x.device.type == "cpu":
        return conv_bn_relu_plain(conv, bn, x)
    _check_card("conv_bn_relu", x, *_layer_params(conv, bn))
    return _bn_relu(_without_bias(conv, x), conv, bn)


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
