"""The convolutions of ``CylindricalNet`` and ``CostNet`` in inference, each
one launch of ``csrc/conv.cu``: a float32 implicit GEMM on the CUDA cores
with the convolution's epilogue in its store.

None replaces a TPU kernel: the JAX package leaves the convolutions to XLA
(``replaces`` names the JAX convolution).  Three stores, one a call site:

- :func:`conv_pad_cuda`: a cylindrical convolution with its bias, batch
  norm and ReLU, written as the next convolution's padded input
  (``pad_cyl_2d``'s azimuth wrap and zero rows), channels last;
- :func:`conv_bn_relu_cuda`: a CostNet convolution with its bias, batch norm
  and ReLU, channels last;
- :func:`conv_bias_cuda`: the last convolution of each net, with its bias
  alone, channels first.

Each reads its input channels last and dense (a map in another layout is
copied into it first; the inference path hands over none) and the weights
in PyTorch's own layout.  The plain versions are the modules as train mode
runs them (``pad_cyl_2d`` after the convolution, batch norm and ReLU; the
convolution, batch norm and ReLU; the convolution), and each wrapper takes
its plain version for CPU tensors only; a CUDA tensor goes to the kernel
or raises, and so does a shape the kernel has no plan for (:func:`plan`),
on either device.  The kernel sums in another order than cuDNN, so the
two agree to rounding, not bit for bit; every launch sums in the same
order, so it repeats bit for bit.  No wrapper has a backward: each raises
when an input asks for a gradient.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels.cuda import F as Fl, I, P

CONV = cuda.register(cuda.Kernel(
    "conv", "buffer_tpu_torch/csrc/conv.cu", "conv_launch",
    [P, I, I, I, I, I, P, I, I, I, I, P, P, P, Fl, I, P, P],
    "buffer_tpu/nn/cylindrical.py:77"))

# csrc/conv.cu's stores
PAD, DENSE, BIAS = 0, 1, 2
THREADS = 256                # a block's threads
MAX_TAPS = 27


def plan(taps: int, cout: int, store: int):
    """(BN, TG) of ``csrc/conv.cu``'s launcher for a convolution of
    ``taps`` taps into ``cout`` channels with ``store``: the block's output
    channels and the taps of a chunk; None where it launches nothing."""
    if cout % 4 or taps > MAX_TAPS:
        return None
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128
    if bn > 32 and taps % 9 == 0 and store != BIAS:
        return bn, 9
    if bn == 32 and taps % 3 == 0:
        return bn, 3
    if bn == 32 and taps == 4 and store == BIAS:
        return bn, 4
    return None


def _check(name: str, conv: nn.Module, x: torch.Tensor, bn, store) -> None:
    """A valid, stride-1, ungrouped convolution with a bias over x's
    channels (float32, [B, C, H, W] or [B, C, D, H, W], a multiple of 4)
    that the kernel has a plan for, and where given the eval-mode batch
    norm without affine terms after it; nothing that asks for a
    gradient."""
    if x.dim() not in (4, 5) or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be float32 [B, C, H, W] or "
                         f"[B, C, D, H, W], not {x.dtype} {tuple(x.shape)}")
    if not (isinstance(conv, (nn.Conv2d, nn.Conv3d))
            and x.dim() == conv.weight.dim() and x.shape[1] == conv.in_channels
            and conv.bias is not None and conv.groups == 1
            and set(conv.stride) == {1} and set(conv.dilation) == {1}
            and conv.padding in ("valid", (0,) * (x.dim() - 2))):
        raise ValueError(f"{name}: {conv} is not a valid stride-1 convolution "
                         f"with a bias over x {tuple(x.shape)}")
    if conv.in_channels % 4 or plan(conv.weight[0, 0].numel(),
                                    conv.out_channels, store) is None:
        raise ValueError(f"{name}: the kernel has no plan for {conv}")
    if bn is not None and not (
            isinstance(bn, nn.modules.batchnorm._BatchNorm) and not bn.affine
            and bn.running_mean is not None and not bn.training
            and bn.num_features == conv.out_channels):
        raise ValueError(f"{name}: {bn} is not an eval-mode batch norm "
                         f"without affine terms over {conv.out_channels} "
                         "channels")
    cuda.check_no_grad(name, x, conv.weight, conv.bias)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """x [B, C, (D,) H, W] as the kernel reads it: [B, (D,) H, W, C],
    dense; a view where x is channels last already, else a copy."""
    xl = x.permute(0, *range(2, x.dim()), 1)
    return xl if xl.is_contiguous() else xl.contiguous()


def _launch(name: str, conv: nn.Module, x: torch.Tensor, bn, store: int):
    """The kernel's output for ``conv`` over x with ``store``, as a view of
    the shape and layout its plain version gives."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must lie on a CUDA device")
    params = [conv.weight, conv.bias] + (
        [] if bn is None else [bn.running_mean, bn.running_var])
    if any(t.device != x.device for t in params):
        raise ValueError(f"{name}: all tensors must lie on one CUDA device")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in params):
        raise ValueError(f"{name}: parameters must be contiguous float32")
    xl = channels_last(x if x.dim() == 5 else x.unsqueeze(2))
    B, D, H, W, C = xl.shape
    KD, KH, KW = conv.weight.shape[2:] if x.dim() == 5 else (
        1, *conv.weight.shape[2:])
    Cout = conv.out_channels
    Do, Ho, Wo = D - KD + 1, H - KH + 1, W - KW + 1
    if min(Do, Ho, Wo) < 1:
        raise ValueError(f"{name}: the kernel {tuple(conv.weight.shape[2:])} "
                         f"is larger than x {tuple(x.shape)}")
    if store == PAD:
        if Do != 1:
            raise ValueError(f"{name}: a padded store needs a depth of 1 "
                             f"after the convolution, not {Do}")
        out = torch.empty((B, 1, Ho + 2, Wo + 2, Cout), dtype=torch.float32,
                          device=x.device)
    elif store == DENSE:
        out = torch.empty((B, Do, Ho, Wo, Cout), dtype=torch.float32,
                          device=x.device)
    else:
        out = torch.empty((B, Cout, Do, Ho, Wo), dtype=torch.float32,
                          device=x.device)
    if B:
        CONV.launch(xl.data_ptr(), B, D, H, W, C, conv.weight.data_ptr(),
                    Cout, KD, KH, KW, conv.bias.data_ptr(),
                    None if bn is None else bn.running_mean.data_ptr(),
                    None if bn is None else bn.running_var.data_ptr(),
                    0.0 if bn is None else bn.eps, store, out.data_ptr(),
                    cuda.stream_handle(x))
    if store != BIAS:
        out = out.permute(0, 4, 1, 2, 3)
    return out if x.dim() == 5 else out[:, :, 0]


def conv_pad_plain(conv: nn.Module, bn: nn.Module,
                   x: torch.Tensor) -> torch.Tensor:
    """:func:`conv_pad_cuda` through the modules:
    ``pad_cyl_2d(relu(bn(conv(x))), 3)``."""
    # imported here: nn/cylindrical.py imports this module
    from buffer_tpu_torch.nn.cylindrical import pad_cyl_2d
    return pad_cyl_2d(torch.relu(bn(conv(x))), 3)


def conv_pad_cuda(conv: nn.Module, bn: nn.Module,
                  x: torch.Tensor) -> torch.Tensor:
    """A cylindrical convolution with its bias, batch norm and ReLU, and
    the next convolution's padded input: ``pad_cyl_2d(relu(bn(conv(x))),
    3)`` ([B, Cout, (1,) H + 2, W + 2]), stored channels last; one launch."""
    _check("conv_pad", conv, x, bn, PAD)
    if x.device.type == "cpu":
        return conv_pad_plain(conv, bn, x)
    return _launch("conv_pad", conv, x, bn, PAD)


def conv_bn_relu_plain(conv: nn.Module, bn: nn.Module,
                       x: torch.Tensor) -> torch.Tensor:
    """``relu(bn(conv(x)))`` through the modules."""
    return torch.relu(bn(conv(x)))


def conv_bn_relu_cuda(conv: nn.Module, bn: nn.Module,
                      x: torch.Tensor) -> torch.Tensor:
    """A convolution with its bias, batch norm and ReLU:
    ``relu(bn(conv(x)))``, stored channels last; one launch."""
    _check("conv_bn_relu", conv, x, bn, DENSE)
    if x.device.type == "cpu":
        return conv_bn_relu_plain(conv, bn, x)
    return _launch("conv_bn_relu", conv, x, bn, DENSE)


def conv_bias_plain(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` through the module."""
    return conv(x)


def conv_bias_cuda(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A convolution with its bias alone: ``conv(x)``, stored channels
    first; one launch."""
    _check("conv_bias", conv, x, None, BIAS)
    if x.device.type == "cpu":
        return conv_bias_plain(conv, x)
    return _launch("conv_bias", conv, x, None, BIAS)
