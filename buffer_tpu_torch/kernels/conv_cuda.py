"""The convolutions of ``CylindricalNet`` and ``CostNet`` in inference, each
one call of ``csrc/conv.cu``'s launcher: a float32 implicit GEMM on the
CUDA cores with the convolution's epilogue in its store.

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
in PyTorch's own layout.  The kernel stages a chunk's operands one of two
ways, chosen by :func:`plan` from the shapes: a halo tile of the block's
input pixels (the weights copied chunk-major by the same call first, into
a buffer the wrapper allocates), or tap by tap; :func:`path_launches`
counts the launches of each.  The plain versions are the modules as train
mode runs them (``pad_cyl_2d`` after the convolution, batch norm and ReLU; the
convolution, batch norm and ReLU; the convolution), and each wrapper takes
its plain version for CPU tensors only; a CUDA tensor goes to the kernel
or raises, and so does a shape the kernel has no plan for (:func:`plan`),
on either device.  The kernel sums in another order than cuDNN, so the
two agree to rounding, not bit for bit; every launch sums in the same
order, so it repeats bit for bit.  No wrapper has a backward: each raises
when an input asks for a gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from buffer_tpu_torch.kernels import cuda
from buffer_tpu_torch.kernels.cuda import F as Fl, I, P

CONV = cuda.register(cuda.Kernel(
    "conv", "buffer_tpu_torch/csrc/conv.cu", "conv_launch",
    [P, I, I, I, I, I, P, I, I, I, I, P, P, P, Fl, I, P, P, P],
    "buffer_tpu/nn/cylindrical.py:77"))

# csrc/conv.cu's stores
PAD, DENSE, BIAS = 0, 1, 2
THREADS = 256                # a block's threads
MAX_TAPS = 27
# a block's shared memory: two blocks an SM (half of 228 KB, less the 1 KB
# the runtime keeps a block)
MAX_SMEM = 228 * 1024 // 2 - 1024
# launches by operand staging path (csrc/conv.cu): a chunk's inputs as a
# halo tile, or tap by tap
PATHS = ("halo", "tap")
_path_launches = dict.fromkeys(PATHS, 0)


class Plan(NamedTuple):
    """A launch's plan (``csrc/conv.cu`` ``make_plan``): the staging path
    (``"halo"`` or ``"tap"``), the block's output channels ``bn`` (``bm``
    rows), a chunk's input channels ``ch`` and taps ``tg`` (per-tap path;
    the halo takes all taps), the halo tile's line, plane and image pitches
    in pixels, its plane of 16-byte words ``hp`` (one a channel quad), and
    the block's shared memory."""
    path: str
    bn: int
    ch: int
    tg: int
    wp: int
    pp: int
    ip: int
    hp: int
    smem: int

    @property
    def bm(self) -> int:
        return THREADS * 64 // self.bn


def _round_up_to(v: int, target: int, mod: int) -> int:
    """The least value >= v congruent to target modulo mod."""
    return v + (target - v) % mod


def _tap_smem(bn: int, tg: int) -> int:
    """The per-tap path's shared memory: two stages of 4 TG depth x (BM + 8)
    inputs and (BN + 8) weights."""
    return 2 * 4 * tg * (THREADS * 64 // bn + 8 + bn + 8) * 4


@functools.lru_cache(maxsize=256)
def plan(n: int, din: int, hin: int, win: int, cin: int, cout: int, kd: int,
         kh: int, kw: int, store: int) -> Optional[Plan]:
    """The plan of ``csrc/conv.cu``'s launcher for a convolution of x [n,
    din, hin, win, cin] by a (kd, kh, kw) kernel into ``cout`` channels
    with ``store``; None where it launches nothing.  The per-tap path (9
    taps a chunk) where the halo's was slower on the card: 128-channel
    blocks, and a 3-D kernel over one output plane.  Else the halo path:
    BN follows Cout, or is 64 where a 32-channel block's tile would not fit
    (tiny maps); the tile's pitches are the least above the input's extents
    that put consecutive output rows 1 apart modulo the rows of a warp (8 at
    BN 32, else 4), the line pitch kept where rows cross no line and the
    plane pitch where they cross no plane; ``hp`` the largest span of tile
    positions a block reads, rounded to 4 mod 8, under 4096; 8 input
    channels a chunk, or 4, as shared memory leaves two blocks an SM."""
    taps = kd * kh * kw
    do, ho, wo = din - kd + 1, hin - kh + 1, win - kw + 1
    if (n < 1 or cin < 4 or cin % 4 or cout < 4 or cout % 4
            or taps > MAX_TAPS or min(do, ho, wo) < 1):
        return None
    bn0 = 32 if cout <= 32 else 64 if cout <= 64 else 128
    if taps % 9 == 0 and store != BIAS and (bn0 == 128 or do == 1 < kd):
        return Plan("tap", bn0, 4, 9, 0, 0, 0, 0, _tap_smem(bn0, 9))
    p = do * ho * wo
    m = n * p
    for bn in (bn0, 64) if bn0 == 32 else (bn0,):
        if store == BIAS and bn > 64:
            return None
        bm = THREADS * 64 // bn
        rw = 8 if bn == 32 else 4
        wp = _round_up_to(win, wo, rw) if ho > 1 else win
        pp = _round_up_to(hin * wp, ho * wo, rw) if do > 1 else hin * wp
        ip = _round_up_to(din * pp, p, rw)
        if n * ip >= 1 << 31:
            return None

        def coord(r):
            i, q = divmod(r, p)
            return (i * ip + q // (ho * wo) * pp + q % (ho * wo) // wo * wp
                    + q % wo)

        def span_of(b):
            return coord(min(b * bm + bm - 1, m - 1)) - coord(b * bm)
        blocks = -(-m // bm)
        span = max([span_of(blocks - 1)] + [
            span_of(b) for b in range(min(blocks, p // math.gcd(bm, p)))])
        span += (kd - 1) * pp + (kh - 1) * wp + kw
        hp = _round_up_to(span, 4, 8)
        if hp >= 4096:              # byte offsets of 16 bits
            continue
        for ch in (8, 4):
            smem = 2 * (ch // 4 * hp * 16 + ch * taps * bn * 4)
            if cin % ch == 0 and smem <= MAX_SMEM:
                return Plan("halo", bn, ch, 0, wp, pp, ip, hp, smem)
    return None


def attributes(n: int, din: int, hin: int, win: int, cin: int, cout: int,
               kd: int, kh: int, kw: int, store: int) -> dict:
    """The instance the launcher runs for these shapes (:func:`plan`), as
    the card reports it: blocks an SM, registers and local (spill) bytes a
    thread, static and dynamic shared memory a block."""
    fn = CONV.lib.load().conv_attributes
    fn.restype, fn.argtypes = I, [I] * 10 + [P]
    out = (ctypes.c_int * 5)()
    err = fn(n, din, hin, win, cin, cout, kd, kh, kw, store, out)
    if err:
        raise RuntimeError(f"conv_attributes failed: cudaError {err}")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "static_smem", "smem"), out))


def path_launches() -> dict:
    """The wrapper's launches so far, by operand staging path (``PATHS``):
    differences of two readings count a stretch of eager calls (a replayed
    CUDA graph runs no wrapper and adds none)."""
    return dict(_path_launches)


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
    (B, D, H, W, C), (KD, KH, KW) = _dims(conv, x)
    if min(D - KD, H - KH, W - KW) < 0:
        raise ValueError(f"{name}: the kernel {tuple(conv.weight.shape[2:])} "
                         f"is larger than x {tuple(x.shape)}")
    if store == PAD and D - KD != 0:
        raise ValueError(f"{name}: a padded store needs a depth of 1 after "
                         f"the convolution, not {D - KD + 1}")
    if plan(max(B, 1), D, H, W, C, conv.out_channels, KD, KH, KW,
            store) is None:
        raise ValueError(f"{name}: the kernel has no plan for {conv} over x "
                         f"{tuple(x.shape)}")
    if bn is not None and not (
            isinstance(bn, nn.modules.batchnorm._BatchNorm) and not bn.affine
            and bn.running_mean is not None and not bn.training
            and bn.num_features == conv.out_channels):
        raise ValueError(f"{name}: {bn} is not an eval-mode batch norm "
                         f"without affine terms over {conv.out_channels} "
                         "channels")
    cuda.check_no_grad(name, x, conv.weight, conv.bias)


def _dims(conv: nn.Module, x: torch.Tensor) -> tuple:
    """((B, D, H, W, C), (KD, KH, KW)): x and the kernel as the launcher
    takes them, a 2-D convolution with a depth of 1."""
    B, C, *space = x.shape
    k = tuple(conv.weight.shape[2:])
    if x.dim() == 4:
        space, k = [1, *space], (1, *k)
    return (B, *space, C), k


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
    (B, D, H, W, C), (KD, KH, KW) = _dims(conv, x)
    Cout = conv.out_channels
    Do, Ho, Wo = D - KD + 1, H - KH + 1, W - KW + 1
    if store == PAD:
        out = torch.empty((B, 1, Ho + 2, Wo + 2, Cout), dtype=torch.float32,
                          device=x.device)
    elif store == DENSE:
        out = torch.empty((B, Do, Ho, Wo, Cout), dtype=torch.float32,
                          device=x.device)
    else:
        out = torch.empty((B, Cout, Do, Ho, Wo), dtype=torch.float32,
                          device=x.device)
    if B:
        path = plan(B, D, H, W, C, Cout, KD, KH, KW, store).path
        # the halo path's weights as the kernel stages them, written by the
        # launch
        wt = (torch.empty(conv.weight.numel(), dtype=torch.float32,
                          device=x.device) if path == "halo" else None)
        CONV.launch(xl.data_ptr(), B, D, H, W, C, conv.weight.data_ptr(),
                    Cout, KD, KH, KW, conv.bias.data_ptr(),
                    None if bn is None else bn.running_mean.data_ptr(),
                    None if bn is None else bn.running_var.data_ptr(),
                    0.0 if bn is None else bn.eps, store, out.data_ptr(),
                    None if wt is None else wt.data_ptr(),
                    cuda.stream_handle(x))
        _path_launches[path] += 1
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
