"""The copies around the descriptor and cost-volume convolutions in
inference (``kernels/cyl_cuda.py``, ``csrc/cyl.cu``) and the inference
forwards of the nets on the CPU.

The plain versions are the operations train mode runs (``pad_cyl_2d``,
``heads.cost_volume``, the modules).  Here: the padded map the kernel path
allocates is what the convolution kernel reads without a copy; the
launch-fixed division and the batch split the launchers rely on; PyTorch
models of the kernels' index arithmetic against the plain versions; the
inference forwards of ``CylindricalNet``, ``CostNet`` and ``CostVolume``
against the layer by layer path; the call sites; bad inputs.  The kernels
themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from buffer_tpu_torch.kernels import conv_cuda, cuda, cyl_cuda, sites
from buffer_tpu_torch.kernels.geom_cuda import _pooled_layout
from buffer_tpu_torch.models import heads
from buffer_tpu_torch.models.heads import CostVolume
from buffer_tpu_torch.nn import cylindrical
from buffer_tpu_torch.nn.cylindrical import CylindricalNet, pad_cyl_2d

torch.set_num_threads(1)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _map(layout: str, g) -> torch.Tensor:
    """A map in one of the layouts the convolutions meet: conv 0's input as
    the SPT kernel lays it out or as the sampled front does (channels
    last), a conv output channels first or last, conv 0's output with its
    radial dimension of 1 taken away."""
    if layout == "spt 5-D":
        return _pooled_layout(torch.randn(5, 16, 3 * 7 * 20, generator=g),
                              3, 20, 7).permute(0, 4, 1, 2, 3)
    if layout == "sampled 5-D":
        return torch.randn(5, 3, 7, 20, 16, generator=g).permute(0, 4, 1, 2, 3)
    if layout == "conv 4-D":
        return torch.randn(5, 12, 7, 20, generator=g)
    if layout == "conv 4-D channels last":
        return torch.randn(5, 12, 7, 20, generator=g).contiguous(
            memory_format=torch.channels_last)
    if layout == "conv0 output":
        return torch.randn(5, 12, 1, 7, 20, generator=g)[:, :, 0]
    if layout == "conv0 5-D output":
        return torch.randn(5, 12, 1, 7, 20, generator=g)
    if layout == "conv0 5-D output channels last":
        return torch.randn(5, 1, 7, 20, 12, generator=g).permute(0, 4, 1, 2, 3)
    raise ValueError(layout)


LAYOUTS = ["spt 5-D", "sampled 5-D", "conv 4-D", "conv 4-D channels last",
           "conv0 output"]


def _bn(C: int, g, dims: int = 2) -> nn.Module:
    """An eval-mode affine-free batch norm with drawn running statistics."""
    bn = (nn.BatchNorm2d if dims == 2 else nn.BatchNorm3d)(C, affine=False)
    bn.running_mean.copy_(torch.randn(C, generator=g))
    bn.running_var.copy_(torch.rand(C, generator=g) * 3 + 0.05)
    return bn.eval()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a, b) and a.stride() == b.stride()


def _memory(t: torch.Tensor) -> torch.Tensor:
    """A dense tensor's elements in memory order."""
    return torch.as_strided(t, (t.numel(),), (1,), t.storage_offset())


@pytest.mark.parametrize("layout", LAYOUTS + ["conv0 5-D output",
                                               "conv0 5-D output channels last"])
def test_padded_map_is_what_the_conv_kernel_reads(layout):
    """The kernel path writes conv 0's padded input into
    ``padded_empty(x)``: ``pad_cyl_2d(x, 3)``'s shape, stored channels last
    and dense, so the convolution kernel reads it as a view, in every
    layout the convolutions meet; on the CPU the wrapper is
    ``pad_cyl_2d``."""
    x = _map(layout, _gen(1))
    want = pad_cyl_2d(x, 3)
    got = cyl_cuda.padded_empty(x)
    assert got.shape == want.shape
    xl = conv_cuda.channels_last(got)
    assert xl.data_ptr() == got.data_ptr() and xl.is_contiguous()
    assert _same(cyl_cuda.cyl_pad_cuda(x), want)


def _layer(conv: nn.Module, g) -> tuple:
    """A convolution with drawn weights and bias, and an eval-mode
    affine-free batch norm with drawn running statistics after it."""
    C = conv.out_channels
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.1)
        conv.bias.copy_(torch.randn(C, generator=g))
    bn = (nn.BatchNorm2d if isinstance(conv, nn.Conv2d) else nn.BatchNorm3d)(
        C, affine=False)
    bn.running_mean.copy_(torch.randn(C, generator=g))
    bn.running_var.copy_(torch.rand(C, generator=g) * 3 + 0.05)
    return conv, bn.eval()


@pytest.mark.parametrize("fmt", [torch.channels_last_3d,
                                 torch.contiguous_format])
def test_conv_bn_relu_plain_matches_layer(fmt):
    """CostNet's epilogue: the plain version is ``CostNet.layer``'s
    convolution, batch norm and ReLU, in the channels-last layout CostNet's
    convolutions keep on the card and channels first."""
    g = _gen(3)
    conv, bn = _layer(nn.Conv3d(8, 8, (3, 1, 3)), g)
    x = torch.randn(4, 8, 6, 3, 6, generator=g).contiguous(memory_format=fmt)
    with torch.no_grad():
        assert _same(conv_cuda.conv_bn_relu_plain(conv, bn, x),
                     nn.ReLU()(bn(conv(x))))


def _descriptors(g, K=12, E=5, A=20, C=32):
    """des1 as the pipeline hands it over (a band of a permuted view) and
    des2 gathered by the matches."""
    equi = F.normalize(torch.randn(K, C, E + 2, A, generator=g),
                       dim=1).permute(0, 2, 3, 1)
    tgt = torch.randint(0, K, (K,), generator=g)
    return equi[:, 1:E + 1], equi[:, 1:E + 1][tgt]


@pytest.mark.parametrize("n,per,parts", [
    (3000, 64 * 9 * 22, 1), (43000, 128 * 9 * 22, 2), (0, 100, 0),
    (5, 0, 0), (7, 2 ** 29, 7)])
def test_launch_parts_cover_the_batch(n, per, parts):
    """The wrappers' split of a batch: consecutive parts covering it, each
    below ``LAUNCH_ELEMENTS`` elements, one at the main path's sizes, none
    for an empty map."""
    got = cyl_cuda._parts("test", n, per)
    assert len(got) == parts
    assert [i for p in got for i in range(p.start, p.stop)] == (
        list(range(n)) if per else [])
    assert all((p.stop - p.start) * per < cyl_cuda.LAUNCH_ELEMENTS
               for p in got)


def test_launch_parts_refuse_an_item_past_a_launch():
    with pytest.raises(ValueError):
        cyl_cuda._parts("test", 2, cyl_cuda.LAUNCH_ELEMENTS)


# ---------------------------------------------------------------------------
# the kernels' index arithmetic, in PyTorch
# ---------------------------------------------------------------------------


def _cyl_pad_model(x: torch.Tensor):
    """csrc/cyl.cu cyl_pad_kernel: every output element in memory order
    (channels last), its coordinates from its index, its source element
    from x's strides."""
    xs = x if x.dim() == 5 else x.unsqueeze(2)
    N0, C, N2, H, W = xs.shape
    s0, s1, s2, sh, sw = xs.stride()
    Hp, Wp = H + 2, W + 2
    r = torch.arange(N0 * C * N2 * Hp * Wp)
    c = r % C
    r = r // C
    j = r % Wp
    r = r // Wp
    i = r % Hp
    r = r // Hp
    n2 = r % N2
    r = r // N2
    col = torch.where(j == 0, W - 1, torch.where(j == W + 1, 0, j - 1))
    inside = (i >= 1) & (i <= H)
    off = torch.where(inside, r * s0 + c * s1 + n2 * s2 + (i - 1) * sh
                      + col * sw, 0)
    flat = torch.as_strided(xs, (int(off.max()) + 1,), (1,),
                            xs.storage_offset())
    return torch.where(inside, flat[off], torch.zeros(()))


def _div(n: torch.Tensor, d: int) -> torch.Tensor:
    """csrc/cyl.cu Div: n // d as (umulhi(n, m) + n) >> s in 32-bit
    unsigned arithmetic, m and s made from d as the launcher makes them."""
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    assert 0 < m < 1 << 32
    return (((n * m) >> 32) + n) >> s


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 9, 20, 22, 32, 64, 128, 198,
                               4480, 2 ** 20 + 7])
def test_launch_fixed_division_is_exact(d):
    """The kernels' division by a divisor fixed for the launch equals
    integer division for every n below 2^30 (the launchers' bound): the
    ends of the range, each multiple of d and its neighbours near them,
    and random n."""
    g = _gen(10)
    top = 1 << 30
    n = torch.cat([torch.arange(0, 4096), torch.arange(top - 4096, top),
                   torch.randint(0, top, (200000,), generator=g)])
    k = torch.randint(0, top // d, (20000,), generator=g) * d
    n = torch.cat([n, k, k + 1, (k - 1).clamp(min=0), k + d - 1])
    n = n[n < top].to(torch.int64)
    assert torch.equal(_div(n, d), n // d)


def _cost_volume_model(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """csrc/cyl.cu cost_volume_kernel: des1[m] and des2[m] staged as
    [E][A][C], then each output float4 from its index, the shifted column
    (a - s) mod A; the volume in memory order."""
    M, E, A, C = d1.shape
    n, C4 = E * A * C, C // 4
    t = torch.arange(n)
    c, a, e = t % C, (t // C) % A, t // (C * A)
    s1 = d1[:, e, a, c].reshape(M, n // 4, 4)
    s2 = d2[:, e, a, c].reshape(M, n // 4, 4)
    u = torch.arange(A * E * A * C4)
    c4, r = u % C4, u // C4
    a, r = r % A, r // A
    e, s = r % E, r // E
    ar = torch.where(a >= s, a - s, a - s + A)
    return (s1[:, (e * A + ar) * C4 + c4]
            - s2[:, (e * A + a) * C4 + c4]).reshape(-1)


@pytest.mark.parametrize("case", [("cyl_pad", layout) for layout in LAYOUTS]
                         + [("cost_volume", (5, 20, 32)),
                            ("cost_volume", (3, 7, 8))])
def test_kernel_index_models_match_plain(case):
    """The kernels' index arithmetic, transcribed: ``cyl_pad_kernel``'s
    decomposition of an output index and its source offset give
    ``pad_cyl_2d(x, 3)`` in channels-last memory order;
    ``cost_volume_kernel``'s staged
    float4s give ``heads.cost_volume`` in its memory order."""
    kind, arg = case
    if kind == "cost_volume":
        E, A, C = arg
        d1, d2 = _descriptors(_gen(6), E=E, A=A, C=C)
        assert torch.equal(_cost_volume_model(d1, d2),
                           _memory(heads.cost_volume(d1, d2)))
        return
    x = _map(arg, _gen(5))
    want = conv_cuda.channels_last(pad_cyl_2d(x, 3))
    assert torch.equal(_cyl_pad_model(x), want.reshape(-1))


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


def _with_stats(module: nn.Module, g) -> nn.Module:
    for b in module.modules():
        if isinstance(b, nn.modules.batchnorm._BatchNorm):
            b.running_mean.copy_(torch.randn(b.num_features, generator=g) * 0.1)
            b.running_var.copy_(torch.rand(b.num_features, generator=g) + 0.5)
    return module.eval()


def _layers(net, x):
    for i in range(len(net.layers)):
        x = net.layer(i, x)
    return x


SITES = ((cylindrical, "cyl_pad_cuda"), (cylindrical, "conv_pad_cuda"),
         (cylindrical, "conv_bn_relu_cuda"), (cylindrical, "conv_bias_cuda"),
         (heads, "cost_volume_cuda"))


def _counted(monkeypatch):
    """Counts the calls at the call sites of the fused passes."""
    calls = {name: 0 for _, name in SITES}
    for mod, name in SITES:
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("layout", ["spt 5-D", "sampled 5-D"])
def test_inference_forwards_match_layers(monkeypatch, layout):
    """Eval mode without autograd: ``CylindricalNet`` (conv 0's padded
    input, 7 padded convolutions and the last) and ``CostVolume`` (the
    one-pass volume, CostNet's 9 convolutions with their epilogues and the
    last) return what their layer by layer paths return, bit for bit: on
    the CPU the call sites take the modules."""
    g = _gen(7)
    cyl = _with_stats(CylindricalNet(), g)
    cv = _with_stats(CostVolume(20), g)
    x = _map(layout, g)
    d1, d2 = _descriptors(g)
    with torch.no_grad():
        want_cyl = _layers(cyl, x)
        want_cv = _layers(cv.conv, cv.cost(d1, d2))
        calls = _counted(monkeypatch)
        got_cyl = cyl(x)
        got_cv = cv.conv(cyl_cuda.cost_volume_cuda(d1, d2))
        got = cv(d1, d2)
    assert _same(got_cyl, want_cyl)
    assert torch.equal(got_cv, want_cv.reshape(-1, 20))
    prob = torch.softmax(want_cv.reshape(-1, 20), dim=-1)
    assert torch.equal(got, torch.sum(prob * torch.arange(20.0), dim=-1))
    assert calls == {"cyl_pad_cuda": 1, "conv_pad_cuda": 7,
                     "conv_bn_relu_cuda": 18, "conv_bias_cuda": 3,
                     "cost_volume_cuda": 1}


@pytest.mark.parametrize("mode", ["train", "eval with autograd"])
def test_training_forwards_keep_the_layers(monkeypatch, mode):
    """Train mode (batch statistics) and any forward under autograd run
    the layers as before and none of the fused passes."""
    g = _gen(8)
    cyl, cv = CylindricalNet(), CostVolume(20)
    if mode == "train":
        cyl.train()
        cv.train()
    else:
        _with_stats(cyl, g)
        _with_stats(cv, g)
    x = _map("spt 5-D", g)
    d1, d2 = _descriptors(g)
    calls = _counted(monkeypatch)
    got = (cyl(x), cv(d1, d2))
    assert set(calls.values()) == {0}
    assert got[0].requires_grad and got[1].requires_grad
    got[1].sum().backward()


def test_cyl_sites_switch_to_plain_versions():
    """The five call sites are kernel sites: ``plain_versions()`` puts the
    plain versions there and restores the wrappers; on the CPU the
    wrappers launch nothing."""
    plain = {"cyl_pad_cuda": cyl_cuda.cyl_pad_plain,
             "conv_pad_cuda": conv_cuda.conv_pad_plain,
             "conv_bn_relu_cuda": conv_cuda.conv_bn_relu_plain,
             "conv_bias_cuda": conv_cuda.conv_bias_plain,
             "cost_volume_cuda": heads.cost_volume}
    wrapper = {name: getattr(conv_cuda if name.startswith("conv_") else
                             cyl_cuda, name) for _, name in SITES}
    for mod, name in SITES:
        assert (mod, name, plain[name]) in sites.call_sites()
        assert getattr(mod, name) is wrapper[name]
    with sites.plain_versions():
        for mod, name in SITES:
            assert getattr(mod, name) is plain[name]
        assert sites.plain_active()
    for mod, name in SITES:
        assert getattr(mod, name) is wrapper[name]
    cuda.reset_launches()
    g = _gen(9)
    conv, bn = _layer(nn.Conv2d(8, 12, 3), g)
    x = torch.randn(2, 8, 9, 22, generator=g)
    with torch.no_grad():
        cyl_cuda.cyl_pad_cuda(x)
        conv_cuda.conv_pad_cuda(conv, bn, x)
        conv_cuda.conv_bn_relu_cuda(conv, bn, x)
        conv_cuda.conv_bias_cuda(conv, x)
    cyl_cuda.cost_volume_cuda(*_descriptors(g))
    counts = cuda.launch_counts()
    assert {"cyl_pad", "conv", "cost_volume"} <= set(counts)
    assert set(counts.values()) == {0}


@pytest.mark.parametrize("case", [
    "pad float64", "pad 3-D", "conv_pad 3-D", "conv_pad channels",
    "conv_pad affine batch norm", "conv_pad train-mode batch norm",
    "conv_pad batch norm width", "conv_pad circular padding",
    "conv_bn_relu channels", "volume float64", "volume shapes",
    "volume 3-D"])
def test_cyl_wrappers_raise_on_bad_inputs(case):
    """The wrappers check dtypes, shapes and the layers they are given
    before choosing the plain version or the kernel, so a CPU tensor or a
    layer the kernel would not take raises too."""
    g = _gen(11)
    x = torch.randn(2, 8, 9, 22, generator=g)
    conv, bn = _layer(nn.Conv2d(8, 12, 3), g)
    d = torch.randn(3, 5, 20, 32, generator=g)
    affine = nn.BatchNorm2d(12).eval()
    circular = nn.Conv2d(8, 12, 3, padding=1, padding_mode="circular")
    call = {
        "pad float64": lambda: cyl_cuda.cyl_pad_cuda(x.double()),
        "pad 3-D": lambda: cyl_cuda.cyl_pad_cuda(x[0]),
        "conv_pad 3-D": lambda: conv_cuda.conv_pad_cuda(conv, bn, x[0]),
        "conv_pad channels": lambda: conv_cuda.conv_pad_cuda(conv, bn, x[:, :4]),
        "conv_pad affine batch norm": lambda: conv_cuda.conv_pad_cuda(
            conv, affine, x),
        "conv_pad train-mode batch norm": lambda: conv_cuda.conv_pad_cuda(
            conv, nn.BatchNorm2d(12, affine=False), x),
        "conv_pad batch norm width": lambda: conv_cuda.conv_pad_cuda(
            conv, nn.BatchNorm2d(8, affine=False).eval(), x),
        "conv_pad circular padding": lambda: conv_cuda.conv_pad_cuda(
            circular, bn, x),
        "conv_bn_relu channels": lambda: conv_cuda.conv_bn_relu_cuda(
            conv, bn, x[:, :4]),
        "volume float64": lambda: cyl_cuda.cost_volume_cuda(d.double(),
                                                            d.double()),
        "volume shapes": lambda: cyl_cuda.cost_volume_cuda(d, d[:2]),
        "volume 3-D": lambda: cyl_cuda.cost_volume_cuda(d[0], d[0]),
    }[case]
    with pytest.raises(ValueError):
        call()
