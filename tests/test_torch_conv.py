"""The convolution kernel of the descriptor and cost-volume nets in
inference (``kernels/conv_cuda.py``, ``csrc/conv.cu``) on the CPU.

A CUDA kernel has no CPU mode, so here: a PyTorch model of the kernel's
tile walk (its thread grid, the rows and weights each thread copies, the
shared-memory words a warp reads, the gather offsets from launch-fixed
divisions, the depth in the kernel's order, the tile edges and the three
stores, padded wrap columns and zero rows included) against ``F.conv3d``
in float64 for every tap shape and for ragged rows and channels; the
launcher's plans; the wrappers, which take the modules on the CPU and
raise on what the kernel does not take and on autograd; the call sites.
The kernel itself is held to a float64 convolution on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import itertools

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from buffer_tpu_torch.kernels import conv_cuda, cuda, sites
from buffer_tpu_torch.kernels.conv_cuda import BIAS, DENSE, PAD, THREADS
from buffer_tpu_torch.nn import cylindrical
from buffer_tpu_torch.nn.cylindrical import CostNet, CylindricalNet, pad_cyl_2d

torch.set_num_threads(1)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# csrc/conv.cu's tile walk, in PyTorch
# ---------------------------------------------------------------------------


def _grid(BN: int) -> tuple:
    """(NCG, NRG, BM, CW, RW): a block's channel and row groups, its rows,
    a warp's channel and row groups."""
    NCG = BN // 8
    NRG = THREADS // NCG
    CW = min(NCG, 8)
    return NCG, NRG, NRG * 8, CW, 32 // CW


def _thread(tid: int, BN: int) -> tuple:
    """(rg, cg) of thread ``tid``."""
    NCG, _, _, CW, RW = _grid(BN)
    warp, lane = divmod(tid, 32)
    return ((warp // (NCG // CW)) * RW + lane // CW,
            (warp % (NCG // CW)) * CW + lane % CW)


def _owned(tid: int, BN: int) -> list:
    """The (row, channel) pairs of thread ``tid``'s 8 x 8 tile: rows
    4 rg + i and BM / 2 + 4 rg + i, channels 4 cg + j and BN / 2 + 4 cg + j
    (i, j < 4)."""
    _, _, BM, _, _ = _grid(BN)
    rg, cg = _thread(tid, BN)
    rows = [4 * rg + i + h * BM // 2 for h in range(2) for i in range(4)]
    cols = [4 * cg + j + h * BN // 2 for h in range(2) for j in range(4)]
    return [(r, c) for r in rows for c in cols]


def _copies(BN: int, TG: int):
    """One chunk's 4-byte copies, thread by thread, as (depth 4 t + c, row
    or channel, shared-memory word): inputs (channel tid % 4 of rows
    tid / 4 + 64 i, every tap), weights ((channel, input channel) pairs
    q = tid, tid + 256, ..., every tap), into depth-major tiles whose rows
    hold BM + 8 and BN + 8 floats."""
    _, _, BM, _, _ = _grid(BN)
    SA, SB = BM + 8, BN + 8
    a, b = [], []
    for tid in range(THREADS):
        c, r = tid % 4, tid // 4
        a.append([(4 * t + c, r + 64 * i, (4 * t + c) * SA + r + 64 * i)
                  for t in range(TG) for i in range(BM // 64)])
        b.append([(4 * t + q % 4, q // 4, (4 * t + q % 4) * SB + q // 4)
                  for t in range(TG) for q in range(tid, 4 * BN, THREADS)])
    return a, b


@pytest.mark.parametrize("BN,TG", [(32, 3), (64, 9), (128, 9), (32, 4)])
def test_tile_walk_covers_each_tile_once(BN, TG):
    """A block's threads own every (row, channel) of its BM x BN tile once;
    one chunk's copies fill its input tile (4 TG deep x BM rows) and weight
    tile (4 TG deep x BN channels) once each."""
    _, _, BM, _, _ = _grid(BN)
    owned = [rc for t in range(THREADS) for rc in _owned(t, BN)]
    assert sorted(owned) == list(itertools.product(range(BM), range(BN)))
    a, b = _copies(BN, TG)
    assert sorted(x[:2] for t in a for x in t) == list(itertools.product(
        range(4 * TG), range(BM)))
    assert sorted(x[:2] for t in b for x in t) == list(itertools.product(
        range(4 * TG), range(BN)))


@pytest.mark.parametrize("BN,TG", [(32, 3), (64, 9), (128, 9), (32, 4)])
def test_shared_memory_accesses_are_free_of_bank_conflicts(BN, TG):
    """A warp's float4 reads of a depth step touch at most 8 distinct
    16-byte words (its row or channel groups), consecutive, so in distinct
    bank groups; each warp-wide 4-byte copy writes 32 distinct banks (rows
    of 8 mod 32 floats put a copy's 4 depths 8 banks apart)."""
    NCG, NRG, BM, CW, RW = _grid(BN)
    SA, SB = BM + 8, BN + 8
    for warp in range(THREADS // 32):
        tids = range(32 * warp, 32 * warp + 32)
        rgs = {_thread(t, BN)[0] for t in tids}
        cgs = {_thread(t, BN)[1] for t in tids}
        assert (len(rgs), len(cgs)) == (RW, CW)
        for k, h in itertools.product(range(4 * TG), range(2)):
            a = {(k * SA + h * BM // 2) // 4 + rg for rg in rgs}
            b = {(k * SB + h * BN // 2) // 4 + cg for cg in cgs}
            for words in (a, b):
                assert len(words) <= 8
                assert len({w % 8 for w in words}) == len(words)
    for copies in _copies(BN, TG):
        for warp in range(THREADS // 32):
            lanes = range(32 * warp, 32 * warp + 32)
            for s in range(max(len(copies[t]) for t in lanes)):
                words = [copies[t][s][2] for t in lanes if len(copies[t]) > s]
                assert len({w % 32 for w in words}) == len(words)


def _div(n: torch.Tensor, d: int) -> torch.Tensor:
    """csrc/conv.cu Div: n // d by multiply-high, add and shift."""
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    return (((n * m) >> 32) + n) >> s


def _kernel_model(x, w, b, mean, var, eps, store):
    """The kernel over x [B, Cin, D, H, W] and w [Cout, Cin, KD, KH, KW]
    in float64: rows' gather offsets from the launch-fixed divisions, the
    depth in chunk (tap group, channel block), tap, channel order, a block
    at a time with its loads clamped to the last row and channel and its
    stores masked, then the store: the output buffer in memory order (NaN
    where nothing was written)."""
    B, Cin, D, H, W = x.shape
    Cout, _, KD, KH, KW = w.shape
    T = KD * KH * KW
    BN, TG = conv_cuda.plan(T, Cout, store)
    BM = _grid(BN)[2]
    assert T % TG == 0
    Do, Ho, Wo = D - KD + 1, H - KH + 1, W - KW + 1
    P = Do * Ho * Wo
    M = B * P
    flat = x.permute(0, 2, 3, 4, 1).reshape(-1)
    r = torch.arange(M)
    n = _div(r, P)
    p = r - n * P
    od = _div(p, Ho * Wo)
    q = p - od * Ho * Wo
    oh = _div(q, Wo)
    ow = q - oh * Wo
    off = n * D * H * W * Cin + ((od * H + oh) * W + ow) * Cin
    tap = torch.tensor([((kd * H + kh) * W + kw) * Cin for kd in range(KD)
                        for kh in range(KH) for kw in range(KW)])
    order = [(g * TG + t, 4 * cb + c) for g in range(T // TG)
             for cb in range(Cin // 4) for t in range(TG) for c in range(4)]
    taps = torch.tensor([t for t, _ in order])
    chans = torch.tensor([c for _, c in order])
    A = flat[off[:, None] + tap[taps][None] + chans[None]]       # [M, K]
    Bw = w.reshape(Cout, Cin, T)[:, chans, taps]                  # [Cout, K]
    acc = torch.full((M, Cout), float("nan"), dtype=torch.float64)
    for m0, n0 in itertools.product(range(0, M, BM), range(0, Cout, BN)):
        rows = (m0 + torch.arange(BM)).clamp(max=M - 1)
        cols = (n0 + torch.arange(BN)).clamp(max=Cout - 1)
        tile = A[rows] @ Bw[cols].T
        keep_r = m0 + torch.arange(BM) < M
        keep_c = n0 + torch.arange(BN) < Cout
        acc[(m0 + torch.arange(BM))[keep_r][:, None],
            (n0 + torch.arange(BN))[keep_c][None]] = tile[keep_r][:, keep_c]
    v = acc + b
    if store != BIAS:
        v = torch.relu((v - mean) * torch.rsqrt(var + eps))
    co = torch.arange(Cout)
    if store == BIAS:
        out = torch.full((B * Cout * P,), float("nan"), dtype=torch.float64)
        idx = (n[:, None] * Cout + co) * P + p[:, None]
        out[idx.reshape(-1)] = v.reshape(-1)
        return out
    if store == DENSE:
        return v.reshape(-1)
    Wp = Wo + 2
    out = torch.full((B * (Ho + 2) * Wp * Cout,), float("nan"),
                     dtype=torch.float64)

    def put(row, col, val, where):
        idx = ((n * (Ho + 2) + row) * Wp + col)[:, None] * Cout + co
        out[idx[where].reshape(-1)] = val[where].reshape(-1)
    zero = torch.zeros_like(v)
    every = torch.ones(M, dtype=torch.bool)
    put(oh + 1, ow + 1, v, every)
    put(oh + 1, torch.zeros_like(ow), v, ow == Wo - 1)
    put(oh + 1, torch.full_like(ow, Wo + 1), v, ow == 0)
    for side, z in ((oh == 0, 0), (oh == Ho - 1, Ho + 1)):
        zr = torch.full_like(oh, z)
        put(zr, ow + 1, zero, side)
        put(zr, torch.zeros_like(ow), zero, side & (ow == Wo - 1))
        put(zr, torch.full_like(ow, Wo + 1), zero, side & (ow == 0))
    return out


def _memory(t: torch.Tensor) -> torch.Tensor:
    """A dense tensor's elements in memory order."""
    return torch.as_strided(t, (t.numel(),), (1,), t.storage_offset())


MODEL_CASES = {
    # name: (x shape, Cout, kernel, store)
    "cyl conv 0 (3, 3, 3) padded": ((3, 16, 3, 9, 22), 64, (3, 3, 3), PAD),
    "cyl 3 x 3 padded, 20 channels": ((4, 8, 1, 9, 22), 20, (1, 3, 3), PAD),
    "cyl 3 x 3 padded, 100 channels": ((2, 16, 1, 9, 22), 100, (1, 3, 3), PAD),
    "cyl 3 x 3 padded, 136 channels": ((2, 8, 1, 9, 22), 136, (1, 3, 3), PAD),
    "cyl 3 x 3 padded, one output row": ((3, 8, 1, 3, 5), 24, (1, 3, 3), PAD),
    "cyl 3 x 3 padded, one output pixel": ((3, 8, 1, 3, 3), 8, (1, 3, 3), PAD),
    "cyl last 3 x 3 bias": ((3, 8, 1, 9, 22), 32, (1, 3, 3), BIAS),
    "costnet (3, 3, 3) dense": ((2, 8, 6, 5, 7), 40, (3, 3, 3), DENSE),
    "costnet (3, 1, 3) dense": ((3, 8, 6, 1, 6), 32, (3, 1, 3), DENSE),
    "costnet (3, 1, 3) dense, 128 channels": ((2, 8, 5, 1, 5), 128, (3, 1, 3),
                                              DENSE),
    "costnet last (2, 1, 2) bias": ((5, 8, 2, 1, 2), 20, (2, 1, 2), BIAS),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_model_matches_float64_convolution(case):
    """The model of the kernel's tile walk writes every element of its
    output once and gives ``F.conv3d`` in float64 with the epilogue: the
    bias; the batch norm and ReLU; ``pad_cyl_2d``'s wrap columns and zero
    rows for the padded store, stored channels last (channels first for
    the bias store)."""
    shape, Cout, k, store = MODEL_CASES[case]
    g = _gen(len(case))
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    w = torch.randn((Cout, shape[1], *k), generator=g, dtype=torch.float64)
    b = torch.randn(Cout, generator=g, dtype=torch.float64)
    mean = torch.randn(Cout, generator=g, dtype=torch.float64)
    var = torch.rand(Cout, generator=g, dtype=torch.float64) + 0.1
    got = _kernel_model(x, w, b, mean, var, 1e-5, store)
    want = F.conv3d(x, w, b)
    if store != BIAS:
        want = torch.relu((want - mean.view(-1, 1, 1, 1))
                          * torch.rsqrt(var.view(-1, 1, 1, 1) + 1e-5))
    if store == PAD:
        want = pad_cyl_2d(want[:, :, 0], 3).permute(0, 2, 3, 1)
    elif store == DENSE:
        want = want.permute(0, 2, 3, 4, 1)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want.contiguous().reshape(-1), rtol=1e-12,
                               atol=1e-12)


def test_plans_of_the_nets():
    """The launcher's plan of each of the 18 convolutions: the block's
    channels follow Cout, a chunk takes 9 taps (3 where a block holds 32
    channels, 4 for CostNet's last 2 x 2); every layer has one."""
    cyl, cost = CylindricalNet(), CostNet(20)
    got = []
    for net in (cyl, cost):
        for i, grp in enumerate(net.layers):
            conv = grp[0]
            store = BIAS if len(grp) == 1 else (PAD if net is cyl else DENSE)
            got.append(conv_cuda.plan(conv.weight[0, 0].numel(),
                                      conv.out_channels, store))
    assert got == [(64, 9), (64, 9), (128, 9), (128, 9), (64, 9), (64, 9),
                   (32, 3), (32, 3),
                   (32, 3), (64, 9), (64, 9), (128, 9), (128, 9), (64, 9),
                   (64, 9), (32, 3), (32, 3), (32, 4)]
    assert conv_cuda.plan(1, 32, DENSE) is None
    assert conv_cuda.plan(9, 64, BIAS) is None
    assert conv_cuda.plan(30, 32, DENSE) is None
    assert conv_cuda.plan(9, 30, DENSE) is None


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _layer(conv: nn.Module, g) -> tuple:
    """``conv`` with drawn weights and bias, and an eval-mode affine-free
    batch norm with drawn running statistics after it."""
    C = conv.out_channels
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.1)
        conv.bias.copy_(torch.randn(C, generator=g))
    bn = (nn.BatchNorm2d if isinstance(conv, nn.Conv2d) else nn.BatchNorm3d)(
        C, affine=False)
    bn.running_mean.copy_(torch.randn(C, generator=g))
    bn.running_var.copy_(torch.rand(C, generator=g) * 3 + 0.05)
    return conv, bn.eval()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a, b) and a.stride() == b.stride()


@pytest.mark.parametrize("wrapper", ["conv_pad", "conv_bn_relu", "conv_bias"])
def test_wrappers_take_the_modules_on_the_cpu(wrapper):
    """On the CPU each wrapper is its plain version, the modules as train
    mode runs them, bit for bit and stride for stride, and launches
    nothing."""
    g = _gen(2)
    if wrapper == "conv_pad":
        conv, bn = _layer(nn.Conv2d(8, 12, 3), g)
        x = torch.randn(3, 8, 9, 22, generator=g).contiguous(
            memory_format=torch.channels_last)
        want = lambda: pad_cyl_2d(torch.relu(bn(conv(x))), 3)
        got = lambda: conv_cuda.conv_pad_cuda(conv, bn, x)
    elif wrapper == "conv_bn_relu":
        conv, bn = _layer(nn.Conv3d(8, 16, (3, 1, 3)), g)
        x = torch.randn(3, 8, 6, 1, 6, generator=g).contiguous(
            memory_format=torch.channels_last_3d)
        want = lambda: torch.relu(bn(conv(x)))
        got = lambda: conv_cuda.conv_bn_relu_cuda(conv, bn, x)
    else:
        conv, _ = _layer(nn.Conv3d(8, 20, (2, 1, 2)), g)
        x = torch.randn(3, 8, 2, 1, 2, generator=g)
        want = lambda: conv(x)
        got = lambda: conv_cuda.conv_bias_cuda(conv, x)
    cuda.reset_launches()
    with torch.no_grad():
        assert _same(got(), want())
    assert cuda.launch_counts()["conv"] == 0


def test_channels_last_is_a_view_of_the_kernels_own_maps():
    """The kernel reads [B, (D,) H, W, C] dense: the padded maps and
    volumes the inference path hands it are that layout already (a view,
    no copy); a channels-first map is copied into it."""
    padded = torch.empty(4, 1, 9, 22, 64).permute(0, 4, 1, 2, 3)[:, :, 0]
    vol = torch.empty(4, 20, 5, 20, 32).permute(0, 4, 1, 2, 3)
    for x in (padded, vol, torch.empty(4, 3, 9, 22, 16).permute(0, 4, 1, 2, 3)):
        xl = conv_cuda.channels_last(x)
        assert xl.data_ptr() == x.data_ptr() and xl.is_contiguous()
    x = torch.randn(2, 8, 9, 22)
    xl = conv_cuda.channels_last(x)
    assert xl.is_contiguous() and torch.equal(xl, x.permute(0, 2, 3, 1))


@pytest.mark.parametrize("case", [
    "float64", "3-D", "channels", "channels not a multiple of 4", "padding",
    "stride", "dilation", "groups", "no bias", "no plan", "affine batch norm",
    "train-mode batch norm", "batch norm width", "autograd"])
def test_conv_wrappers_raise_on_bad_inputs(case):
    """The wrappers check the input and the layers before choosing the
    modules or the kernel, so what the kernel would not take raises on the
    CPU too, as does a call under autograd (the kernel has no backward)."""
    g = _gen(11)
    x = torch.randn(2, 8, 9, 22, generator=g)
    conv, bn = _layer(nn.Conv2d(8, 12, 3), g)
    bad_conv = {
        "channels not a multiple of 4": (nn.Conv2d(6, 12, 3), x[:, :6]),
        "padding": (nn.Conv2d(8, 12, 3, padding=1), x),
        "stride": (nn.Conv2d(8, 12, 3, stride=2), x),
        "dilation": (nn.Conv2d(8, 12, 3, dilation=2), x),
        "groups": (nn.Conv2d(8, 12, 3, groups=2), x),
        "no bias": (nn.Conv2d(8, 12, 3, bias=False), x),
        "no plan": (nn.Conv2d(8, 12, 1), x),
    }
    bad_bn = {
        "affine batch norm": nn.BatchNorm2d(12).eval(),
        "train-mode batch norm": nn.BatchNorm2d(12, affine=False),
        "batch norm width": nn.BatchNorm2d(8, affine=False).eval(),
    }
    if case in bad_conv:
        c, xc = bad_conv[case]
        calls = [lambda: conv_cuda.conv_pad_cuda(c, bn, xc),
                 lambda: conv_cuda.conv_bn_relu_cuda(c, bn, xc),
                 lambda: conv_cuda.conv_bias_cuda(c, xc)]
    elif case in bad_bn:
        calls = [lambda: conv_cuda.conv_pad_cuda(conv, bad_bn[case], x),
                 lambda: conv_cuda.conv_bn_relu_cuda(conv, bad_bn[case], x)]
    else:
        xb = {"float64": x.double(), "3-D": x[0], "channels": x[:, :4],
              "autograd": x}[case]
        calls = [lambda: conv_cuda.conv_pad_cuda(conv, bn, xb),
                 lambda: conv_cuda.conv_bn_relu_cuda(conv, bn, xb),
                 lambda: conv_cuda.conv_bias_cuda(conv, xb)]
    error = RuntimeError if case == "autograd" else ValueError
    with torch.set_grad_enabled(case == "autograd"):
        for call in calls:
            with pytest.raises(error):
                call()


def test_conv_sites_switch_to_plain_versions():
    """The three convolution call sites are kernel sites:
    ``plain_versions()`` puts the modules there and restores the wrappers;
    ``plain_versions(keep=sites.CONVOLUTIONS)`` leaves them on the kernel
    and switches every other site."""
    plain = {"conv_pad_cuda": conv_cuda.conv_pad_plain,
             "conv_bn_relu_cuda": conv_cuda.conv_bn_relu_plain,
             "conv_bias_cuda": conv_cuda.conv_bias_plain}
    assert set(sites.CONVOLUTIONS) == set(plain)
    for name, fn in plain.items():
        assert (cylindrical, name, fn) in sites.call_sites()
        assert getattr(cylindrical, name) is getattr(conv_cuda, name)
    with sites.plain_versions():
        for name, fn in plain.items():
            assert getattr(cylindrical, name) is fn
    with sites.plain_versions(keep=sites.CONVOLUTIONS):
        for mod, name, fn in sites.call_sites():
            assert getattr(mod, name) is (getattr(conv_cuda, name)
                                          if name in plain else fn)
        assert sites.plain_active()
    for name in plain:
        assert getattr(cylindrical, name) is getattr(conv_cuda, name)
