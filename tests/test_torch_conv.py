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
import math

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


def _owned(tid: int, BN: int, path: str = "halo") -> list:
    """The (row, channel) pairs of thread ``tid``'s 8 x 8 tile: rows
    rg + NRG i (i < 8) on the halo path, 4 rg + i and BM / 2 + 4 rg + i
    (i < 4) on the per-tap path; channels 4 cg + j and BN / 2 + 4 cg + j
    (j < 4)."""
    _, NRG, BM, _, _ = _grid(BN)
    rg, cg = _thread(tid, BN)
    rows = ([rg + NRG * i for i in range(8)] if path == "halo" else
            [4 * rg + i + h * BM // 2 for h in range(2) for i in range(4)])
    cols = [4 * cg + j + h * BN // 2 for h in range(2) for j in range(4)]
    return [(r, c) for r in rows for c in cols]


def _tap_copies(BN: int, TG: int):
    """The per-tap path's 4-byte copies of one chunk, thread by thread, as
    (depth 4 t + c, row or channel, shared-memory word): inputs (channel
    tid % 4 of rows tid / 4 + 64 i, every tap), weights ((channel, input
    channel) pairs q = tid, tid + 256, ..., every tap), into depth-major
    tiles whose rows hold BM + 8 and BN + 8 floats."""
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


class _Walk:
    """One launch's geometry as csrc/conv.cu walks it: the plan, the output
    rows' tile coordinates, the taps' tile offsets, each block's tile (its
    origin, span, and the pixel each tile position copies) and the
    threads' copies."""

    def __init__(self, x_shape, cout, k, store):
        B, self.cin, D, H, W = x_shape
        KD, KH, KW = k
        self.dims = (B, D, H, W)
        self.T = KD * KH * KW
        self.pl = conv_cuda.plan(B, D, H, W, self.cin, cout, KD, KH, KW,
                                 store)
        assert self.pl is not None
        pl = self.pl
        self.Do, self.Ho, self.Wo = D - KD + 1, H - KH + 1, W - KW + 1
        self.P = self.Do * self.Ho * self.Wo
        self.M = B * self.P
        self.taps = torch.tensor([kd * pl.pp + kh * pl.wp + kw
                                  for kd in range(KD) for kh in range(KH)
                                  for kw in range(KW)])
        # the input pixel each tap of a row reads, relative to the row's
        self.tap_pix = torch.tensor([(kd * H + kh) * W + kw
                                     for kd in range(KD) for kh in range(KH)
                                     for kw in range(KW)])
        self.tap_span = (KD - 1) * pl.pp + (KH - 1) * pl.wp + KW
        self.blocks = -(-self.M // pl.bm)

    def rows(self, r: torch.Tensor) -> tuple:
        """(tile coordinate, input pixel) of output rows r's base pixels,
        from launch-fixed divisions as the kernel takes them."""
        pl, Ho, Wo = self.pl, self.Ho, self.Wo
        n = _div(r, self.P)
        p = r - n * self.P
        od = _div(p, Ho * Wo)
        q = p - od * Ho * Wo
        oh = _div(q, Wo)
        ow = q - oh * Wo
        _, D, H, W = self.dims
        return (n * pl.ip + od * pl.pp + oh * pl.wp + ow,
                ((n * D + od) * H + oh) * W + ow)

    def block(self, b: int) -> dict:
        """Block b: its rows (clamped to M - 1), their tile positions, the
        span of positions it reads, and each position's input pixel (-1 for
        padding)."""
        pl = self.pl
        r = (b * pl.bm + torch.arange(pl.bm)).clamp(max=self.M - 1)
        coord, pix = self.rows(r)
        origin = coord[0]
        pos = coord - origin
        span = int(pos[-1]) + self.tap_span
        c = origin + torch.arange(span)
        _, D, H, W = self.dims
        n = _div(c, pl.ip)
        e = c - n * pl.ip
        d = _div(e, pl.pp)
        f = e - d * pl.pp
        h = _div(f, pl.wp)
        w = f - h * pl.wp
        real = (d < D) & (h < H) & (w < W)
        src = torch.where(real, ((n * D + d) * H + h) * W + w, -1)
        return {"rows": r, "pos": pos, "pix": pix, "span": span, "src": src}

    def copies(self, span: int) -> list:
        """One chunk's 16-byte tile copies, thread by thread, as (position,
        quad, shared-memory word): copy s of thread tid is j = tid + 256 s,
        position j / NQ, quad j % NQ, word quad HP + position."""
        NQ = self.pl.ch // 4
        out = []
        for tid in range(THREADS):
            js = range(tid, NQ * span, THREADS)
            out.append([(j // NQ, j % NQ, (j % NQ) * self.pl.hp + j // NQ)
                        for j in js])
        return out

    def weight_copies(self) -> list:
        """One chunk's 16-byte weight copies, thread by thread, as the
        shared-memory word each writes: copy j = tid + 256 s is row j /
        (BN / 4) of the [T CH][BN] weight tile, float4 j % (BN / 4)."""
        n = self.pl.ch * self.T * self.pl.bn // 4
        return [list(range(tid, n, THREADS)) for tid in range(THREADS)]

    def period(self) -> range:
        """Blocks that show every tile the launch's blocks hold: one period
        of block starts modulo P, and the last block."""
        return sorted({*range(min(self.blocks,
                                  self.P // math.gcd(self.pl.bm, self.P))),
                       self.blocks - 1})


def _div(n: torch.Tensor, d: int) -> torch.Tensor:
    """csrc/conv.cu Div: n // d by multiply-high, add and shift."""
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    return (((n * m) >> 32) + n) >> s


# (x shape [B, Cin, D, H, W], Cout, kernel, store) of each of the 18
# convolutions of CylindricalNet and CostNet at B patches and K matches
def _net_layers(B: int, K: int) -> list:
    cyl, cost = CylindricalNet(), CostNet(20)
    out, x = [], (B, 16, 3, 9, 22)
    for grp in cyl.layers:
        conv = grp[0]
        k = tuple(conv.kernel_size)
        out.append((x, conv.out_channels, k if len(k) == 3 else (1, *k),
                    BIAS if len(grp) == 1 else PAD))
        x = (B, conv.out_channels, 1, 9, 22)
    x = (K, 32, 20, 5, 20)
    for grp in cost.layers:
        conv = grp[0]
        k = tuple(conv.kernel_size)
        out.append((x, conv.out_channels, k, BIAS if len(grp) == 1 else DENSE))
        x = (K, conv.out_channels, *[s - q + 1 for s, q in zip(x[2:], k)])
    return out


NET_LAYERS = _net_layers(3000, 1500)


def _halo_acc(x, w, walk):
    """The halo path's sums over x [B, Cin, D, H, W] and w [Cout, Cin, KD,
    KH, KW] in float64, as its walk reads them: a block at a time, each
    chunk of CH input channels from its halo tile (positions of padding
    NaN), each (row, tap) read at the row's tile position plus the tap's
    offset, the depth in (chunk, tap, channel) order, the block's rows
    clamped to the last and its channels to the last, its stores masked:
    [M, Cout], NaN where nothing was written."""
    B, Cin, D, H, W = x.shape
    Cout = w.shape[0]
    pl, T, M = walk.pl, walk.T, walk.M
    BN, BM, CH = pl.bn, pl.bm, pl.ch
    NQ = CH // 4
    xl = x.permute(0, 2, 3, 4, 1).reshape(-1, Cin)       # pixel, channel
    wf = w.reshape(Cout, Cin, T)
    acc = torch.full((M, Cout), float("nan"), dtype=torch.float64)
    for blk_i in range(walk.blocks):
        blk = walk.block(blk_i)
        reads = blk["pos"][:, None] + walk.taps[None]    # [BM, T]
        real = blk["src"] >= 0
        r = blk_i * BM + torch.arange(BM)
        for n0 in range(0, Cout, BN):
            cols = (n0 + torch.arange(BN)).clamp(max=Cout - 1)
            tile_acc = torch.zeros(BM, BN, dtype=torch.float64)
            for cb in range(Cin // CH):
                tile = torch.full((NQ, blk["span"], 4), float("nan"),
                                  dtype=torch.float64)
                vals = xl[blk["src"][real], CH * cb:CH * cb + CH]
                tile[:, real] = vals.reshape(-1, NQ, 4).permute(1, 0, 2)
                A = tile[:, reads].permute(1, 2, 0, 3)       # [BM, T, NQ, 4]
                Bw = wf[cols, CH * cb:CH * cb + CH].reshape(
                    BN, NQ, 4, T).permute(0, 3, 1, 2)        # [BN, T, NQ, 4]
                tile_acc += A.reshape(BM, -1) @ Bw.reshape(BN, -1).T
            keep_r = r < M
            keep_c = n0 + torch.arange(BN) < Cout
            acc[r[keep_r][:, None], (n0 + torch.arange(BN))[keep_c][None]] = (
                tile_acc[keep_r][:, keep_c])
    return acc


def _tap_acc(x, w, walk):
    """The per-tap path's sums in float64: rows' gather offsets from the
    launch-fixed divisions, the depth in chunk (tap group, channel block),
    tap, channel order, a block at a time with its loads clamped to the
    last row and channel and its stores masked: [M, Cout]."""
    B, Cin, D, H, W = x.shape
    Cout, _, KD, KH, KW = w.shape
    T, M, P = walk.T, walk.M, walk.P
    BN, TG, BM = walk.pl.bn, walk.pl.tg, walk.pl.bm
    Ho, Wo = walk.Ho, walk.Wo
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
    return acc


def _kernel_model(x, w, b, mean, var, eps, store):
    """The kernel over x [B, Cin, D, H, W] and w [Cout, Cin, KD, KH, KW]
    in float64, on its plan's path (:func:`_halo_acc`, :func:`_tap_acc`),
    then the store: the output buffer in memory order (NaN where nothing
    was written)."""
    B = x.shape[0]
    Cout, _, KD, KH, KW = w.shape
    walk = _Walk(tuple(x.shape), Cout, (KD, KH, KW), store)
    M = walk.M
    acc = (_halo_acc if walk.pl.path == "halo" else _tap_acc)(x, w, walk)
    v = acc + b
    if store != BIAS:
        v = torch.relu((v - mean) * torch.rsqrt(var + eps))
    r = torch.arange(M)
    n = _div(r, walk.P)
    p = r - n * walk.P
    Ho, Wo = walk.Ho, walk.Wo
    q = p - _div(p, Ho * Wo) * Ho * Wo
    oh = _div(q, Wo)
    ow = q - oh * Wo
    co = torch.arange(Cout)
    if store == BIAS:
        out = torch.full((B * Cout * walk.P,), float("nan"),
                         dtype=torch.float64)
        idx = (n[:, None] * Cout + co) * walk.P + p[:, None]
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
    "cyl 3 x 3 padded, blocks over two patches": ((5, 8, 1, 9, 22), 64,
                                                  (1, 3, 3), PAD),
    "costnet (3, 3, 3) dense, a block over two matches": (
        (2, 8, 20, 5, 20), 32, (3, 3, 3), DENSE),
    "costnet (3, 1, 3) dense, B = 1": ((1, 8, 6, 1, 6), 32, (3, 1, 3), DENSE),
    "costnet (3, 1, 3) dense, 64-channel blocks": ((300, 8, 4, 1, 4), 32,
                                                   (3, 1, 3), DENSE),
    "costnet last (2, 1, 2) bias, 64-channel blocks": ((600, 8, 2, 1, 2), 20,
                                                       (2, 1, 2), BIAS),
}
# the walk's cases: the model's, and each of the 18 layers at 3000 patches
# and 1500 matches
WALK_CASES = {**MODEL_CASES, **{f"net layer {i}": c
                                for i, c in enumerate(NET_LAYERS)}}


def _walk(case: str) -> _Walk:
    shape, cout, k, store = WALK_CASES[case]
    return _Walk(shape, cout, k, store)


HALO_CASES = [c for c in WALK_CASES if _walk(c).pl.path == "halo"]


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_tile_walk_covers_each_tile_once(case):
    """A block's threads own every (row, channel) of its BM x BN tile once;
    on the halo path one chunk's copies fill its halo tile (NQ quads x the
    span of positions a block reads, within the tile's plane HP) and its
    [T CH][BN] weight tile once each; on the per-tap path its input tile
    (4 TG deep x BM rows) and weight tile (4 TG deep x BN channels)."""
    walk = _walk(case)
    pl = walk.pl
    owned = [rc for t in range(THREADS) for rc in _owned(t, pl.bn, pl.path)]
    assert sorted(owned) == list(itertools.product(range(pl.bm),
                                                   range(pl.bn)))
    if pl.path == "tap":
        a, b = _tap_copies(pl.bn, pl.tg)
        assert sorted(x[:2] for t in a for x in t) == list(
            itertools.product(range(4 * pl.tg), range(pl.bm)))
        assert sorted(x[:2] for t in b for x in t) == list(
            itertools.product(range(4 * pl.tg), range(pl.bn)))
        return
    NQ = pl.ch // 4
    for span in sorted({walk.block(b)["span"] for b in walk.period()}):
        assert span <= pl.hp
        got = sorted(c[:2] for t in walk.copies(span) for c in t)
        assert got == sorted(itertools.product(range(span), range(NQ)))
    words = sorted(w for t in walk.weight_copies() for w in t)
    assert words == list(range(pl.ch * walk.T * pl.bn // 4))


@pytest.mark.parametrize("case", sorted(HALO_CASES))
def test_halo_tile_holds_every_read(case):
    """Every block's tile (one period of block starts and the ragged last
    block, blocks over two patches or matches among them) holds each
    pixel it reads: the position of a row plus a tap's offset lies within
    the span and copies the pixel that row and tap read; the tile copies
    each input pixel at most once (the footprint once a chunk), and its
    padding is never read."""
    walk = _walk(case)
    straddles = 0
    for b in walk.period():
        blk = walk.block(b)
        reads = blk["pos"][:, None] + walk.taps[None]
        assert int(reads.min()) >= 0 and int(reads.max()) < blk["span"]
        want = blk["pix"][:, None] + walk.tap_pix[None]
        assert torch.equal(blk["src"][reads], want)
        real = blk["src"][blk["src"] >= 0]
        assert real.unique().numel() == real.numel()
        n = _div(blk["rows"], walk.P)
        straddles += int(n[0] != n[-1])
    if walk.blocks > 1 and walk.P % walk.pl.bm:
        assert straddles


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_shared_memory_accesses_are_free_of_bank_conflicts(case):
    """Every shared-memory access of the walk.  Halo path, in every block
    of a period and the last: a warp's float4 reads of a depth step touch
    at most 8 distinct 16-byte words, in distinct bank groups (its row
    groups' tile positions, whatever the tap and quad; its channel groups'
    weights); each 8-lane phase of a 16-byte tile or weight copy writes 8
    distinct bank groups (HP is 4 mod 8).  Per-tap path: as
    :func:`_tap_banks`."""
    walk = _walk(case)
    pl = walk.pl
    NCG, NRG, BM, CW, RW = _grid(pl.bn)
    if pl.path == "tap":
        _tap_banks(pl.bn, pl.tg)
        return
    assert pl.hp % 8 == 4 and pl.bn % 32 == 0
    warps = [[_thread(t, pl.bn) for t in range(32 * w, 32 * w + 32)]
             for w in range(THREADS // 32)]
    for b in walk.period():
        pos = walk.block(b)["pos"]
        for lanes in warps:
            rgs = sorted({rg for rg, _ in lanes})
            assert len(rgs) == RW and rgs == list(range(rgs[0], rgs[0] + RW))
            for i in range(8):      # rows past M read the last row's word
                words = pos[[rg + NRG * i for rg in rgs]].unique()
                assert words.remainder(8).unique().numel() == words.numel()
    for lanes in warps:
        cgs = sorted({cg for _, cg in lanes})
        assert cgs == list(range(cgs[0], cgs[0] + CW)) and CW <= 8
        for h in range(2):              # a depth's two float4s of weights
            words = {h * pl.bn // 8 + cg for cg in cgs}
            assert len({w % 8 for w in words}) == len(words)
    for span in sorted({walk.block(b)["span"] for b in walk.period()}):
        copies = walk.copies(span)
        for w in range(THREADS // 32):
            for s in range(len(copies[32 * w])):
                for ph in range(4):
                    lanes = range(32 * w + 8 * ph, 32 * w + 8 * ph + 8)
                    words = [copies[t][s][2] for t in lanes
                             if len(copies[t]) > s]
                    assert len({x % 8 for x in words}) == len(words)
    loads = walk.weight_copies()
    for w in range(THREADS // 32):
        for s in range(len(loads[32 * w])):
            for ph in range(4):
                lanes = range(32 * w + 8 * ph, 32 * w + 8 * ph + 8)
                words = [loads[t][s] for t in lanes if len(loads[t]) > s]
                assert len({x % 8 for x in words}) == len(words)


def _tap_banks(BN: int, TG: int) -> None:
    """The per-tap path: a warp's float4 reads of a depth step touch at most
    8 distinct 16-byte words (its row or channel groups), consecutive, so
    in distinct bank groups; each warp-wide 4-byte copy writes 32 distinct
    banks (rows of 8 mod 32 floats put a copy's 4 depths 8 banks apart)."""
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
    for copies in _tap_copies(BN, TG):
        for warp in range(THREADS // 32):
            lanes = range(32 * warp, 32 * warp + 32)
            for s in range(max(len(copies[t]) for t in lanes)):
                words = [copies[t][s][2] for t in lanes if len(copies[t]) > s]
                assert len({w % 32 for w in words}) == len(words)


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
    """The launcher's plan of each of the 18 convolutions at 3000 patches
    and 1500 matches, by path: the per-tap staging (9 taps a chunk) for
    the 128-channel layers and CylindricalNet's conv 0 (a 3-D kernel over
    one output plane), where the halo was slower on the card; the halo
    staging for the other 13, the block's channels after Cout (64 for
    CostNet's last two, whose 32-channel tiles would not fit), 8 input
    channels a chunk (4 for CostNet 0, 1, 7 and 8, whose tiles and weights
    would not leave two blocks an SM), the tile's pitches padded where rows
    cross lines and planes.  Shapes past the kernel's reach have none."""
    assert conv_cuda.PATHS == ("halo", "tap")
    got = []
    for (B, C, D, H, W), cout, k, store in NET_LAYERS:
        pl = conv_cuda.plan(B, D, H, W, C, cout, *k, store)
        got.append((pl.path, pl.bn, pl.ch if pl.path == "halo" else pl.tg,
                    pl.wp, pl.pp, pl.ip, pl.hp))
        assert pl.smem <= conv_cuda.MAX_SMEM
    assert got == [
        ("tap", 64, 9, 0, 0, 0, 0), ("halo", 64, 8, 24, 216, 216, 460),
        ("tap", 128, 9, 0, 0, 0, 0), ("tap", 128, 9, 0, 0, 0, 0),
        ("halo", 64, 8, 24, 216, 216, 460), ("halo", 64, 8, 24, 216, 216, 460),
        ("halo", 32, 8, 28, 252, 252, 1004),
        ("halo", 32, 8, 28, 252, 252, 1004),
        ("halo", 32, 4, 26, 134, 2684, 1900),
        ("halo", 64, 4, 18, 56, 1008, 1012), ("halo", 64, 8, 16, 18, 288, 444),
        ("tap", 128, 9, 0, 0, 0, 0), ("tap", 128, 9, 0, 0, 0, 0),
        ("halo", 64, 8, 10, 12, 120, 484), ("halo", 64, 8, 8, 10, 80, 596),
        ("halo", 32, 4, 6, 12, 72, 2300), ("halo", 64, 4, 4, 6, 24, 1540),
        ("halo", 64, 8, 2, 2, 5, 1284)]
    assert conv_cuda.plan(4, 1, 9, 22, 8, 12, 1, 5, 7, DENSE) is None
    assert conv_cuda.plan(4, 1, 9, 22, 8, 30, 1, 3, 3, DENSE) is None
    assert conv_cuda.plan(4, 1, 9, 22, 6, 32, 1, 3, 3, DENSE) is None
    assert conv_cuda.plan(4, 1, 9, 22, 8, 128, 1, 3, 3, BIAS) is None
    assert conv_cuda.plan(4, 1, 9, 22, 8, 32, 1, 1, 1, DENSE).path == "halo"


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
        "no plan": (nn.Conv2d(8, 12, (3, 11)), x),
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
