"""Work of the search kernels of one registered pair, counted from the
configuration's shapes, and its least time on the card.

The formulas are those of ``PERF.md``'s kernel table (the port's section 6
at commit c88a0e7761321c01585f758b60ff2700171e6a6a): a distance test is 8
operations (3 differences, 3 products, 2 sums), a ball test 7, an FPS
step's update 9 a point; a kernel's least time is the larger of its
operations over the fp32 peak and its bytes (inputs read once, outputs
written once) over the HBM rate.  The calls follow the pyramid's routes
(``pipeline/pyramid.py``, ``ops/neighbors.py``): a kNN whose support the
band restricts, or whose window covers the grid, runs the banded kernel
(``bknn``) over an effective window of ``min(win_rows, 16 * (rows //
16)) * 128`` ranks; a restricting 1-NN the banded 1-NN kernel (``bnn1``,
+-1024 ranks); an unrestricted 1-NN the exact kernel (``nearest``); an
unrestricted, uncovered kNN the dense PyTorch search, which is no search
kernel and is not counted.  Classes are those of ``kernel_classes.json``.
"""

from __future__ import annotations

NSEG = 128            # ranks a grid row
NN1_WINDOW = 2048     # +-1024 ranks


def _rows(S: int) -> int:
    return -(-S // NSEG)


def _knn_window(S: int, band: int):
    """(route, window ranks) of a masked kNN over S support points."""
    if not band:
        return "dense", S
    NR = _rows(S)
    if NR * NSEG > (1 << 16) or (NR // 16) * 16 < 16:
        return ("fallback" if 2 * band < S else "dense"), S
    want = -(-2 * band // NSEG)
    wr = -(-max(want, 16) // 16) * 16
    lw = min(wr, (NR // 16) * 16)
    if 2 * band < S or lw >= NR:
        return "bknn", lw * NSEG
    return "dense", S


def _nn1(S: int, band: int) -> str:
    if band and 2 * band < S:
        NR = _rows(S)
        return "bnn1" if NR * NSEG <= (1 << 16) and NR >= 16 else "fallback"
    return "nearest"


def calls(m: dict) -> list:
    """(class, queries, support, window, k) of each search-kernel call of a
    pair, both clouds in one call."""
    st = m["static"]
    band = st["knn_band"]
    n = (st["points_l0"], st["points_l1"], st["points_l2"])
    caps = st["neighbor_caps"]
    k0 = max(st["normal_knn"], caps[0])
    out = []
    for q, s, k in ((n[0], n[0], k0), (n[1], n[1], caps[1]),
                    (n[2], n[2], caps[2]), (n[1], n[0], st["pool_caps"][0]),
                    (n[2], n[1], st["pool_caps"][1])):
        route, w = _knn_window(s, band)
        if route == "bknn":
            out.append(("search.bknn", q, s, w, k))
    for q, s in ((n[0], n[1]), (n[1], n[2])):
        route = _nn1(s, band)
        if route in ("bnn1", "nearest"):
            out.append((f"search.{route}", q, s,
                        NN1_WINDOW if route == "bnn1" else s, 1))
    return out


def work(m: dict) -> dict:
    """{class: (operations, bytes)} of one pair."""
    p, st = m["patch"], m["static"]
    K = m["point"]["num_keypts"]
    B = 2
    acc = {}

    def add(c, ops, byts):
        o, b = acc.get(c, (0, 0))
        acc[c] = (o + ops, b + byts)

    for c, q, s, w, k in calls(m):
        add(c, B * q * w * 8, B * (16 * q + 13 * s + 9 * q * k))
    n0 = st["points_l0"]
    add("search.fps", B * (K - 1) * n0 * 9, B * (13 * n0 + 4 * K))
    R = st["raw_points"]
    S = p["num_points_per_patch"]
    add("search.ball", B * K * R * 7, B * (17 * R + 12 * K + 13 * K * S))
    nseg = max(p["voxel_sample"], -(-S // 256))
    while S % nseg:
        nseg += 1
    s_eff = min(p["voxel_sample"], nseg) * (S // nseg)
    A = p["rad_n"] * p["ele_n"] * p["azi_n"]
    add("search.spt", B * K * A * s_eff * 7,
        B * K * (12 * s_eff + 36 + 64 * A))
    return acc


def bound_s(m: dict, peaks: dict) -> dict:
    """{class: least seconds a pair}."""
    return {c: max(o / peaks["fp32_flops_per_s"], b / peaks["hbm_bytes_per_s"])
            for c, (o, b) in work(m).items()}
