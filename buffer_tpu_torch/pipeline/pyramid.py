"""Static conv pyramid and input normals (counterpart of
``buffer_tpu/pipeline/pyramid.py``, its host-built-levels path).

Per level: radius-limited neighbour tables, pooling tables into the finer
level, and nearest-coarse upsample indices; radii follow the reference
(ThreeDMatch/dataloader.py:142,187-201,222): level radius
``r_l = voxel_size_0 * conv_radius * 2^l``, upsample radius ``2 * r_l``.
The level-0 kNN serves both the PCA normals and the level-0 conv list.
Every search gets its query level's mask: the banded kernels centre each
query tile's window by the ratio of the valid counts.
"""

from __future__ import annotations

import torch

from buffer_tpu_torch.config import Config
from buffer_tpu_torch.models.point_learner import Pyramid
from buffer_tpu_torch.ops.neighbors import nearest, radius_knn
from buffer_tpu_torch.ops.normals import normals_from_neighbors


def build_pyramid_and_normals(cfg: Config, points: torch.Tensor,
                              masks: torch.Tensor, levels) -> Pyramid:
    """points [B, N0, 3], masks [B, N0], levels = (lvl1, lvl1_mask, lvl2,
    lvl2_mask) built on the host (data/preprocess.prepare_pair)."""
    if levels is None:
        raise NotImplementedError(
            "on-device voxel subsampling of the pyramid levels is not ported "
            "yet: pass the host-built levels (data/preprocess.prepare_pair)")
    st = cfg.static
    r0 = cfg.data.voxel_size_0 * cfg.point.conv_radius
    band = st.knn_band or None
    chunk = st.knn_chunk
    kc = st.neighbor_caps[0]
    k0 = max(st.normal_knn, kc)
    nk = st.normal_knn

    d2, idx, v = radius_knn(points, points, masks, k=k0, radius=None,
                            query_chunk=chunk, band=band, query_valid=masks)
    normals = normals_from_neighbors(points, masks, idx[..., :nk], v[..., :nk])

    pts = (points, levels[0], levels[2])
    msk = (masks, levels[1], levels[3])
    neighbors = [idx[..., :kc]]
    neighbor_valid = [v[..., :kc] & (d2[..., :kc] <= r0 * r0) & masks[..., None]]
    for lvl in (1, 2):
        _, i, nv = radius_knn(pts[lvl], pts[lvl], msk[lvl],
                              k=st.neighbor_caps[lvl], radius=r0 * 2 ** lvl,
                              query_chunk=chunk, band=band,
                              query_valid=msk[lvl])
        neighbors.append(i)
        neighbor_valid.append(nv & msk[lvl][..., None])

    pools, pool_valid, ups, up_valid = [], [], [], []
    for lvl in (0, 1):
        r = r0 * 2 ** lvl
        _, pidx, pv = radius_knn(pts[lvl + 1], pts[lvl], msk[lvl],
                                 k=st.pool_caps[lvl], radius=r,
                                 query_chunk=chunk, band=band,
                                 query_valid=msk[lvl + 1])
        pools.append(pidx)
        pool_valid.append(pv & msk[lvl + 1][..., None])
        ud2, uidx = nearest(pts[lvl], pts[lvl + 1], msk[lvl + 1], band=band,
                            query_valid=msk[lvl])
        ups.append(uidx)
        up_valid.append((ud2 <= (2.0 * r) ** 2) & msk[lvl])
    return Pyramid(pts, msk, tuple(neighbors), tuple(neighbor_valid),
                   tuple(pools), tuple(pool_valid), tuple(ups), tuple(up_valid),
                   features=normals)
