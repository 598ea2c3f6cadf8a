"""Where the pipeline calls each kernel wrapper, and a switch to the plain
versions there: the same registration or training step on the card
without the kernels, to hold the kernel path against the plain path."""

from __future__ import annotations

import contextlib


def call_sites():
    """(module, attribute, plain version) of every kernel call site."""
    from buffer_tpu_torch.kernels import fps_cuda, geom_cuda, knn_cuda
    from buffer_tpu_torch.models import patch_embedder
    from buffer_tpu_torch.ops import neighbors, sampling
    return [(neighbors, "nearest_cuda", geom_cuda.nearest_plain),
            (neighbors, "banded_knn_cuda", knn_cuda.banded_knn_plain),
            (neighbors, "banded_nn1_cuda", knn_cuda.banded_nn1_plain),
            (neighbors, "ball_sample_planes_cuda",
             geom_cuda.ball_sample_planes_plain),
            (neighbors, "ball_sample_points_cuda",
             geom_cuda.ball_sample_points_plain),
            (sampling, "fps_cuda_batched", fps_cuda.fps_plain),
            (sampling, "fps_cuda_single", fps_cuda.fps_single_plain),
            (patch_embedder, "spt_pooled_cuda", geom_cuda.spt_pooled_plain)]


@contextlib.contextmanager
def plain_versions():
    """Within the block every kernel call site calls its plain version."""
    sites = call_sites()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
