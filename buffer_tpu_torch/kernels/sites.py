"""Where the pipeline calls each kernel wrapper, and a switch to the plain
versions there: the same registration or training step on the card
without the kernels, to hold the kernel path against the plain path."""

from __future__ import annotations

import contextlib


def call_sites():
    """(module, attribute, plain version) of every kernel call site."""
    from buffer_tpu_torch.core import se3
    from buffer_tpu_torch.kernels import (conv_cuda, cyl_cuda, fps_cuda,
                                          geom_cuda, knn_cuda, pose_cuda)
    from buffer_tpu_torch.models import heads, patch_embedder
    from buffer_tpu_torch.nn import cylindrical
    from buffer_tpu_torch.ops import neighbors, sampling
    from buffer_tpu_torch.pipeline import ransac, refine
    return [(neighbors, "nearest_cuda", geom_cuda.nearest_plain),
            (neighbors, "banded_knn_cuda", knn_cuda.banded_knn_plain),
            (neighbors, "banded_nn1_cuda", knn_cuda.banded_nn1_plain),
            (neighbors, "ball_sample_planes_cuda",
             geom_cuda.ball_sample_planes_plain),
            (neighbors, "ball_sample_points_cuda",
             geom_cuda.ball_sample_points_plain),
            (sampling, "fps_cuda_batched", fps_cuda.fps_plain),
            (sampling, "fps_cuda_single", fps_cuda.fps_single_plain),
            (patch_embedder, "spt_pooled_cuda", geom_cuda.spt_pooled_plain),
            (ransac, "kabsch_cuda", se3.kabsch_quat),
            (refine, "irls_cuda", pose_cuda.irls_plain),
            (cylindrical, "cyl_pad_cuda", cyl_cuda.cyl_pad_plain),
            (cylindrical, "conv_pad_cuda", conv_cuda.conv_pad_plain),
            (cylindrical, "conv_bn_relu_cuda", conv_cuda.conv_bn_relu_plain),
            (cylindrical, "conv_bias_cuda", conv_cuda.conv_bias_plain),
            (heads, "cost_volume_cuda", heads.cost_volume)]


# the convolution sites: their kernel sums in another order than its plain
# version (cuDNN), so a comparison of what follows the descriptors
# (matches, poses) keeps them on the kernel, and each call is held to a
# float64 convolution instead
CONVOLUTIONS = ("conv_pad_cuda", "conv_bn_relu_cuda", "conv_bias_cuda")


@contextlib.contextmanager
def plain_versions(keep=()):
    """Within the block every kernel call site calls its plain version,
    but the sites named in ``keep``."""
    sites = [site for site in call_sites() if site[1] not in keep]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_active() -> bool:
    """Whether :func:`plain_versions` is in force: a captured graph bakes
    the kernel-or-plain choice in, so it keys the compiled programs."""
    return any(getattr(mod, name) is plain for mod, name, plain in call_sites())
