"""The model's weights, made by the benchmark on the device.

Every weight of a convolution or a linear map is drawn uniform in
+-sqrt(6 / fan_in) (He's initialization: a ReLU layer keeps its input's
scale) from a ``torch.Generator`` on the device seeded with the
configuration's ``weights.seed``, in one call over all of them, then
scaled weight by weight by 1 + ``weights.perturbation`` x a uniform draw
in (-1, 1) from ``--seed`` (a second call): each run's seed gives weights
of its own, around one model of the configuration.  Biases are 0;
batch-norm statistics and affine terms and the models' constant buffers
keep their initial values (eval-mode batch norms are identities).

Why one model: how many mutual matches random descriptors find is set by
the draw of the weights far more than by the pair, so weights drawn afresh
from every seed send whole runs to the low-match tail or past it (12
seeds of ``3dmatch.testset`` read 19.3-20.0 and 21.1-21.5 pairs/s), and
the seed would change the work.  PyTorch's default initialization, at a third of that
scale with biases as large as the weights, shrinks the signal through
MiniSpinNet's eight convolutions until every descriptor is the same vector
and every saliency passes the threshold: the pipeline's outputs would then
not depend on the model, and the output check could not see a fault in it.

The names, shapes and order are the plain reference's
(:func:`benchmark.reference.buffer.parameter_layout`, the authors' names);
the port's model loads the same state dict (strictly), so both sides run
the same weights and neither made them.
"""

from __future__ import annotations

import math

import torch

from benchmark.harness.traffic import WEIGHTS, torch_seed

GAIN = math.sqrt(6.0)
INITIAL = {"one": 1.0, "zero": 0.0, "bias": 0.0, "eps": -5.0}


def make_state_dict(layout: list, seed: int, device: torch.device,
                    spec: dict) -> dict:
    """A state dict of ``layout`` ((name, shape, kind) in order), on
    ``device``: the model of ``spec`` (a configuration's ``weights``)
    perturbed by ``seed``."""
    shapes = [shape for _, shape, kind in layout if kind == "weight"]
    total = sum(math.prod(sh) for sh in shapes)
    gen = torch.Generator(device=device).manual_seed(int(spec["seed"]))
    u = torch.rand(total, generator=gen, device=device)
    gen.manual_seed(torch_seed(seed, WEIGHTS))
    u = (2.0 * u - 1.0) * (1.0 + float(spec["perturbation"]) * (
        2.0 * torch.rand(total, generator=gen, device=device) - 1.0))
    out, off = {}, 0
    for name, shape, kind in layout:
        if kind == "weight":
            n = math.prod(shape)
            fan_in = shape[1] * math.prod(shape[2:])
            out[name] = (u[off:off + n] * (GAIN / math.sqrt(fan_in))).reshape(shape)
            off += n
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            out[name] = torch.full(shape, INITIAL[kind], dtype=torch.float32,
                                   device=device)
    return out
