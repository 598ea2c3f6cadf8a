"""Training-step device time at the full 3DMatch static plan on the card
(counterpart of the repository's ``scripts/profile_train.py``):

    python -m buffer_tpu_torch.scripts.profile_train
        [--stages Ref,Desc,Keypt,Inlier] [--precision-check]

For each stage, a fresh ``BufferModel(cfg, seed=0)``, ``make_optimizer``'s
Adam and the compiled step (``train.trainer.make_train_step``: one CUDA
graph) on ``profile_stages``' pair (``bench_pair``, seed 0) with its
ground-truth pose and draws from a generator seeded 0: the first call (the
eager step, then the capture), then the replay's device ms by
:func:`~buffer_tpu_torch.utils.profiling.replay_time` (the same
differencing as ``graph_time``, over replays of the step itself: a replay
cannot be captured into another graph).  The replays update the weights
and Adam's state, as the JAX script's scan does.

``--precision-check`` (:func:`precision_check`, the counterpart of the JAX
script's ``high`` against ``highest`` matmul precision): one loss and
gradient of each stage from the same fresh state, batch and draws with
TF32 allowed (matmuls and cuDNN) and with ``full_fp32()``; the gradients'
relative L2 error.

Prints one JSON line: the card (name, power limit), each stage's replay
ms, first-call ms, capture seconds and first loss, and the precision
check.  Runs on the CUDA card only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
from typing import Optional, Sequence

import torch

STAGES = ("Ref", "Desc", "Keypt", "Inlier")
DET_MARGIN = 1.05            # the detector loss margin of 3DMatch training


@contextlib.contextmanager
def tf32_allowed():
    """TF32 on for matmuls and cuDNN convolutions within the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def rel_l2(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> float:
    """|got - want| / |want| over all tensors together (L2 norms)."""
    num = sum(float(torch.sum((a.double() - b.double()) ** 2))
              for a, b in zip(got, want))
    den = sum(float(torch.sum(b.double() ** 2)) for b in want)
    return math.sqrt(num / max(den, 1e-30))


def stage_grads(model, stage: str, batch, draws, det_margin: float,
                tf32: bool):
    """Loss and the stage's gradients (zeros where the loss does not reach a
    parameter) of one train-mode forward and backward of ``stage_loss``'s
    body, with TF32 allowed or with ``full_fp32()``; the running statistics
    are put back afterwards."""
    from buffer_tpu_torch.pipeline import train_forward as tf
    from buffer_tpu_torch.pipeline.registration import full_fp32
    params = list(getattr(model, stage).parameters())
    saved = [b.clone() for b in model.buffers()]
    model.eval()
    getattr(model, stage).train(True)
    with tf32_allowed() if tf32 else full_fp32():
        loss, _ = tf._stage_loss(model, stage, batch.inputs, batch.relt_pose,
                                 draws, True, det_margin)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    model.eval()
    with torch.no_grad():
        for b, s in zip(model.buffers(), saved):
            b.copy_(s)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(params, grads)]


def precision_check(cfg, batch, draws, stages, det_margin: float) -> list:
    """For each stage, from a fresh ``BufferModel(cfg, seed=0)`` on the
    batch's device: the gradients' relative L2 error with TF32 allowed
    against ``full_fp32()``, and both losses."""
    from buffer_tpu_torch.models.composite import BufferModel
    dev = batch.relt_pose.device
    out = []
    for stage in stages:
        model = BufferModel(cfg, seed=0).to(dev)
        loss_tf32, g_tf32 = stage_grads(model, stage, batch, draws,
                                        det_margin, True)
        loss_fp32, g_fp32 = stage_grads(model, stage, batch, draws,
                                        det_margin, False)
        out.append({"stage": stage, "grad_rel_l2": rel_l2(g_tf32, g_fp32),
                    "loss_tf32": float(loss_tf32),
                    "loss_fp32": float(loss_fp32)})
    return out


def time_stage(cfg, stage: str, batch, draws, det_margin: float, dev) -> dict:
    """The compiled step of ``stage`` from a fresh model: its first call
    (eager step and capture) and the replay's device ms."""
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.train.trainer import make_optimizer, make_train_step
    from buffer_tpu_torch.utils.profiling import StepTimer, replay_time
    model = BufferModel(cfg, seed=0).to(dev)
    opt, _ = make_optimizer(cfg, model, stage)
    fn = make_train_step(model, opt, stage, det_margin, dev)
    first = StepTimer()
    with first.measure():
        loss, _ = fn(batch, draws)
    (program,) = fn.programs.values()
    return {"stage": stage, "replay_ms": replay_time(lambda: fn(batch, draws)),
            "first_call_ms": 1e3 * first.median, "capture_s": program.capture_s,
            "first_loss": float(loss)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m buffer_tpu_torch.scripts.profile_train")
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--precision-check", action="store_true",
                    help="also compare each stage's gradient with TF32 "
                         "allowed against full fp32")
    args = ap.parse_args(argv)
    stages = args.stages.split(",")
    if not set(stages) <= set(STAGES):
        ap.error(f"--stages: each of {STAGES}")

    from buffer_tpu_torch import resolve_device
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.pipeline.train_forward import make_train_draws
    from buffer_tpu_torch.scripts.profile_stages import profile_pair
    from buffer_tpu_torch.train.trainer import TrainBatch
    from buffer_tpu_torch.utils.profiling import card_line

    dev = resolve_device(None)
    cuda.build_all()
    cfg = make_cfg("3DMatch")
    inputs, T, _ = profile_pair(cfg, dev)
    batch = TrainBatch(inputs, torch.as_tensor(T, device=dev))
    draws = make_train_draws(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    out = {"card": card_line(), "config": "3DMatch", "weights": "random, seed 0",
           "stages": []}
    for stage in stages:
        out["stages"].append(time_stage(cfg, stage, batch, draws, DET_MARGIN,
                                        dev))
        torch.cuda.empty_cache()
    if args.precision_check:
        out["precision"] = precision_check(cfg, batch, draws, stages,
                                           DET_MARGIN)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
