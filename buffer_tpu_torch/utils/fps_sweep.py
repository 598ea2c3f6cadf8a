"""Per-step latency of the cluster FPS kernel over launch plans, on the card.

    python -m buffer_tpu_torch.utils.fps_sweep [--steps 1500]

For each cloud size (4096 to 65536 points, two clouds of seeded random
points, 70% eligible) it launches ``csrc/fps.cu`` with the plan of
:func:`~buffer_tpu_torch.kernels.fps_cuda.fps_plan` and with alternatives
(other cluster sizes, threads a CTA and points a thread), checks each
against the plain version on the first 200 steps, and prints one JSON line
a plan: the plan, whether it is ``fps_plan``'s, the card's count of active
clusters for it (``cudaOccupancyMaxActiveClusters``) and microseconds a
step (CUDA events over 5 launches after a warm-up).  It is the evidence
behind ``fps_plan``'s rule; the main path never calls it.
"""

from __future__ import annotations

import argparse
import json

import torch

from buffer_tpu_torch.kernels import cuda, fps_cuda

ALTERNATIVES = {
    4096: [(8, 512, 1), (4, 256, 4)],
    8192: [(8, 256, 4), (8, 1024, 1)],
    30720: [(8, 960, 4), (8, 480, 8), (16, 480, 4), (15, 128, 16)],
    40960: [(8, 640, 8), (16, 320, 8), (10, 256, 16)],
    65536: [(8, 512, 16), (16, 512, 8)],
}


def launch(pts: torch.Tensor, elig: torch.Tensor, steps: int, plan) -> torch.Tensor:
    """``csrc/fps.cu`` with an explicit plan (the launcher checks it)."""
    B, N, _ = pts.shape
    out = torch.empty((B, steps), dtype=torch.int32, device=pts.device)
    fps_cuda.FPS.launch(pts.data_ptr(), elig.view(torch.uint8).data_ptr(), B, N,
                        steps, *plan, out.data_ptr(), cuda.stream_handle(pts))
    return out


def us_per_step(fn, steps: int, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return 1e3 * start.elapsed_time(end) / iters / (steps - 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fps_sweep: needs a CUDA device")
    cuda.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for N, alts in ALTERNATIVES.items():
        pts = torch.randn((2, N, 3), device="cuda", generator=gen)
        elig = torch.rand((2, N), device="cuda", generator=gen) > 0.3
        want = fps_cuda.fps_plain(pts, elig, 200)
        for plan in [fps_cuda.fps_plan(N)] + alts:
            plan = tuple(plan)
            print(json.dumps({
                "N": N, "plan": plan, "fps_plan": plan == fps_cuda.fps_plan(N),
                "max_active_clusters": fps_cuda.fps_max_active_clusters(plan),
                "equal_to_plain": bool(torch.equal(launch(pts, elig, 200, plan),
                                                   want)),
                "us_per_step": us_per_step(
                    lambda: launch(pts, elig, args.steps, plan), args.steps),
                "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
