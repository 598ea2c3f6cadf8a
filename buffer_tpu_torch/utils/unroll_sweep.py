"""Ways of running U pairs in one call side by side on the card.

    python -m buffer_tpu_torch.utils.unroll_sweep [--config 3DMatch|KITTI]
        [--unroll U] [--iters N]

At the preset's full static plan, with seeded random weights, on
``surface_pair`` seeds 0..U-1 (KITTI: ``lidar_pair`` seeds 13..) and draws
from a generator seeded 0, it times three ways of one call of U pairs,
each holding every pair bit-equal to ``register_pair``:

* "streams": ``make_unrolled_register_fn`` as shipped, a chain of graphs a
  pair on a stream of its own: the fronts side by side, one host read of
  the counts, the tails side by side;
* "one stream": the same chains replayed one after another on the
  caller's stream (the group's work, nothing side by side);
* "one graph": the U fronts captured as forked branches of one CUDA graph,
  launched once, writing each chain's front outputs; then the host read
  and the chains' tails as shipped.

Prints one JSON line: for each way, ms a call by the host clock (around
each synchronized call; ``--iters`` calls, the ways in turn, then again in
the reverse order) and device ms a call (CUDA events), and ms a pair; with
the card's name and power limit.  It is the evidence behind the shipped
way; the main path never calls it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from buffer_tpu_torch.pipeline import registration as reg


@contextlib.contextmanager
def one_stream(program):
    """Within the block the chains of ``program`` replay on the caller's
    stream, one after another."""
    saved = [c.stream for c in program.chains]
    caller = torch.cuda.current_stream()
    for c in program.chains:
        c.stream = caller
    try:
        yield
    finally:
        for c, s in zip(program.chains, saved):
            c.stream = s


class MergedFronts:
    """The fronts of ``program``'s chains captured as forked branches of one
    CUDA graph (in a pool of its own), each branch copying its front into
    the chain's front outputs, which the chain's tail graphs read."""

    def __init__(self, model, program):
        self.program = program
        chains = program.chains
        fork = torch.cuda.Stream()

        def fronts():
            for c in chains:
                c.stream.wait_stream(fork)
                with torch.cuda.stream(c.stream):
                    front, _ = reg.pair_front(model, c.inputs, c.draws)
                    for dst, src in zip(c.front, front):
                        dst.copy_(src)
                fork.wait_stream(c.stream)

        with torch.no_grad(), reg.full_fp32():
            self.graph, _, self.launches = reg.capture_graph(
                fronts, torch.cuda.graph_pool_handle(), fork)

    def __call__(self, inputs_list, draws_list):
        chains = self.program.chains
        caller = torch.cuda.current_stream()
        for c, inputs, draws in zip(chains, inputs_list, draws_list):
            c._load(inputs, draws)
        self.graph.replay()
        counts = torch.stack([c.front.num_mutual for c in chains]).tolist()
        outs = []
        for c, n in zip(chains, counts):
            c.stream.wait_stream(caller)
            outs.append(c.replay_tail(reg.boost_taken(self.program.cfg, n)))
        for c in chains:
            caller.wait_stream(c.stream)
        return reg._stack(outs)


def held(name: str, res, eager) -> None:
    """Every pair of ``res`` bit-equal to its eager result."""
    for u, want in enumerate(eager):
        if not all(torch.equal(a[u], b) for a, b in zip(res, want)):
            raise RuntimeError(f"{name}: pair {u} differs from register_pair")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m buffer_tpu_torch.utils."
                                      "unroll_sweep")
    ap.add_argument("--config", default="3DMatch", choices=["3DMatch", "KITTI"])
    ap.add_argument("--unroll", type=int, default=3)
    ap.add_argument("--iters", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("unroll_sweep: no CUDA device")
    from buffer_tpu_torch.config import make_cfg
    from buffer_tpu_torch.data.synthetic import lidar_pair, surface_pair
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.models.composite import BufferModel
    from buffer_tpu_torch.utils.profiling import card_line
    dev = torch.device("cuda", 0)
    cuda.build_all()
    cfg = make_cfg(args.config)
    model = BufferModel(cfg, seed=0).to(dev).eval()
    U = args.unroll
    if args.config == "KITTI":
        pairs = [lidar_pair(cfg, 13 + u, dev)[0] for u in range(U)]
    else:
        pairs = [surface_pair(cfg, u, dev)[0] for u in range(U)]
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = [reg.make_draws(cfg, gen, dev) for _ in pairs]
    eager = [reg.register_pair(model, p, d, device=dev)
             for p, d in zip(pairs, draws)]
    fn = reg.make_unrolled_register_fn(model, U, device=dev)
    held("first call", fn(pairs, draws), eager)
    (program,) = fn.programs.values()
    merged = MergedFronts(model, program)

    def serial(p, d):
        with one_stream(program):
            return fn(p, d)

    ways = {"streams": fn, "one stream": serial, "one graph": merged}
    out = {w: {"host_ms": [], "device_ms": []} for w in ways}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for order in (list(ways), list(ways)[::-1]):
        for w in order:
            call = ways[w]
            held(w, call(pairs, draws), eager)
            for _ in range(args.iters):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call(pairs, draws)
                torch.cuda.synchronize()
                out[w]["host_ms"].append(1e3 * (time.perf_counter() - t0))
            start.record()
            call(pairs, draws)
            end.record()
            end.synchronize()
            out[w]["device_ms"].append(start.elapsed_time(end))
    for w, o in out.items():
        o["ms_per_call"] = sum(o["host_ms"]) / len(o["host_ms"])
        o["ms_per_pair"] = o["ms_per_call"] / U
    print(json.dumps({"config": args.config, "unroll": U,
                      "num_mutual": [int(r.num_mutual) for r in eager],
                      "ways": out, "card": card_line()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
