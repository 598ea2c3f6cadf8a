"""The ``groups`` loop: a test set whose host prep is done.  Set-up
prepares each pool pair once with the port's ``prepare_pair`` and keeps it
as CPU tensors, as ``run_eval``'s producer yields them; the window sends
groups of the configuration's ``pair_unroll`` pairs back to back through
``make_unrolled_register_fn``, each pair with draws of its own, the copy
to the card inside the call.  A step is one call: draws, the program, and
its poses on the host."""

from __future__ import annotations

from torch.profiler import record_function

from benchmark.harness.window import keep_outputs


class Loop:
    def __init__(self, ctx):
        from buffer_tpu_torch.data.preprocess import prepare_pair
        from buffer_tpu_torch.pipeline import registration
        self.traffic, self.cfg, self.dev = ctx.traffic, ctx.cfg, ctx.dev
        self.keep = set(ctx.keep)
        self.draws_type = registration.Draws
        self.unroll = self.cfg.static.pair_unroll
        self.inputs = [prepare_pair(self.cfg, p.src.copy(), p.tgt.copy(),
                                    rs=self.traffic.prep_state(j),
                                    already_downsampled=self.traffic.mix[
                                        "already_downsampled"],
                                    device="cpu")
                       for j, p in enumerate(self.traffic.pool())]
        self.fn = registration.make_unrolled_register_fn(ctx.model, self.unroll,
                                                         device=self.dev)

    def program_prep(self, request: int):
        """The program's prepared pair of ``request``."""
        return self.inputs[self.traffic.pair_of(request)]

    def step(self, first: int, w) -> int:
        reqs = range(first, first + self.unroll)
        inputs = [self.program_prep(r) for r in reqs]
        with record_function("bench.draws"):
            draws = [self.traffic.draws(self.cfg, r, self.dev, self.draws_type)
                     for r in reqs]
        with record_function("bench.program"):
            res = self.fn(inputs, draws)
        with record_function("bench.pose_read"):
            res.pose.cpu()
        for u, r in enumerate(reqs):
            if r in self.keep:
                w.outputs[r] = keep_outputs(res, u)
        w.attempted += self.unroll
        w.pairs += self.unroll
        w.calls += 1
        return first + self.unroll

    def close(self) -> None:
        """Frees the program before the output check."""
        del self.fn
