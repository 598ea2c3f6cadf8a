"""The one generator of the benchmark's traffic, driven by a mix's data file
(``traffic/<mix>.json``):

- ``scene``: the scene generator, ``scenes/<scene>.py``'s ``make(rs,
  **args)`` (``room``: indoor fragments; ``lidar``: LiDAR sweeps);
- ``scene_args``: fixed arguments of the scene generator;
- ``spread``: ``{argument: [low, high]}`` spread evenly over the pool
  (pool pair j of n takes low + (high - low) (j + 1/2) / n), so that every
  seed sends the same set of sizes, in its own order;
- ``pool``: distinct raw pairs made in set-up, sent in a seeded order;
- ``already_downsampled``: passed to the port's ``prepare_pair``;
- ``loop``: the measured loop, ``loops/<loop>.py`` (``groups``: a test
  set prepared in set-up, sent in closed groups of the configuration's
  ``pair_unroll`` pairs);
- ``check``: how many finished requests the output check takes, drawn from
  the seed among the first ``among`` requests;
- ``trace_calls``: the calls of a ``--trace 1`` run's traced window.

Every number comes from ``--seed``: a pair, a pool pair's prep draws and a
request's registration draws each from a seed sequence of (seed, stream,
index), so the same seed gives the same inputs, and different seeds give
the same sizes and the same kind of work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.harness import manifest

# streams of the seed sequence
POOL, ORDER, DRAWS, PREP, CHECK, WEIGHTS = range(6)


def seed_words(seed: int, *keys: int) -> np.ndarray:
    """32-bit words of the seed sequence (seed, *keys); any whole seed."""
    if seed < 0:
        raise ValueError(f"seed {seed} is negative")
    return np.random.SeedSequence([seed, *keys]).generate_state(4)


def random_state(seed: int, *keys: int) -> np.random.RandomState:
    return np.random.RandomState(seed_words(seed, *keys))


def torch_seed(seed: int, *keys: int) -> int:
    w = seed_words(seed, *keys)
    return (int(w[0]) << 31 | int(w[1]) >> 1) & ((1 << 63) - 1)


class RawPair(NamedTuple):
    src: np.ndarray
    tgt: np.ndarray
    T: np.ndarray


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in (0, 1)."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, seed
        self.scene = manifest.load_module("scenes", mix["scene"]).make
        self.pool_size = int(mix["pool"])
        self.order = random_state(seed, ORDER).permutation(self.pool_size)

    def raw_pair(self, j: int) -> RawPair:
        """Pool pair ``j``: its spread arguments, then the scene from a
        RandomState of its own."""
        rs = random_state(self.seed, POOL, j)
        kw = dict(self.mix.get("scene_args", {}))
        for name, (lo, hi) in self.mix.get("spread", {}).items():
            kw[name] = lo + (hi - lo) * (j + 0.5) / self.pool_size
        return RawPair(*self.scene(rs, **kw))

    def pool(self) -> list:
        return [self.raw_pair(j) for j in range(self.pool_size)]

    def pair_of(self, request: int) -> int:
        """The pool index that request ``request`` sends."""
        return int(self.order[request % self.pool_size])

    def prep_state(self, key: int) -> np.random.RandomState:
        """The RandomState of ``prepare_pair`` for pool pair ``key``."""
        return random_state(self.seed, PREP, key)

    def draws(self, cfg, request: int, device, draws_type):
        """Request ``request``'s registration draws on ``device``, as
        ``draws_type`` (the port's or the reference's ``Draws``; ``cfg``: the
        port's ``Config`` or the reference's settings): ball and
        SPT priorities and the RANSAC Gumbel noise of both budgets."""
        gen = torch.Generator(device=device)
        gen.manual_seed(torch_seed(self.seed, DRAWS, request))
        rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
        H, K = cfg.match.hypotheses, cfg.point.num_keypts
        boost = (gumbel_from_uniform(rand(4 * H, 3, K))
                 if cfg.static.low_match_boost else None)
        return draws_type(ball_prio=rand(2, cfg.static.raw_points),
                          spt_prio=rand(cfg.patch.num_points_per_patch),
                          ransac_gumbel=gumbel_from_uniform(rand(H, 3, K)),
                          ransac_gumbel_boost=boost)

    def checked_requests(self) -> list:
        """The requests whose outputs the check compares, drawn from the
        seed among the first ``check.among``."""
        c = self.mix["check"]
        rs = random_state(self.seed, CHECK)
        return sorted(int(r) for r in rs.choice(c["among"], c["requests"],
                                                 replace=False))
