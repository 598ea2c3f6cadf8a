"""Shared pieces of the benchmark's tests: a smaller plan of each
configuration for CPU runs of the harness, and the card fixture of tests
that need one (decided when the test runs, never at import)."""

import dataclasses

import pytest

from benchmark.harness import manifest as mf

def small(cell_name: str, pool: int = 3, among: int = 3):
    """(manifest, cell, conf, mix) with the configuration shrunk to the
    port's miniature test plan, every data and semantic field and the
    configuration's limits kept."""
    from buffer_tpu_torch.config import make_cfg, shrink_static
    man = mf.load_manifest()
    cell = mf.workload(man, cell_name)
    conf = mf.load_config(man, cell["config"])
    tree = dataclasses.asdict(shrink_static(make_cfg(conf["preset"])))
    tree.pop("train")
    tree.pop("optim")
    conf = dict(conf, model=tree)
    mix = dict(mf.load_traffic(cell["traffic"]), pool=pool,
               check={"requests": min(2, among), "among": among})
    return man, cell, conf, mix


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")
