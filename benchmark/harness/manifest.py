"""Finds the benchmark's pieces by the names in ``BENCHMARK.json``.

Every piece that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, named after it:

- ``configs/<config>.json``: the configuration (the port's preset, the
  sizes as they are run, the precision, the limits of the output check);
- ``traffic/<traffic>.json``: the traffic mix's parameters, read by the
  one generator in :mod:`benchmark.harness.traffic`; the mix names its
  scene generator, ``scenes/<scene>.py`` (``make(rs, **args)``), and its
  loop, ``loops/<loop>.py`` (a class ``Loop``);
- ``metrics/<metric>.py``: the per-layer metric's reader, a function
  ``read(run) -> float | None``;
- ``kernel_classes.json``: the kernel-name classes of the rooflines.

A later change adds a configuration, a mix, a metric or a kernel class by
adding files and entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    with open(root / config_entry(manifest, name)["file"]) as f:
        return json.load(f)


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_kernel_classes(bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "kernel_classes.json") as f:
        return json.load(f)


def cell_metrics(manifest: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports: a
    metric with a ``workloads`` list names its cells; one without it is
    reported by every cell that reports the end-to-end metric it moves
    (an end-to-end metric without the list: every cell)."""
    e2e = {m["name"]: m for m in manifest["end_to_end"]}

    def reports(m: dict) -> bool:
        if "workloads" in m:
            return cell in m["workloads"]
        if kind == "per_layer":
            return reports(e2e[m["moves"]])
        return True

    return [m for m in manifest[kind] if reports(m)]


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """``<kind>/<name>.py`` (``metrics``, ``loops`` or ``scenes``), loaded
    by path: a file's name is the piece's name, dots included."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {name}.py")
    tag = f"{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"benchmark_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, bench_dir: Path = BENCH_DIR
                ) -> Callable[[dict], Optional[float]]:
    """``metrics/<metric>.py``'s ``read``."""
    return load_module("metrics", metric, bench_dir).read
