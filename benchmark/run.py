"""The benchmark of buffer_tpu_torch: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name from ``BENCHMARK.json``
(:mod:`benchmark.harness.manifest`).  A run:

1. exits with 2 and prints no result when no CUDA card is present, or
   fewer than the cell asks for;
2. set-up (``setup_s``, from the start of the process): the kernels'
   build (cached in the checkout's ``build/``), the weights made on the
   card from the seed, the traffic's pool, the mix's loop
   (``loops/<loop>.py``: its prep and its program) and two warm-up calls,
   the first of which captures the program's CUDA graphs;
3. the window: ``--seconds`` of the loop's steps back to back;
4. with ``--trace 1``, a traced segment after the window
   (:mod:`benchmark.harness.trace`);
5. the program freed, the output check against the plain reference
   (:mod:`benchmark.harness.check`), each compared number printed beside
   its limit as the last lines of standard error;
6. exits with 3 and prints no result if ``jax``, ``jaxlib``, ``flax`` or
   ``buffer_tpu`` was loaded (top-level module names compared whole);
7. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (``--trace 0``: the cell's end-to-end metrics; ``--trace
   1``: its per-layer metrics), ``device``, ``breakdown`` (traced runs) and,
   last, ``checks``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FOREIGN = ("jax", "jaxlib", "flax", "buffer_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/benchmark/torch_extensions",
              "TRITON_CACHE_DIR": "build/benchmark/triton"}


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``buffer_tpu_torch`` is not
    ``buffer_tpu``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FOREIGN})


def fixed_caches(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into ``build/kernels`` there)."""
    for var, rel in CACHE_DIRS.items():
        os.environ.setdefault(var, str(root / rel))


def run_cell(manifest: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device, conf: dict = None, mix: dict = None,
             t_start: float = None, keep_back: int = 0, study=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object.
    ``conf`` and ``mix`` replace the files' (tests run a smaller plan on
    the CPU).  ``keep_back`` keeps the answers of that many requests before
    each checked one too, and ``study(ctx)``, when given, runs after the
    check and its dict is the result's ``study`` (:mod:`benchmark.calibrate`)."""
    import types

    import torch

    from benchmark import arith
    from benchmark.harness import check, manifest as mf, window as win
    from benchmark.harness.configs import port_config
    from benchmark.harness.traffic import Traffic
    from benchmark.harness.trace import traced_segment
    from benchmark.harness.weights import make_state_dict
    from benchmark.reference.buffer import parameter_layout, settings
    from buffer_tpu_torch.kernels import cuda
    from buffer_tpu_torch.models.composite import BufferModel

    t_start = T_PROCESS if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    conf = conf or mf.load_config(manifest, cell["config"])
    mix = mix or mf.load_traffic(cell["traffic"])
    cfg = port_config(conf)
    warnings.filterwarnings("ignore", message="cloud with", category=RuntimeWarning)

    # ---- set-up
    if on_card:
        cuda.build_all()
    state = make_state_dict(parameter_layout(settings(conf)), seed, dev,
                            conf["weights"])
    model = BufferModel(cfg).to(dev)
    model.load_state_dict(state, strict=True)
    model.eval()
    traffic = Traffic(mix, seed)
    checked = traffic.checked_requests()
    keep = {r - b for r in checked for b in range(keep_back + 1) if r >= b}
    loop = mf.load_module("loops", mix["loop"]).Loop(types.SimpleNamespace(
        traffic=traffic, cfg=cfg, dev=dev, model=model, keep=keep))
    win.warm_up(loop, 2)
    setup_s = time.perf_counter() - t_start

    # ---- the window, then the traced segment
    window = win.run(loop, seconds=seconds)
    tr = None
    if trace:
        tr = traced_segment(loop, mf.load_kernel_classes(),
                            int(mix["trace_calls"]), window.attempted)
    mem = {"reserved_peak": torch.cuda.max_memory_reserved(dev) if on_card else 0,
           "allocated_peak": torch.cuda.max_memory_allocated(dev) if on_card else 0}

    run = {"cell": cell, "config": conf, "traffic": mix, "window": window,
           "trace": tr, "setup_s": setup_s, "memory": mem,
           "peaks": arith.peaks(),
           "classes": mf.load_kernel_classes() if trace else None}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in mf.cell_metrics(manifest, cell["name"], kind):
        value = mf.load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- the output check, with the program freed
    outputs = window.outputs
    unroll = getattr(loop, "unroll", 1)
    loop.close()
    program_prep = loop.program_prep
    del model
    gc.collect()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    reference = check.Reference(conf, state, dev, traffic)
    numbers = check.compare(reference, checked, outputs, program_prep)
    check_s = time.perf_counter() - t_check
    correct, table = check.verdict(numbers, conf.get("limits", {}))

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": mem["reserved_peak"]}
    result = {"correct": correct, "attempted": window.attempted,
              "failed": int(numbers["missing"]), "metrics": metrics,
              "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["check_s"] = check_s
    if study is not None:
        result["study"] = study(types.SimpleNamespace(
            conf=conf, state=state, dev=dev, traffic=traffic, checked=checked,
            outputs=outputs, unroll=unroll, program_prep=program_prep,
            reference=reference, numbers=numbers))
    result["checks"] = table
    return result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.seed < 0:
        print(f"--seed {args.seed}: a seed is a whole number >= 0",
              file=sys.stderr)
        return 2
    fixed_caches()
    from benchmark.harness import manifest as mf
    manifest = mf.load_manifest()
    cell = mf.workload(manifest, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{n} present", file=sys.stderr)
        return 2
    result = run_cell(manifest, cell, args.seed, args.seconds,
                      bool(args.trace), "cuda:0")
    bad = foreign_modules()
    if bad:
        print(f"loaded in the measured process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
