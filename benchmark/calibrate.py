"""Readings of the output check's numbers, from which its limits are set:

    python3 -m benchmark.calibrate --workload <cell> --seconds <s> --seeds <n,n,...>

For each seed, one run of the cell with a short window at the cell's own
load.  Against the one float64 reference of its checked requests it reads:

- ``sound``: the program's answers;
- ``control``: the reference itself in TF32, the next precision below the
  configuration's float32 with TF32 off, in the program's place;
- ``faults``: the program's answers broken as a faulty program would
  return them: ``stale`` (a call that returns its previous answer: slot u
  of a call gets slot u of the call before), ``half_group`` (groups of
  several pairs: the later half of each group's slots get the group's
  first answer), ``altered_pose`` (each pose's translation moved by
  ALTER_M metres where it is produced) and ``altered_kpts`` (each
  keypoint moved by ALTER_M);

each number also judged by the configuration's own limits (``verdicts``).
Prints one JSON line a seed.  The benchmark's own runs do not run it.  On
the card only.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import traceback  # noqa: E402


ALTER_M = 0.1


def _faults(outputs: dict, checked, unroll: int) -> dict:
    def moved(out, field):
        out = dict(out)
        if field == "pose":
            out["pose"] = out["pose"].clone()
            out["pose"][:3, 3] += ALTER_M
        else:
            out["kpts"] = out["kpts"] + ALTER_M
        return out

    have = [r for r in checked if r in outputs]
    faults = {"stale": {r: outputs.get(r - unroll, outputs[r]) for r in have},
              "altered_pose": {r: moved(outputs[r], "pose") for r in have},
              "altered_kpts": {r: moved(outputs[r], "kpts") for r in have}}
    if unroll > 1:
        half = unroll - unroll // 2
        faults["half_group"] = {
            r: outputs[r - r % unroll] if r % unroll >= half else outputs[r]
            for r in have}
    return faults


def study(ctx) -> dict:
    """Control and fault readings against the run's reference answers."""
    import torch

    from benchmark.harness import check

    class _Prepared:
        def __init__(self, d):
            self.__dict__.update({k: torch.from_numpy(v) for k, v in d.items()})

    limits = ctx.conf.get("limits", {})
    out = {"sound": dict(ctx.numbers), "faults": {}, "verdicts": {}}
    sets = {"sound": ctx.numbers}
    for name, outs in _faults(ctx.outputs, ctx.checked, ctx.unroll).items():
        sets[name] = check.compare(ctx.reference, ctx.checked, outs,
                                   ctx.program_prep)
        out["faults"][name] = sets[name]
    control = check.Reference(ctx.conf, ctx.state, ctx.dev, ctx.traffic, "tf32")
    answers = {r: control.answer(r) for r in ctx.checked}
    detail = {"sound": {}, "control": {}}
    check.compare(ctx.reference, ctx.checked, ctx.outputs, ctx.program_prep,
                  detail["sound"])
    sets["control"] = check.compare(
        ctx.reference, ctx.checked, answers,
        lambda r: _Prepared(ctx.reference.prepare(r)), detail["control"])
    out["requests"] = detail
    out["control"] = sets["control"]
    out["verdicts"] = {k: check.verdict(v, limits)[0] for k, v in sets.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from benchmark import run as bench
    from benchmark.harness import manifest as mf
    bench.fixed_caches()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("calibrate runs on the card")
    manifest = mf.load_manifest()
    cell = mf.workload(manifest, args.workload)
    for s in (int(x) for x in args.seeds.split(",")):
        line = {"workload": cell["name"], "seed": s}
        try:
            t = time.perf_counter()
            res = bench.run_cell(manifest, cell, s, args.seconds, False,
                                 "cuda:0", t_start=t, keep_back=3, study=study)
            line.update(res["study"])
            line["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
            line["check_s"] = res["check_s"]
            line["seconds"] = time.perf_counter() - t
        except Exception:   # a seed that fails is reported, the rest run
            line["error"] = traceback.format_exc()[-2000:]
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
