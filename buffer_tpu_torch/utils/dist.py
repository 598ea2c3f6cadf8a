"""Data parallelism over fragment pairs: process groups, rank devices and a
launcher of ranks.

This stands where the JAX package puts a ``jax.sharding.Mesh`` with its
``dp`` axis (``buffer_tpu/train/trainer.py:109``,
``buffer_tpu/eval/harness.py:245``); no module there corresponds.  One rank
is one process with one pair at a time; collectives go through
``torch.distributed`` with the backend its caller names: NCCL across
cards, gloo on the CPU or for ranks that share one card (NCCL refuses two
ranks on one device).  Nothing here changes the backend or drops to one
process when something fails.

:func:`launch` starts ranks as fresh interpreters::

    python -m buffer_tpu_torch.utils.dist --target MODULE:FUNCTION \\
        --payload FILE --out FILE --rank R --world W [--backend B]

Each rank loads the payload, joins the group (with ``--backend``, through a
``file://`` rendezvous in the launch's own directory under ``build/dist/``;
without it the target joins one itself from the ``torchrun`` variables
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``,
which every rank gets), calls ``FUNCTION(payload)`` and saves what it
returns.  A rank that fails, or any rank still running at the time limit,
makes the launcher kill every rank and raise.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from buffer_tpu_torch.kernels.cuda import BUILD_DIR, REPO_ROOT


def init_dp(backend: str, init_method: str, rank: int, world: int,
            timeout: float = 600.0) -> None:
    """Joins the default process group of ``world`` ranks as ``rank`` with
    ``backend`` ("nccl", "gloo", ...) at ``init_method`` ("env://",
    "file://...", "tcp://host:port").  With NCCL the rank's card becomes
    the current device first."""
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when ``device`` names it, otherwise card
    ``LOCAL_RANK % device_count`` (several ranks may share a card)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device present; pass device='cpu' to run "
                           "the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def group_size(group=None) -> int:
    """Ranks in ``group`` (default: the default group); 1 when no group is
    initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def group_src(group=None) -> int:
    """The global rank of ``group``'s rank 0."""
    return 0 if group is None else dist.get_global_rank(group, 0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 4000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-n:]


def run_ranks(argvs: Sequence[Sequence[str]], envs: Sequence[dict],
              timeout: float, log_dir: Path) -> None:
    """Runs one process a rank (``argvs[r]`` with ``envs[r]``), each writing
    its output to ``log_dir/rank<r>.log``.  Returns when every rank exited
    with 0; when one exits otherwise, or ``timeout`` seconds pass, kills
    the others and raises with the failed rank's last output."""
    procs, logs = [], []
    try:
        for r, (argv, env) in enumerate(zip(argvs, envs)):
            logs.append(open(log_dir / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(list(argv), env=env, cwd=REPO_ROOT,
                                          stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                raise RuntimeError(
                    f"rank {r} of {len(procs)} exited with {codes[r]}:\n"
                    f"{_tail(log_dir / f'rank{r}.log')}")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                running = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(
                    f"ranks {running} of {len(procs)} still running after "
                    f"{timeout} s; rank {running[0]}:\n"
                    f"{_tail(log_dir / f'rank{running[0]}.log')}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()


def launch(target: str, payload: Any, world: int, backend: Optional[str] = None,
           device=None, timeout: float = 600.0,
           threads: Optional[int] = None) -> List[Any]:
    """Runs ``target`` ("module:function", importable from this package's
    checkout) as ``world`` ranks, each a fresh interpreter that calls
    ``function(payload)``; returns what each rank returned (CPU tensors),
    by rank.  ``payload`` travels through ``torch.save``: CPU tensors,
    named tuples, configs.  With ``backend`` every rank joins the default
    group before the call; without, the target joins one from the
    ``torchrun`` variables.  ``threads`` sets each rank's
    ``torch.set_num_threads``.  Unless ``device`` is the CPU, the kernels
    are built here first, so that ranks never build them side by side."""
    if world < 1:
        raise ValueError(f"world {world} < 1")
    if device is None or torch.device(device).type == "cuda":
        from buffer_tpu_torch.kernels import (cuda, fps_cuda,  # noqa: F401
                                              geom_cuda, knn_cuda)
        cuda.build_all()
    (BUILD_DIR / "dist").mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="launch_", dir=BUILD_DIR / "dist"))
    try:
        torch.save(payload, tmp / "payload.pt")
        port = str(free_port())
        argvs, envs = [], []
        for r in range(world):
            argv = [sys.executable, "-m", "buffer_tpu_torch.utils.dist",
                    "--target", target, "--payload", str(tmp / "payload.pt"),
                    "--out", str(tmp / f"out{r}.pt"), "--rank", str(r),
                    "--world", str(world), "--timeout", str(timeout)]
            if backend is not None:
                argv += ["--backend", backend,
                         "--init-method", f"file://{tmp / 'rendezvous'}"]
            if threads is not None:
                argv += ["--threads", str(threads)]
            argvs.append(argv)
            envs.append(dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                             WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                             MASTER_ADDR="localhost", MASTER_PORT=port))
        run_ranks(argvs, envs, timeout, tmp)
        return [torch.load(tmp / f"out{r}.pt", map_location="cpu",
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m buffer_tpu_torch.utils.dist")
    ap.add_argument("--target", required=True)
    ap.add_argument("--payload", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)
    if args.threads is not None:
        torch.set_num_threads(args.threads)
    module, name = args.target.split(":")
    fn = getattr(importlib.import_module(module), name)
    # the launcher wrote this file for this call alone
    payload = torch.load(args.payload, map_location="cpu", weights_only=False)
    if args.backend is not None:
        init_dp(args.backend, args.init_method, args.rank, args.world,
                args.timeout)
    try:
        out = fn(payload)
    except BaseException:
        # exit at once: the other ranks may wait in a collective, and the
        # launcher ends them when it sees this exit
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.save(out, args.out)


if __name__ == "__main__":
    _rank_main()
