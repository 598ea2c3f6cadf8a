"""Building, loading and launching the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with ``ctypes``.
Libraries are built at first use into ``build/kernels/`` at the repository
root, named by a hash of their source and flags, so a stale build is never
loaded; :func:`build_all` compiles every source at once, one ``nvcc`` each.

Every kernel is a :class:`Kernel`: its wrapper (``kernels/geom_cuda.py``,
``kernels/fps_cuda.py``, ``kernels/knn_cuda.py``, ``kernels/pose_cuda.py``,
``kernels/cyl_cuda.py``, ``kernels/conv_cuda.py``)
launches it on PyTorch's current stream, raises on the launch's error
code, and counts the launch.  ``--fmad=false`` keeps every multiply and
add separately rounded, as in the plain PyTorch versions beside each
wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = REPO_ROOT / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


class NativeLib:
    """One shared library compiled from ``sources`` by ``compiler``."""

    def __init__(self, name: str, sources: Sequence[Path], compiler: str,
                 flags: Sequence[str], subdir: str,
                 signatures: Dict[str, tuple]):
        self.name = name
        self.sources = [Path(s) for s in sources]
        self.compiler = compiler          # "nvcc" or a host C++ compiler
        self.flags = list(flags)
        self.subdir = subdir
        self.signatures = signatures     # symbol -> (restype, argtypes)
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        h = hashlib.sha256()
        for s in self.sources:
            h.update(s.read_bytes())
        h.update(" ".join([self.compiler] + self.flags).encode())
        return BUILD_DIR / self.subdir / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start(self):
        """Start the compiler unless the library is already built; returns
        (process, temporary output) or None."""
        out = self.path()
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
        exe = (nvcc_path() if self.compiler == "nvcc"
               else shutil.which(self.compiler))
        if exe is None:
            raise RuntimeError(f"{self.compiler} not found: cannot build "
                               f"{self.name}")
        argv = [exe] + self.flags + ["-o", str(tmp)] + [str(s) for s in self.sources]
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"building {self.name} failed:\n{log}")
        os.replace(tmp, self.path())
        self.path().with_suffix(".log").write_text(log)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish(self.start())
                lib = ctypes.CDLL(str(self.path()))
                for sym, (restype, argtypes) in self.signatures.items():
                    fn = getattr(lib, sym)
                    fn.restype = restype
                    fn.argtypes = argtypes
                self._lib = lib
            return self._lib


class Kernel:
    """A CUDA kernel behind a C launcher that returns ``cudaGetLastError()``.

    ``launches`` counts successful launches and nothing else."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.name = name
        self.source = source                      # path in the repository
        self.symbol = symbol
        self.replaces = replaces                  # file:line of the TPU kernel
        self.lib = NativeLib(name, [CSRC / Path(source).name], "nvcc",
                             NVCC_FLAGS, "kernels", {symbol: (I, argtypes)})
        self.launches = 0

    def launch(self, *args) -> None:
        fn = getattr(self.lib.load(), self.symbol)
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """The kernels have no backward: raise when autograd would need one,
    rather than return outputs silently cut from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward, but an input "
                           "requires a gradient")


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all() -> Dict[str, str]:
    """Compile every kernel library at once (one nvcc each); returns each
    kernel's build log (``-Xptxas -v`` register and spill report)."""
    # the wrapper modules register their kernels when first imported
    from buffer_tpu_torch.kernels import (  # noqa: F401
        conv_cuda, cyl_cuda, fps_cuda, geom_cuda, knn_cuda, pose_cuda)
    ks = list(KERNELS.values())
    nvcc_path()
    started = [(k, k.lib.start()) for k in ks]
    for k, s in started:
        k.lib.finish(s)
    logs = {}
    for k in ks:
        k.lib.load()
        log_file = k.lib.path().with_suffix(".log")
        logs[k.name] = log_file.read_text() if log_file.exists() else ""
    return logs


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Adds ``counts`` to the kernels' counts: the launches of a replayed
    CUDA graph, recorded when it was captured (a replay runs no Python)."""
    for name, n in counts.items():
        KERNELS[name].launches += n
