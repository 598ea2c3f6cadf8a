"""Compiled programs: a body captured once as CUDA graphs for each input
signature and replayed on every later call, as ``jax.jit`` compiles once a
signature.  The registration program (``pipeline/registration.py``), the
training steps (``train/trainer.py``) and ``utils/profiling.graph_time``
build theirs from these pieces:

* :func:`signature`, the key of a program;
* :func:`cache`, one program a signature: the first call builds it and
  returns its eager result, later calls replay it;
* :func:`empty_like` and :func:`load`, the static inputs that a graph
  reads, and the copy of a call's inputs into them;
* :func:`warm`, the eager run before a capture, on a side stream;
* :func:`capture_graph`, with the kernels' launch counts of a replay;
* :class:`Guard`, the check that the tensors a graph captured are still
  the ones the model holds;
* :func:`clone` and :func:`stack` of the outputs.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import torch

from buffer_tpu_torch.kernels import cuda


def signature(tensors: Iterable[Optional[torch.Tensor]]) -> tuple:
    """Shapes and dtypes of ``tensors`` (None for an absent one): the key of
    a captured program, as jit's cache keys on shapes and dtypes."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in tensors)


def cache(build: Callable, key_of: Callable):
    """``fn(*args)``: one program ``build(*args)`` for each ``key_of(*args)``.
    The first call of a key builds the program and returns its ``first``
    (the result of the build's eager run); every later call returns
    ``program(*args)``.  ``fn.programs``: key -> program."""
    programs = {}

    def fn(*args):
        key = key_of(*args)
        program = programs.get(key)
        if program is None:
            programs[key] = program = build(*args)
            return program.first
        return program(*args)

    fn.programs = programs
    return fn


def map_nest(f: Callable, x):
    """``f`` of every tensor in a nest of tuples, named tuples and dicts;
    other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return f(x)
    if isinstance(x, dict):
        return {k: map_nest(f, v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [map_nest(f, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def clone(x):
    """A copy of every tensor in a nest (:func:`map_nest`)."""
    return map_nest(torch.Tensor.clone, x)


def stack(xs: list):
    """The nests ``xs`` (equal structure) with every tensor stacked along a
    new leading axis; other leaves are taken from the first."""
    x = xs[0]
    if isinstance(x, torch.Tensor):
        return torch.stack(xs)
    if isinstance(x, dict):
        return {k: stack([y[k] for y in xs]) for k in x}
    if isinstance(x, tuple):
        items = [stack(list(ys)) for ys in zip(*xs)]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def empty_like(x, dev: torch.device):
    """An uninitialized tensor on ``dev`` of each tensor's shape and dtype in
    a nest: a program's static inputs."""
    return map_nest(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                    x)


def load(static: Sequence[Optional[torch.Tensor]],
         tensors: Sequence[Optional[torch.Tensor]]) -> None:
    """Copies ``tensors`` into the static inputs ``static`` (None where a
    field is absent)."""
    for dst, src in zip(static, tensors):
        if dst is not None:
            dst.copy_(src)


def warm(run: Callable, dev: torch.device,
         stream: Optional[torch.cuda.Stream] = None):
    """``run()`` eagerly on ``stream`` (default: a new one), forked from
    ``dev``'s current stream and joined back to it, so that first-use
    allocations, handles and attributes happen here and not while
    capturing; returns its result.  Off the card, ``run()``."""
    if dev.type != "cuda":
        return run()
    caller = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev) if stream is None else stream
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        out = run()
    caller.wait_stream(side)
    return out


def capture_graph(run: Callable, pool, stream=None):
    """Captures ``run()`` as a CUDA graph in memory pool ``pool`` on
    ``stream`` (default: PyTorch's capture stream); returns
    (the graph, ``run``'s outputs, the kernels' launch counts of one
    replay).  The counts are recorded at capture and taken back, since a
    capture launches nothing; a caller adds them on each replay
    (``cuda.add_launches``)."""
    graph = torch.cuda.CUDAGraph()
    before = cuda.launch_counts()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = run()
    finally:
        after = cuda.launch_counts()
        launches = {k: n - before[k] for k, n in after.items()
                    if n != before[k]}
        cuda.add_launches({k: -n for k, n in launches.items()})
    return graph, out, launches


class Guard:
    """The addresses of ``held()``, the tensors a program's graphs read or
    write in place, when it was captured; :meth:`check` raises
    ``RuntimeError(message)`` once one of them is another tensor (loading
    in place, e.g. ``load_state_dict``, keeps them)."""

    def __init__(self, held: Callable[[], Iterable[torch.Tensor]],
                 message: str):
        self.held, self.message = held, message
        self.ptrs = self._ptrs()

    def _ptrs(self) -> tuple:
        return tuple(t.data_ptr() for t in self.held())

    def check(self) -> None:
        if self._ptrs() != self.ptrs:
            raise RuntimeError(self.message)
