"""The pieces of a compiled program (``buffer_tpu_torch/core/graphs.py``) on
the CPU: the signature-keyed cache driven by a stand-in program, the guard
on the captured tensors, the static inputs and their load, the eager
warm-up off the card and the nest helpers.  The capture itself needs the
card: ``tests/test_torch_cuda.py`` holds the programs built from these."""

from typing import NamedTuple, Optional

import pytest
import torch

from buffer_tpu_torch.core import graphs


class Pair(NamedTuple):
    a: torch.Tensor
    b: Optional[torch.Tensor] = None


class Program:
    """A stand-in program: ``first`` names its build, a call returns the
    build and the call's argument."""

    built = []

    def __init__(self, x):
        self.n = len(Program.built)
        Program.built.append(x)
        self.first = ("first", self.n)

    def __call__(self, x):
        return ("replay", self.n, x)


def test_cache_builds_once_a_signature():
    """The first call of a signature builds its program and returns the
    build's ``first``; a call of another signature builds a second; a
    later call of a signature replays its program; ``fn.programs`` holds
    one program a signature."""
    Program.built = []
    fn = graphs.cache(Program, lambda x: graphs.signature([x]))
    x3, x4 = torch.zeros(3), torch.zeros(4)
    assert fn(x3) == ("first", 0)
    assert fn(x4) == ("first", 1)
    assert fn(x3)[:2] == ("replay", 0) and fn(x3)[2] is x3
    assert fn(torch.ones(4))[:2] == ("replay", 1)
    assert fn(x3.double()) == ("first", 2)
    assert len(Program.built) == 3
    assert list(fn.programs) == [((((3,), torch.float32),)),
                                 ((((4,), torch.float32),)),
                                 ((((3,), torch.float64),))]
    assert [p.n for p in fn.programs.values()] == [0, 1, 2]


def test_cache_key_may_refuse_a_call():
    """A key that raises builds nothing and leaves the cache as it was."""
    def key(x):
        if x.dim() != 1:
            raise ValueError("one axis")
        return graphs.signature([x])

    fn = graphs.cache(Program, key)
    with pytest.raises(ValueError, match="one axis"):
        fn(torch.zeros(2, 2))
    assert fn.programs == {}


def test_signature_keys_shapes_dtypes_and_absent_fields():
    t = torch.zeros(2, 3)
    assert graphs.signature(Pair(t)) == (((2, 3), torch.float32), None)
    assert graphs.signature(Pair(t, t)) != graphs.signature(Pair(t))
    assert graphs.signature([t]) == graphs.signature([torch.ones(2, 3)])
    assert graphs.signature([t]) != graphs.signature([t.int()])


def test_guard_holds_in_place_loads_and_raises_on_a_new_tensor():
    """Loading in place keeps the guard quiet; a replaced tensor makes it
    raise its message until the captured tensor is back."""
    model = torch.nn.Linear(2, 2)
    guard = graphs.Guard(lambda: [*model.parameters(), *model.buffers()],
                         "stale tensors")
    model.load_state_dict(torch.nn.Linear(2, 2).state_dict())
    guard.check()
    weight = model.weight
    model.weight = torch.nn.Parameter(weight.detach().clone())
    with pytest.raises(RuntimeError, match="^stale tensors$"):
        guard.check()
    model.weight = weight
    guard.check()


def test_static_inputs_and_their_load():
    """``empty_like`` makes a tensor of each shape and dtype (None stays);
    ``load`` copies a call's tensors into them, skipping absent fields."""
    src = Pair(torch.arange(6.0).reshape(2, 3))
    static = graphs.empty_like(src, torch.device("cpu"))
    assert isinstance(static, Pair) and static.b is None
    assert static.a.shape == (2, 3) and static.a.data_ptr() != src.a.data_ptr()
    ptr = static.a.data_ptr()
    graphs.load(static, src)
    assert torch.equal(static.a, src.a) and static.a.data_ptr() == ptr


def test_warm_off_the_card_runs_in_place():
    calls = []
    out = graphs.warm(lambda: calls.append(1) or "done", torch.device("cpu"))
    assert out == "done" and calls == [1]


def test_stack_and_drop_the_leading_axis():
    """``stack`` stacks every tensor of equal nests along a new axis (other
    leaves from the first); ``map_nest`` of ``t[u]`` takes nest ``u`` back."""
    xs = [{"p": Pair(torch.full((2,), float(u)), None), "n": 3, "t": (
        torch.tensor(u), "s")} for u in range(3)]
    st = graphs.stack(xs)
    assert st["p"].a.shape == (3, 2) and st["p"].b is None
    assert st["n"] == 3 and st["t"][1] == "s"
    for u, x in enumerate(xs):
        back = graphs.map_nest(lambda t: t[u], st)
        assert torch.equal(back["p"].a, x["p"].a)
        assert torch.equal(back["t"][0], x["t"][0])
