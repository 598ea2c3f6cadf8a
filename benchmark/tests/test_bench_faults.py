"""Whole runs of the harness on the CPU at the miniature plan, judged by
the configuration's own limits (the look for a card skipped): a sound run
is correct, and a run with the timed path broken underneath is not, for
each fault a cell of this benchmark can have: an answer altered where it
is produced, half of a group's pairs left out (their slots given another
pair's answer), a call that returns its previous answer (state left
unchanged), and host prep altered.  There is one chip, so no exchange
between chips to leave out.  The same faults at the cells' own sizes on
the card are read by ``python3 -m benchmark.calibrate``."""

import pytest
import torch

from benchmark import run as R

from conftest import small

SEED = 2 ** 33 + 5
CELLS = ["3dmatch.testset", "kitti.testset"]


def run(cell, **kw):
    man, c, conf, mix = small(cell, **kw)
    return R.run_cell(man, c, SEED, 0.05, False, "cpu", conf=conf, mix=mix)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


def _wrap(monkeypatch, make):
    from buffer_tpu_torch.pipeline import registration
    orig = registration.make_unrolled_register_fn
    monkeypatch.setattr(registration, "make_unrolled_register_fn",
                        lambda *a, **k: make(orig(*a, **k)))


@pytest.mark.parametrize("cell,field,number", [
    ("3dmatch.testset", "kpts", "kpt_miss"),
    ("kitti.testset", "kpts", "kpt_miss"),
    ("3dmatch.testset", "pose", "pose_same")])
def test_altered_answer_is_caught(monkeypatch, cell, field, number):
    def make(fn):
        def f(*a):
            res = fn(*a)
            return res._replace(**{field: getattr(res, field) + 0.1})
        return f
    _wrap(monkeypatch, make)
    res = run(cell)
    assert not res["correct"] and res["checks"][number]["value"] > 0


def test_half_the_group_left_out_is_caught(monkeypatch):
    def make(fn):
        def f(*a):
            res = fn(*a)
            return type(res)(*(torch.stack([t[0]] * t.shape[0]) for t in res))
        return f
    _wrap(monkeypatch, make)
    res = run("3dmatch.testset")
    assert not res["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_stale_answer_is_caught(monkeypatch, cell):
    def make(fn):
        last = []

        def f(*a):
            res = fn(*a)
            out = last[0] if last else res
            last[:] = [res]
            return out
        return f
    _wrap(monkeypatch, make)
    res = run(cell)
    assert not res["correct"]


def test_altered_host_prep_is_caught(monkeypatch):
    from buffer_tpu_torch.data import preprocess
    orig = preprocess.prepare_pair

    def bad(*a, **k):
        out = orig(*a, **k)
        return out._replace(sds=out.sds * 1.0001)
    monkeypatch.setattr(preprocess, "prepare_pair", bad)
    res = run("3dmatch.testset")
    assert not res["correct"] and res["checks"]["prep_err"]["value"] > 0
