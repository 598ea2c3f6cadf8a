"""The port's training entry points on the CPU.

``buffer_tpu_torch.scripts.train``: its ``data_iter`` against the
repository's ``scripts/train.py`` ``data_iter`` (loaded from its file) on
one item list made from a numpy seed, every array equal; ``main`` over
``tests/fixtures_gen.py``'s 3DMatch and KITTI trees at the tiny plan
(checkpoints per stage, the metric lines, ``--resume`` merging the other
stages).  ``buffer_tpu_torch.scripts.train_then_register.main`` at 2 train
pairs, 1 epoch, 1 held-out pair with ``small_cfg`` swapped for
``tiny_cfg``.  Both refuse to start without a card unless given
``--device cpu``."""

import importlib.util
import json
import math
import os
import pathlib

import numpy as np
import pytest
import torch

import buffer_tpu.config as jconfig

import fixtures_gen

import buffer_tpu_torch.config as tconfig
from buffer_tpu_torch.models.composite import BufferModel
from buffer_tpu_torch.scripts import train as entry
from buffer_tpu_torch.scripts import train_then_register as ttr
from buffer_tpu_torch.train import checkpoint

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_trees")
    tdm, kitti = str(base / "ThreeDMatch"), str(base / "KITTI")
    os.makedirs(tdm)
    os.makedirs(kitti)
    fixtures_gen.make_threedmatch_tree(tdm)
    fixtures_gen.make_kitti_tree(kitti)
    return {"3DMatch": tdm, "KITTI": kitti}


def _items():
    rs = np.random.RandomState(8)
    items = []
    for _ in range(3):
        src = rs.uniform(-0.5, 0.5, (700, 3)).astype(np.float32)
        src[:, 2] = 0.2 * np.sin(5 * src[:, 0]) + 1.0
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rs.uniform(-0.1, 0.1, 3)
        items.append({"src_fds_pts": src, "tgt_fds_pts": src + pose[:3, 3],
                      "relt_pose": pose})
    return items


def test_data_iter_matches_reference_script():
    spec = importlib.util.spec_from_file_location(
        "reference_train_script", REPO / "scripts" / "train.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    # prepare_pair shuffles the items' arrays in place: each side gets its own
    want = list(script.data_iter(jconfig.tiny_cfg(), _items(), 124))
    got = list(entry.data_iter(tconfig.tiny_cfg(), _items(), 124, "cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for name, a, b in zip(g.inputs._fields, g.inputs, w.inputs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(g.relt_pose.numpy(),
                                      np.asarray(w.relt_pose))


def _metric_lines(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def ref_desc_run(trees, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("snap3dm"))
    entry.main(["--config", "3DMatch", "--tiny", "--device", "cpu",
                "--data-root", trees["3DMatch"], "--out", out,
                "--stages", "Ref", "Desc", "--epochs", "1", "--max-iter", "2"])
    return out


def test_train_entry_3dmatch(ref_desc_run):
    for stage in ("Ref", "Desc"):
        assert os.path.exists(os.path.join(ref_desc_run, stage, "best.pth"))
    lines = _metric_lines(ref_desc_run)
    assert any(l["split"] == "val" and l["stage"] == "Ref"
               and math.isfinite(l["ref_loss"]) for l in lines)
    assert any(l["split"] == "val" and l["stage"] == "Desc" for l in lines)


def test_train_entry_kitti(trees, tmp_path):
    out = str(tmp_path / "snapk")
    entry.main(["--config", "KITTI", "--tiny", "--device", "cpu",
                "--data-root", trees["KITTI"], "--out", out,
                "--stages", "Ref", "--epochs", "1", "--max-iter", "1"])
    assert os.path.exists(os.path.join(out, "Ref", "best.pth"))
    assert any(l["split"] == "val" and l["stage"] == "Ref"
               for l in _metric_lines(out))


def test_train_entry_resume_merges_other_stages(trees, ref_desc_run, tmp_path):
    """A Keypt run with ``--resume`` takes Ref and Desc from the resumed
    snapshot's best files, and trains Keypt alone."""
    out = str(tmp_path / "snap_resume")
    entry.main(["--config", "3DMatch", "--tiny", "--device", "cpu",
                "--data-root", trees["3DMatch"], "--out", out,
                "--resume", ref_desc_run, "--stages", "Keypt",
                "--epochs", "1", "--max-iter", "1"])
    got = checkpoint.load(os.path.join(out, "Keypt", "best.pth"))
    fresh = BufferModel(tconfig.shrink_static(tconfig.threedmatch_cfg()),
                        seed=tconfig.threedmatch_cfg().data.manual_seed
                        ).state_dict()
    for stage in ("Ref", "Desc"):
        want = checkpoint.load(os.path.join(ref_desc_run, stage, "best.pth"))
        keys = [k for k in want if k.startswith(stage + ".")]
        assert all(torch.equal(got[k], want[k]) for k in keys)
        assert any(not torch.equal(got[k], fresh[k]) for k in keys
                   if got[k].is_floating_point())
    assert all(torch.equal(got[k], fresh[k]) for k in got
               if k.startswith("Inlier."))
    assert any(not torch.equal(got[k], fresh[k]) for k in got
               if k.startswith("Keypt.") and got[k].is_floating_point())


def test_train_then_register_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(tconfig, "small_cfg", tconfig.tiny_cfg)
    rec_path = tmp_path / "rec.json"
    rc = ttr.main(["--train-pairs", "2", "--epochs", "1", "--eval-pairs", "1",
                   "--device", "cpu", "--out", str(tmp_path / "ttr"),
                   "--json", str(rec_path)])
    assert rc == 0
    rec = json.loads(rec_path.read_text())
    assert rec["metric"] == "trained_from_scratch_recall"
    assert (rec["pairs"], rec["train_pairs"], rec["epochs"]) == (1, 2, 1)
    assert 0.0 <= rec["value"] <= 1.0
    assert set(rec["diagnosis"]) == {"mutual", "correct_match_rate",
                                     "axis_cos", "vote_inliers"}
    assert all(math.isfinite(v) for v in rec["diagnosis"].values())
    for stage in ("Ref", "Desc", "Keypt", "Inlier"):
        assert (tmp_path / "ttr" / "snap" / stage / "best.pth").exists()


@pytest.mark.parametrize("run", [
    lambda out: entry.main(["--out", out]),
    lambda out: ttr.main(["--out", out, "--train-pairs", "1"])],
    ids=["train", "train_then_register"])
def test_entry_points_default_to_the_card(run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(str(tmp_path))
