"""BENCHMARK.json against the shape it must keep (names, units, one-line
texts, each cell's metrics), and every piece it names found by name."""

import json
import re

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness.configs import port_config
from benchmark.reference.buffer import settings

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = mf.load_manifest()


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) < 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["benchmark"]


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_lines(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]


def test_every_per_layer_metric_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in cells
            assert any(x["name"] == m["moves"]
                       for x in mf.cell_metrics(MAN, c, "end_to_end"))


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in mf.cell_metrics(MAN, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mf.cell_metrics(MAN, w["name"], "per_layer")
        assert w["chips"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    MAN["end_to_end"] + MAN["per_layer"]])
def test_a_reader_is_found_by_name(metric):
    assert callable(mf.load_reader(metric))


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_pieces_load(cell):
    w = mf.workload(MAN, cell)
    conf = mf.load_config(MAN, w["config"])
    mix = mf.load_traffic(w["traffic"])
    assert conf["name"] == w["config"] and conf["reduced"] == []
    assert hasattr(mf.load_module("loops", mix["loop"]), "Loop")
    assert callable(mf.load_module("scenes", mix["scene"]).make)
    cfg = port_config(conf)
    assert cfg.static.points_l0 == conf["model"]["static"]["points_l0"]
    assert settings(conf).static.points_l0 == cfg.static.points_l0


def test_a_new_piece_is_a_new_file(tmp_path):
    """A scene, loop or metric is found by its file's name alone."""
    for kind in ("scenes", "loops", "metrics"):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / "new.piece-1.py").write_text("VALUE = 7\n")
        assert mf.load_module(kind, "new.piece-1", tmp_path).VALUE == 7
    with pytest.raises(KeyError):
        mf.load_module("scenes", "no_such_scene", tmp_path)


def test_a_config_that_the_preset_does_not_hold_is_refused():
    conf = mf.load_config(MAN, "3dmatch")
    conf["model"]["static"]["no_such_field"] = 1
    with pytest.raises(KeyError):
        port_config(conf)


def test_kernel_classes_name_known_rooflines():
    classes = mf.load_kernel_classes()
    names = {c["name"] for c in classes["classes"]}
    for group in classes["rooflines"].values():
        assert set(group) <= names
