"""Every cell of BENCHMARK.json resolves to its configuration, traffic,
driver, limits and metric readers, and the file keeps to the contract's
shapes."""

import json
import os
import re

import pytest

from benchmark.harness import common
from benchmark.harness.weights import leaf_specs, load_config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = common.read_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    r = common.resolve(ROOT, cell)
    assert os.path.exists(r["driver"])
    assert os.path.exists(os.path.join(ROOT, "benchmark", "limits",
                                       cell + ".json"))
    assert r["cell"]["chips"] == 1
    assert r["traffic"]["driver"] in ("train", "eval")
    reported = [m["name"] for m in common.end_to_end(BENCH, cell)]
    assert "setup_s" in reported and len(reported) >= 2
    layer = common.per_layer(BENCH, cell)
    assert layer
    for m in layer:
        assert m["moves"] in reported
        path = os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py")
        assert "def read(ctx)" in open(path).read()


def test_names_units_and_sources():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_and_reduced_keys(conf):
    cfg = load_config(os.path.join(ROOT, conf["file"]))
    assert cfg["name"] == conf["name"]
    assert conf["file"].startswith("benchmark/configs/")
    raw = cfg["raw"]
    for key in conf["reduced"]:
        assert key in raw["changed_from_source"]
        assert not key.endswith(("_dim", "_rank"))
        assert key not in ("hidden_size", "intermediate_size",
                           "num_attention_heads", "width", "output_dim")
    # the published widths, uncut
    assert (raw["hidden_size"], raw["intermediate_size"],
            raw["num_attention_heads"], raw["num_hidden_layers"]) == (
        1024, 4096, 16, 24)
    assert leaf_specs(cfg)
