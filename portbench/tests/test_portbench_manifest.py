"""``BENCHMARK.json`` against the benchmark contract's shape, and every
file it names found by name."""

import json
import os
import re

import pytest

from portbench import core
from portbench import run as R

ROOT = os.path.dirname(core.BENCH)
MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_units(section):
    for e in MANIFEST[section]:
        extra = {"workloads"} if section in ("end_to_end",
                                             "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_names_are_unique_and_cross_references_resolve():
    for section in KEYS:
        names = [e["name"] for e in MANIFEST[section]]
        assert len(names) == len(set(names)), section
    configs = {c["name"] for c in MANIFEST["configs"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    assert {w["config"] for w in MANIFEST["workloads"]} == configs
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1
        reported = R.cell_metrics(MANIFEST, w["name"], "end_to_end")
        assert len(reported) >= 2
        assert R.cell_metrics(MANIFEST, w["name"], "per_layer")


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    files = R.cell_files(cell)
    assert files["config"]["name"] == files["cell"]["config"]
    core.load_module("generators", files["mix"]["generator"])
    core.load_module("entries", files["mix"]["entry"])
    for kind in ("end_to_end", "per_layer"):
        for m in R.cell_metrics(MANIFEST, cell, kind):
            mod = (core.load_module("e2e", m["name"])
                   if kind == "end_to_end" else R.metric_reader(m["name"]))
            assert callable(mod.read)
    from portbench.reference.compare import NUMBERS
    assert files["limits"]["numbers"]
    assert set(files["limits"]["numbers"]) <= set(NUMBERS)


def test_config_files_match_the_manifest():
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("portbench/configs/")
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
        assert os.path.isdir(os.path.join(ROOT, body["artifacts"]))
