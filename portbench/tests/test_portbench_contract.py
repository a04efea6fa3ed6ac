"""BENCHMARK.json against the benchmark's contract, and the files it names:
names and units of the allowed characters, the keys of each entry, every
per-layer metric's reader, and each metric's ``moves`` reported where the
metric is."""

import json
import os
import re

import pytest

from conftest import ROOT
from portbench import cell as cells

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys():
    assert set(BENCH) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[part]:
            extra = {"workloads"} if part in ("end_to_end",
                                              "per_layer") else set()
            assert KEYS[part] <= set(entry) <= KEYS[part] | extra, entry


def names():
    out = []
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [e["name"] for e in BENCH[part]]
    out += [w["config"] for w in BENCH["workloads"]]
    out += [w["traffic"] for w in BENCH["workloads"]]
    out += [k for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("name", names())
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 0 < len(metric["layer"]) <= 200 and "\n" not in \
            metric["layer"]


def test_unique_and_bounded():
    for part in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[part]}) == len(BENCH[part])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_paths_hold_the_files():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        arch = json.load(open(os.path.join(ROOT, c["file"])))
        assert arch["name"] == c["name"] and arch["reduced"] == c["reduced"]
        assert arch["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(
            ROOT, "portbench", "limits", f"{w['name']}.json"))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_enough(w):
    cell = cells.load(w["name"])
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_reader_declares_the_entry(metric):
    mod = cells.reader(metric["name"])
    assert mod.NAME == metric["name"]
    assert mod.LAYER == metric["layer"]
    assert mod.UNIT == metric["unit"]
    assert mod.SOURCE == metric["source"]
    assert mod.MOVES == metric["moves"]
    assert mod.read({}) is None      # nothing to read: no number

