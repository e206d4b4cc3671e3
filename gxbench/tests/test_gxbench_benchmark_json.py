"""BENCHMARK.json against the benchmark's contract, and every name in it
against a file of this folder."""

import json
import os
import re

import pytest

from gxbench import generate, harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gxbench"] and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gxbench/") and os.path.exists(
            os.path.join(harness.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        generate.load_mix(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] == "gcups"


def test_names_and_readers():
    items = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in items]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(harness.load_metric(m["name"]))


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(w):
    spec = harness.cell(w)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and "gcups" in e2e and spec["per_layer"]


# Mix parameters that set a call's lengths.
LENGTHS = {"pairs", "x_len", "y_extra", "queries", "hits", "len_median",
           "len_sigma", "len_clip", "regions", "reads", "haps", "read_len",
           "hap_len"}


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_no_cell_runs_assumed_lengths(w):
    """A mix names its unsourced parameters under ``assumed``; a cell runs
    no mix whose sizes are among them."""
    assert not LENGTHS & set(harness.cell(w)["mix"].get("assumed", {}))


def test_layers_listed_in_perf_md():
    perf = open(os.path.join(harness.ROOT, "PERF.md")).read()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]
