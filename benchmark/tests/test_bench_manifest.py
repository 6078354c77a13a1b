"""BENCHMARK.json against the benchmark's contract, and discovery by name."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.lib import manifest as mf

BENCH = mf.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for p in BENCH["paths"]:
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(mf.ROOT, p))


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units_use_the_allowed_characters(entry):
    assert mf.NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert mf.NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert mf.NAME.match(key)
    if "unit" in entry:
        assert mf.UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer"):
        if key in entry:
            assert _line(entry[key])
    if entry in BENCH["configs"]:
        assert _line(entry["source"])


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_every_cell_reports_setup_a_rate_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if cell in m.get("workloads", [cell])]
        layers = [m for m in BENCH["per_layer"]
                  if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        for m in layers:
            assert m["moves"] in e2e


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_configs_are_used_and_their_files_lie_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        body = mf.load_json(os.path.join(mf.ROOT, c["file"]))
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_finds_its_files_by_name(name):
    cell = mf.Cell(name, BENCH)
    assert hasattr(cell.driver(), "Driver")
    assert cell.spec["rate_metric"] in [m["name"] for m in cell.end_to_end]
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    from benchmark.lib.spans import Spans

    class Empty:
        range_device_us = {}

        def busy_us(self):
            return 0.0

        def kernel_us(self, match):
            return 0.0

    import torch

    ctx = {"trace": Empty(), "spans": Spans([], torch.device("cpu")),
           "window_s": 1.0, "steps": 0, "work": 0, "peaks": None,
           "layer": {}}
    assert mf.load_module("metrics", metric).read(ctx) is None


def test_an_unknown_name_is_refused():
    with pytest.raises(KeyError):
        mf.Cell("no-such-cell", BENCH)
    with pytest.raises(ValueError):
        mf.named_file("configs", "../BENCHMARK")
