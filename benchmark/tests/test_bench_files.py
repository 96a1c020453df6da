"""Every file the harness finds by name loads, and BENCHMARK.json names
only files that are there."""

import json
import os

import pytest

from benchmark import core

BENCH = core.HERE
SPEC = json.load(open(core.ROOT / "BENCHMARK.json"))


@pytest.mark.parametrize("path", sorted((BENCH / "workloads").glob("*.json")),
                         ids=lambda p: p.name)
def test_traffic_file_loads(path):
    mix = core.load_json(path)
    for key in ("repeat", "chunk", "trace_repeats", "per_cadence"):
        assert key in mix, f"{path.name} lacks {key}"


@pytest.mark.parametrize("path", sorted((BENCH / "metrics").glob("*.py")),
                         ids=lambda p: p.name)
def test_metric_reader_loads(path):
    read = core.reader(path.stem)
    assert callable(read)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(cell):
    sp = core.spec(cell)
    assert sp.config["name"] == sp.cell["config"]
    assert set(sp.limits) == set(core.check.NAMES)
    names = {m["name"] for m in sp.end_to_end}
    assert {"pushes_per_s", "setup_s", "peak_mem_mib"} <= names
    for m in sp.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in names
    ref = core.reference(sp.config)
    assert ref.geom(sp.config["params"]).nx == sp.config["params"]["nx"]


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cut(entry):
    cfg = core.load_json(core.ROOT / entry["file"])
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    changed = sorted(k for k, v in cfg["published"].items()
                     if cfg["params"][k] != v)
    assert changed == sorted(entry["reduced"])


def test_paths_hold_the_benchmark_only():
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    for words in SPEC["command"]:
        assert not words.startswith("/") and ".." not in words
    assert os.path.getsize(core.ROOT / "BENCHMARK.json") < 64 * 1024


def test_readers_leave_out_what_they_cannot_read():
    run = core.Run()
    for m in SPEC["per_layer"]:
        if m["source"] == "device_trace":
            assert core.reader(m["name"])(run) is None, m["name"]
