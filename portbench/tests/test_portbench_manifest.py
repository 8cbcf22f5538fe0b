"""BENCHMARK.json keeps the contract's shapes, and every file a cell or a
metric names is found by name."""

import importlib
import json
import re

import pytest

from portbench import train_compare
from portbench.harness import HERE, ROOT, load_json

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")
#: the numbers each driver's check gives, which a cell's limits may name
KNOWN = {"bulk": {"err_typical", "err_worst"},
         "stream": {"err_typical", "err_worst"},
         "gan_train": set(train_compare.NAMES)}


def _entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[key]:
            yield key, e


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in MAN["paths"])
    assert len(MAN["command"]) <= 32
    assert all(not w.startswith("/") and 1 <= len(w) <= 200
               for w in MAN["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("key,entry", list(_entries()),
                         ids=lambda x: x if isinstance(x, str)
                         else x["name"])
def test_names_units_and_text(key, entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for k in TEXT_KEYS:
        if k in entry:
            assert 1 <= len(entry[k]) <= 200
            assert "\n" not in entry[k] and "\t" not in entry[k]
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[key]
    assert set(entry) <= allowed


def test_bounds_and_coverage():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [c["name"] for c in MAN["workloads"]]
    assert len(set(cells)) == len(cells)
    for c in cells:
        e2e_here = [m["name"] for m in e2e.values()
                    if "workloads" not in m or c in m["workloads"]]
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
        layers = [m for m in MAN["per_layer"] if c in m["workloads"]]
        assert layers and all(m["moves"] in e2e_here for m in layers)
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    cfg = next(c for c in MAN["configs"] if c["name"] == cell["config"])
    assert cfg["file"] == f"portbench/configs/{cell['config']}.json"
    conf = load_json("configs", cell["config"])
    assert conf["reduced"] == cfg["reduced"]
    mix = load_json("traffic", cell["traffic"])
    importlib.import_module(f"portbench.drivers.{mix['driver']}")
    limits = load_json("limits", cell["name"])
    numbers = set(limits) - {"min_compared"}
    assert "min_compared" in limits and numbers
    assert numbers <= KNOWN[mix["driver"]]
    assert cell["chips"] == 1
    for m in MAN["per_layer"]:
        if cell["name"] in m["workloads"]:
            assert (HERE / "layer_metrics" / f"{m['name']}.py").exists()


def test_readers_return_nothing_on_an_empty_record():
    from portbench.run import layer_reader

    for m in MAN["per_layer"]:
        assert layer_reader(m["name"])({}) is None
