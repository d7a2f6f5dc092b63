"""``BENCHMARK.json`` keeps to the benchmark's contract: names, units,
keys, and a file for every configuration, traffic mix and metric."""

import json
import re

import pytest

from zbench.harness import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _names():
    for sect in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[sect]:
            yield sect, e["name"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["zbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


@pytest.mark.parametrize("sect,name", list(_names()))
def test_names_use_allowed_characters(sect, name):
    assert NAME.match(name), name


def test_names_are_unique():
    for sect in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[sect]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_metrics_keys_units_and_files():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (HERE / "end_to_end" / f"{m['name']}.py").exists()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for c in m.get("workloads", cells):
            assert c in cells and c in e2e[m["moves"]], (m["name"], c)
    for c in cells:
        got = [n for n, ws in e2e.items() if c in ws]
        assert "setup_s" in got and len(got) >= 2
        assert any(c in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_cells_configs_and_traffic():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("zbench/") and (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["source"] for c in configs.values()}) == len(configs)
