"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name and valid."""
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "perfbench/run.py"]
    assert len(SPEC["command"]) <= 32 and all(TEXT.match(w) for w in SPEC["command"])
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_texts():
    names = [m["name"] for m in METRICS]
    for group in (names, [w["name"] for w in SPEC["workloads"]],
                  [c["name"] for c in SPEC["configs"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group), group
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert TEXT.match(w["why"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"qps", "p95_ms", "recall_at_10", "peak_gib", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def _e2e_of(cell):
    return {m["name"] for m in SPEC["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = _e2e_of(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in SPEC["per_layer"] if w["name"] in m["workloads"]]
        assert layer, w["name"]
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert TEXT.match(m["layer"])
        for cell in m["workloads"]:
            assert m["moves"] in _e2e_of(cell), (m["name"], cell)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_found_and_valid(entry):
    path = ROOT / entry["file"]
    assert path.is_relative_to(HERE) and path.is_file()
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    data = cfg["data"]
    for key in ("n", "dim", "metric", "n_queries", "n_train", "gt_k",
                "spectrum_decay", "n_clusters", "cluster_spread", "query_noise"):
        assert key in data
    assert {"missing", "malformed", "recall_at_10"} < set(cfg["limits"]) <= {
        "missing", "malformed", "gap_max", "gap_mean", "recall_at_10"}
    assert cfg["limits"]["missing"] == 0 and cfg["limits"]["malformed"] == 0
    assert 0 < cfg["limits"]["recall_at_10"] < 1
    files = [w for w in SPEC["configs"] if w["file"] == entry["file"]]
    assert len(files) == 1


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_traffic_file_found_and_valid(cell):
    path = HERE / "traffic" / f"{cell['traffic']}.json"
    t = json.loads(path.read_text())
    assert t["loop"] in ("closed", "open")
    assert {"ef", "k", "storage"} <= set(t["params"])
    if t["loop"] == "open":
        assert t["arrivals"] in ("poisson", "burst")
        assert t["rate_per_s"] > 0 and t["latency_limit_ms"] > 0
    assert cell["config"] in {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    from perfbench import harness

    assert callable(harness.reader(metric).read)


def test_load_cell_finds_every_file():
    from perfbench import harness

    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} == _e2e_of(w["name"])


def test_run_seconds_fit_a_full_check():
    n_cells = 24
    runs = 2 + 14 * n_cells
    need = runs * (SPEC["run_seconds"] + 60) + n_cells * 2 * 90 + 1200
    assert need <= 43200


def test_every_traffic_file_is_used():
    used = {w["traffic"] for w in SPEC["workloads"]}
    assert {p.stem for p in (HERE / "traffic").glob("*.json")} == used


def test_graph_key_ignores_the_seed_and_follows_the_configuration():
    from perfbench import harness

    keys = set()
    for entry in SPEC["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        key = harness.graph_key(cfg)
        assert key == harness.graph_key(json.loads(json.dumps(cfg)))
        assert NAME.match(key) and entry["name"] in key
        small = dict(cfg, data=dict(cfg["data"], n=2000))
        assert harness.graph_key(small) != key
        keys.add(key)
    assert len(keys) == len(SPEC["configs"])
