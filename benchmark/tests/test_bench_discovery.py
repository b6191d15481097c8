"""A cell, a configuration, a driver and a metric added as new files are
found by name, with no edit to the harness; BENCHMARK.json keeps to the
benchmark's contract."""
import json
import re
from pathlib import Path

from benchmark import run as bench_run
from benchmark.harness import common

DRIVER = '''
def run(ctx):
    return {"setup_s": 1.5, "window_s": 2.0, "frames": 10,
            "attempted": 10, "failed": 0,
            "device": ctx.read_device(None),
            "numbers": {"err": ctx.cfg["width"] * 0.1}}
'''
METRIC = '''
def read(run):
    return run["frames"] / run["window_s"]
'''


def test_new_files_are_found_by_name(tmp_path: Path):
    for d in ("workloads", "configs", "drivers", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "width": 3}))
    (tmp_path / "workloads" / "toy.steady.json").write_text(json.dumps(
        {"name": "toy.steady", "config": "toy", "driver": "toydrv",
         "traffic": "steady", "chips": 1, "why": "a test cell",
         "limits": {"err": 0.5}}))
    (tmp_path / "drivers" / "toydrv.py").write_text(DRIVER)
    (tmp_path / "metrics" / "toy_rate.py").write_text(METRIC)
    spec = {"end_to_end": [
        {"name": "toy_rate", "unit": "frames/s", "workloads": ["toy.steady"]},
        {"name": "other", "unit": "s", "workloads": ["elsewhere"]}],
        "per_layer": []}
    res = bench_run.execute("toy.steady", 7, 2.0, False, device="cpu",
                            roots=(tmp_path,), spec=spec, t_start=0.0)
    assert res["metrics"] == {"toy_rate": {"value": 5.0,
                                           "unit": "frames/s"}}
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert abs(res["checks"]["err"]["value"] - 0.3) < 1e-12


def test_metrics_without_workloads_reach_every_cell():
    spec = {"end_to_end": [{"name": "setup_s"},
                           {"name": "x", "workloads": ["a"]}],
            "per_layer": [{"name": "y", "workloads": ["b"]}]}
    assert [m["name"] for m in common.metrics_for(spec, "a", False)] == \
        ["setup_s", "x"]
    assert [m["name"] for m in common.metrics_for(spec, "b", True)] == ["y"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    spec = common.benchmark_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        cfg = json.loads((common.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
    cfg_names = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfg_names and len(w["why"]) <= 200
        cell = common.load_json("workloads", w["name"])
        assert {k: cell[k] for k in w} == w
        names.add(w["name"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= names
        assert common.find("metrics", m["name"], ".py")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", names)
        assert set(m["workloads"]) <= set(moved)
    for w in names:
        reported = [m for m in spec["end_to_end"]
                    if w in m.get("workloads", names)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in spec["per_layer"])
