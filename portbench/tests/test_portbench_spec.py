"""BENCHMARK.json against the benchmark contract's shapes, and every file
it names found by name."""

import json
import re

import pytest

from portbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    assert len(CELLS) == len(set(CELLS))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert callable(c.load.run) and callable(c.check.numbers)
    assert c.check.__name__ == "portbench_checks_" + c.traffic["policy"]["mode"]
    assert c.load.__name__ == "portbench_loads_" + c.traffic["load"]
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_a_missing_module_is_named():
    with pytest.raises(FileNotFoundError, match="loads/no_such_load.py"):
        spec.module("loads", "no_such_load")
    with pytest.raises(FileNotFoundError, match="checks/fixed_nothing.py"):
        spec.module("checks", "fixed_nothing")


def test_every_policy_mode_builds_from_its_spec():
    from portbench.harness import make_policy

    for p in (spec.HERE / "workloads").glob("*.json"):
        traffic = json.loads(p.read_text())
        pol = make_policy(traffic)
        assert pol.spec()["mode"] == traffic["policy"]["mode"]
        assert (spec.HERE / "checks" / f"{pol.mode}.py").is_file()
        assert (spec.HERE / "loads" / f"{traffic['load']}.py").is_file()


def test_config_files_hold_their_reductions():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/configs/")
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert cfg[key] != cfg["published"][key]
        assert cfg["shape"] == cfg["published"]["shape"]
        assert len(cfg["fields"]) == cfg["n_fields"]


def test_per_layer_metrics_name_known_layers_and_cells():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in {e["name"] for e in spec.load_cell(cell).end_to_end}, (
                m["name"], cell)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
