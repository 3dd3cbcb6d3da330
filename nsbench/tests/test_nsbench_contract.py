"""BENCHMARK.json keeps the benchmark's contract, and every name in it
has its files."""

import json
import re

from nsbench.registry import Registry

from conftest import CHECKOUT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert bench["paths"] == ["nsbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert c["file"].startswith("nsbench/") and c["reduced"] == []
        assert json.loads((CHECKOUT / c["file"]).read_text())["name"] == \
            c["name"]
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        assert (CHECKOUT / "nsbench/traffic" / f"{w['traffic']}.json").exists()
        assert (CHECKOUT / "nsbench/limits" / f"{w['name']}.json").exists()
        used.add(w["config"])
    assert used == set(configs)
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in {"host_clock", "device_trace"}
    layers = {layer["layer"] for layer in Registry().layers().values()}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert m["layer"] in layers | {"device"}
        assert set(m.get("workloads", cells)) <= cells
        assert (CHECKOUT / "nsbench/metrics" / f"{m['name']}.py").exists()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for cell in cells:
        reg = Registry()
        assert len(reg.metrics_of(cell, "end_to_end")) >= 2
        assert reg.metrics_of(cell, "per_layer")


def test_configurations_state_the_reference_suite_at_full_scale():
    for name, n in (("cavity256_re1000", 256), ("cavity2048_re1000", 2048)):
        config = Registry().config(name)
        assert config["params"]["i_max"] == config["params"]["j_max"] == n
        assert config["params"]["max_it"] == 20000
        assert config["guarantees"]["state_dtype"] == "float32"
        assert config["guarantees"]["pressure_master_dtype"] == "float64"
