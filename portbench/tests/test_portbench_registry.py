"""BENCHMARK.json and the files it names: found by name, within the contract's limits."""

import json
import re

import pytest

from portbench.harness import core

BENCH = core.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS])
def test_names_use_allowed_characters(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    reader = core.load_metric(metric["name"])
    assert callable(reader.read)
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", names)) <= names
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moves.get("workloads", names))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=[w["name"] for w in BENCH["workloads"]])
def test_cell_finds_config_mix_loop_family_and_limits(cell):
    cfg = core.load_config(BENCH, cell["config"])
    mix = core.load_traffic(cell["traffic"])
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    family = core.load_family(cfg["family"])
    reference = core.load_reference(cfg["family"])
    loop = core.load_loop(mix["loop"])
    assert callable(loop.run) and callable(reference.neg_logp) and reference.SHAPES and family.STAGES
    limits = core.load_limits(cell["name"])
    assert limits and all(v["limit"] > 0 for v in limits.values())
    reported = {m["name"] for t in (0, 1) for m in core.cell_metrics(BENCH, cell["name"], t)}
    assert "setup_s" in reported and len(core.cell_metrics(BENCH, cell["name"], 1)) >= 1


@pytest.mark.parametrize("config", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_every_config_is_used_and_lies_under_paths(config):
    assert config["file"].startswith("portbench/") and config["reduced"] == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_seed_words_take_any_whole_number():
    for seed in (0, 1, 2**31 + 11, 2**40 + 3, -5):
        assert core.rng_for(seed, 1).integers(1 << 30) == core.rng_for(seed, 1).integers(1 << 30)
    assert core.rng_for(2**31 + 11, 1).integers(1 << 30) != core.rng_for(2**31 + 12, 1).integers(1 << 30)
