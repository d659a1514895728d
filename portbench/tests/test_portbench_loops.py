"""Each traffic loop runs tiny jobs or queries on the CPU through the port's
plain paths; the check passes sound runs and fails the control and every
planted fault, with each cell's own limits."""

import subprocess
import sys
import time
import types

import pytest

from portbench.harness import check, core, faults

BENCH = core.load_benchmark()


def tiny_context(cell, seed, products="exact", seconds=0.2):
    """A run's context at the CPU sizes that the cell's family and loop give
    (their ``TINY``)."""
    cfg = core.load_config(BENCH, cell["config"])
    family = core.load_family(cfg["family"])
    cfg.update(family.TINY)
    mix = core.load_traffic(cell["traffic"])
    mix.update(core.load_loop(mix["loop"]).TINY)
    return types.SimpleNamespace(
        family=family, reference=core.load_reference(cfg["family"]), cfg=cfg,
        traffic=mix, seed=seed, seconds=seconds, trace=False, device="cpu", cuda=False,
        t_start=time.perf_counter(), setup_parts={}, log=lambda msg: None, products=products, check_all=False)


def run_tiny(cell, seed, products="exact", fault=None):
    ctx = tiny_context(cell, seed, products)
    loop = core.load_loop(ctx.traffic["loop"])
    if fault is None:
        rec, values, n = loop.run(ctx)
    else:
        with faults.planted(fault, ctx.traffic["loop"], ctx.family):
            rec, values, n = loop.run(ctx)
    correct, checks = check.judge(values, core.load_limits(cell["name"]), rec.failed, n)
    return rec, correct, checks


CELLS = BENCH["workloads"]
IDS = [w["name"] for w in CELLS]


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_sound_run_is_correct_and_reports_its_metrics(cell):
    rec, correct, checks = run_tiny(cell, 2**31 + 7)
    assert correct, checks
    assert rec.attempted >= 1 and rec.failed == 0 and rec.setup_s > 0 and rec.window_s > 0
    for meta in core.cell_metrics(BENCH, cell["name"], 0):
        if meta["name"] != "peak_gib":  # the CPU has no device allocator
            assert core.load_metric(meta["name"]).read(rec) > 0, meta["name"]
    for meta in core.cell_metrics(BENCH, cell["name"], 1):
        if meta["source"] != "device_trace":
            assert core.load_metric(meta["name"]).read(rec) > 0, meta["name"]


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_tf32_control_is_not_correct(cell):
    _, correct, checks = run_tiny(cell, 2**31 + 9, products="tf32")
    assert not correct, checks


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_planted_fault_is_not_correct(cell, fault):
    _, correct, checks = run_tiny(cell, 2**31 + 11, fault=fault)
    assert not correct, (fault, checks)


def test_runs_load_no_jax_nor_reference_package():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, '.')\n"
        "from portbench.tests.test_portbench_loops import CELLS, run_tiny\n"
        "for cell in CELLS:\n"
        "    run_tiny(cell, 5)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "gumbi_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "gumbi_tpu"}


@pytest.mark.card
def test_run_py_on_the_card(card):
    """run.py end to end on a card: a short window, its result line last."""
    cell = CELLS[1]["name"]
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483701",
                          "--seconds", "3", "--trace", "1"], cwd=core.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0 and list(result)[-1] == "checks"
