"""The readers of the program's own spans (``harness/program.py``): idle time
put down to the innermost program span, launch records counted only inside
evaluation spans, annotations never read as device work, and per-job numbers
that add up to the L-BFGS runs, on synthetic events and tiny CPU jobs."""

import types

import pytest
import torch

from portbench.harness import program, trace
from portbench.tests.test_portbench_loops import BENCH, tiny_context

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, annotation=False, thread=1):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=device, is_user_annotation=annotation, thread=thread)


def spans(thread=1):
    """A job (0-110 us) whose one L-BFGS run holds one value+grad."""
    return [ev("job", 0, 110, annotation=True, thread=thread),
            ev("lbfgs.run", 0, 100, annotation=True, thread=thread),
            ev("lbfgs.vg", 10, 50, annotation=True, thread=thread),
            ev("objective", 12, 30, annotation=True, thread=thread),
            ev("objective.gram", 14, 20, annotation=True, thread=thread),
            ev("lbfgs.read", 40, 50, annotation=True, thread=thread)]


KERNELS = [ev(f"k{i}", s, e, CUDA) for i, (s, e) in enumerate([(0, 5), (16, 18), (22, 42), (60, 100)])]


def test_idle_goes_to_the_innermost_span_of_the_job_thread():
    other = [ev("objective", 0, 110, annotation=True, thread=2)]  # another thread's span is not the job's
    got = program.attribute(spans() + other + KERNELS, "job")
    # gaps 5-16, 18-22, 42-60 and 100-110; innermost: run 0-10, vg 10-12, objective 12-14,
    # gram 14-20, objective 20-30, vg 30-40, read 40-50, run 50-100, none 100-110
    assert got["idle_by_span"] == pytest.approx(
        {"lbfgs.run": 15e-6, "lbfgs.vg": 2e-6, "objective": 4e-6, "objective.gram": 4e-6, "lbfgs.read": 8e-6})
    assert got["idle_outside_s"] == pytest.approx(10e-6)
    assert got["window_s"] == pytest.approx(110e-6) and got["busy_s"] == pytest.approx(67e-6)
    assert sum(got["idle_by_span"].values()) + got["idle_outside_s"] == pytest.approx(got["window_s"] - got["busy_s"])
    assert program.trace_numbers(got)["objective_idle_ms"] == pytest.approx(8e-3)


def test_launch_records_count_only_inside_evaluation_spans():
    launches = [ev("cudaLaunchKernel", 11, 11.5), ev("cudaLaunchKernel", 13, 13.5), ev("cuLaunchKernel", 45, 45.2),
                ev("cudaLaunchKernelExC", 25, 25.1, thread=3),  # the backward's thread, inside the evaluation
                ev("cudaLaunchKernel", 5, 5.5), ev("cudaLaunchKernelExC", 52, 52.5),  # in the run, no evaluation
                ev("cudaMemcpyAsync", 46, 47)]
    got = program.attribute(spans() + KERNELS + launches, "job")
    assert (got["launches"], got["evals"]) == (4, 1)
    assert got["launches_by_name"] == {"cudaLaunchKernel": 2, "cuLaunchKernel": 1, "cudaLaunchKernelExC": 1}
    assert program.trace_numbers(got)["launches_per_eval"] == 4.0


def test_annotations_on_the_device_timeline_are_never_device_work():
    mirrored = [ev("objective", 12, 30, CUDA, annotation=True), ev("lbfgs.run", 0, 100, CUDA, annotation=True),
                ev("user_range", 5, 16, CUDA, annotation=True),
                ev("lbfgs.vg", 10, 50, CUDA)]  # a build that does not flag the copy: skipped by name
    clean = program.attribute(spans() + KERNELS, "job")
    assert program.attribute(spans() + KERNELS + mirrored, "job") == clean

    class Prof:
        def __init__(self, events):
            self._events = events

        def events(self):
            return self._events

    stages = [ev("coarse", 0, 100, annotation=True)]
    base = trace.reduce(Prof(spans() + stages + KERNELS), {}, "job", ("coarse",), 1)
    with_copies = Prof(spans() + stages + KERNELS + mirrored)
    assert trace.reduce(program.DeviceOnly(with_copies), {}, "job", ("coarse",), 1) == base
    assert trace.reduce(with_copies, {}, "job", ("coarse",), 1)["busy_s"] > base["busy_s"]
    assert trace.reduce(program.DeviceOnly(Prof(spans() + stages + KERNELS)), {}, "job", ("coarse",), 1) == base


def test_no_unit_or_no_program_span_reads_nothing():
    assert program.attribute(KERNELS, "job") is None
    bare = program.attribute([ev("job", 0, 110, annotation=True)] + KERNELS, "job")
    assert bare["idle_by_span"] == {} and bare["idle_outside_s"] == pytest.approx(bare["idle_s"])
    assert program.trace_numbers(bare) == {}
    assert program.job_numbers({"spans": [], "counts": {}}) is None
    assert program.window_numbers([None, None]) == {}


def test_job_and_window_numbers_from_collected_spans():
    ms = 1_000_000  # ns
    collected = {"spans": [["lbfgs.run", 0, 100 * ms, -1, 1], ["lbfgs.vg", 10 * ms, 50 * ms, 0, 1],
                           ["objective", 12 * ms, 30 * ms, 1, 1], ["objective.gram", 14 * ms, 20 * ms, 2, 1],
                           ["objective.grad", 30 * ms, 38 * ms, 1, 1], ["lbfgs.read", 40 * ms, 50 * ms, 1, 1],
                           ["lbfgs.v", 60 * ms, 70 * ms, 0, 1], ["objective", 61 * ms, 65 * ms, 6, 1],
                           ["lbfgs.read", 65 * ms, 69 * ms, 6, 1]],
                 "counts": {"lbfgs.iters": 1, "lbfgs.vg": 1, "lbfgs.v": 1}}
    got = program.job_numbers(collected)
    assert got["objective_host_ms"] == pytest.approx(18 + 8 + 4)
    assert got["read_wait_ms"] == pytest.approx(10 + 4)
    # run self 100 - 40 - 10 = 50, vg self 40 - 36 = 4, v self 10 - 8 = 2
    assert got["optimizer_host_ms"] == pytest.approx(56)
    assert got["objective_host_ms"] + got["optimizer_host_ms"] + got["read_wait_ms"] == pytest.approx(got["run_ms"])
    other = dict(got, objective_host_ms=40.0, iters=3, vg=4, v=2)
    win = program.window_numbers([got, other])
    assert win["objective_host_ms"] == pytest.approx(35.0)
    assert win["evals_per_iter"] == pytest.approx((2 + 6) / 4)


def test_program_names_are_the_port_s_span_names():
    from gumbi_tpu_torch.utils.profiling import SPAN_NAMES

    assert set(program.PROGRAM) == set(SPAN_NAMES)


@pytest.mark.parametrize("name", ["se2.staged-16k", "lmc2.staged-10k"])
def test_tiny_traced_jobs_count_what_the_family_counts(name):
    from gumbi_tpu_torch.utils import profiling

    from portbench.tools import program_trace

    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    ctx = tiny_context(cell, 2**33 + 5)
    got = program_trace.measure(ctx, 1)
    assert len(got["pairs"]) == ctx.traffic["tables"]
    for pair in got["pairs"]:
        assert pair["off"]["program"] is None and pair["off"]["by_stage"] == {}
        on = pair["on"]
        assert on["checks"]["evals_equal"], on
        assert abs(on["checks"]["parts_vs_runs"]) < 1e-9 and on["program"]["iters"] > 0
        assert set(on["by_stage"]) == {"coarse", "mid", "polish"} & set(on["stages"])
    assert set(got["numbers"]) == {"objective_host_ms", "optimizer_host_ms", "read_wait_ms", "evals_per_iter"}
    assert got["numbers"]["evals_per_iter"] >= 1.0 and "coarse" in got["by_stage"]
    assert set(got["cost"]) == {"total", "median_pair"}
    assert profiling.collect() == {"spans": [], "counts": {}} and profiling.span("objective") is profiling._NULL
