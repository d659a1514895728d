"""The port's program spans and counters (``gumbi_tpu_torch.utils.profiling``).

Off, the default, ``span`` and ``count`` record nothing; on, spans nest by
thread with their parents and counters add up. The optimizer and the two
objectives carry the spans the benchmark's readers key on, and tracing
changes none of their numbers.
"""

import threading

import numpy as np
import pytest
import torch

from gumbi_tpu_torch.ops import CoregTerm, GPSpec, GPTerm, initial_params, ls_prior_params
from gumbi_tpu_torch.ops import kronecker, optimize
from gumbi_tpu_torch.ops.mll import map_neg_logp
from gumbi_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean():
    prof.collect()
    yield
    prof.collect()


def _tree(spans):
    """(name, parent name) of each collected span, in order."""
    return [(name, spans[parent][0] if parent >= 0 else None) for name, _, _, parent, _ in spans]


def test_off_records_nothing_and_returns_the_shared_null_context():
    assert prof.span("objective") is prof.span("lbfgs.run") is prof._NULL
    with prof.span("lbfgs.run"), prof.span("objective"):
        prof.count("lbfgs.iters", 3)
    assert prof.collect() == {"spans": [], "counts": {}}


def test_tracing_context_restores_the_previous_setting():
    with prof.tracing():
        assert prof.span("objective") is not prof._NULL
        with prof.tracing(False):
            assert prof.span("objective") is prof._NULL
        assert prof.span("objective") is not prof._NULL
    assert prof.span("objective") is prof._NULL


def test_on_nests_spans_with_parents_and_self_time_and_adds_counters():
    with prof.tracing():
        with prof.span("lbfgs.run"):
            for _ in range(2):
                with prof.span("lbfgs.vg"):
                    with prof.span("objective"):
                        with prof.span("objective.gram"):
                            pass
                    with prof.span("lbfgs.read"):
                        pass
                prof.count("lbfgs.vg")
            prof.count("lbfgs.iters", 5)
            prof.count("lbfgs.iters")
    got = prof.collect()
    spans = got["spans"]
    assert got["counts"] == {"lbfgs.vg": 2, "lbfgs.iters": 6}
    assert _tree(spans) == [("lbfgs.run", None)] + 2 * [
        ("lbfgs.vg", "lbfgs.run"), ("objective", "lbfgs.vg"), ("objective.gram", "objective"),
        ("lbfgs.read", "lbfgs.vg"),
    ]
    for _, start, end, _, thread in spans:
        assert start <= end and thread == threading.get_ident()
    totals = prof.span_totals(spans)
    dur = [end - start for _, start, end, _, _ in spans]
    children = {i: [j for j, s in enumerate(spans) if s[3] == i] for i in range(len(spans))}
    run_self = dur[0] - sum(dur[j] for j in children[0])
    assert totals["lbfgs.run"] == (1, dur[0], run_self)
    vg = [i for i, s in enumerate(spans) if s[0] == "lbfgs.vg"]
    assert totals["lbfgs.vg"] == (
        2, sum(dur[i] for i in vg), sum(dur[i] - sum(dur[j] for j in children[i]) for i in vg)
    )
    assert totals["objective.gram"][2] == totals["objective.gram"][1]  # a leaf's self time is its duration
    assert prof.collect() == {"spans": [], "counts": {}}


def test_spans_of_another_thread_nest_on_their_own_stack():
    seen = []

    def worker():
        with prof.span("objective"):
            with prof.span("objective.linalg"):
                seen.append(threading.get_ident())

    with prof.tracing():
        with prof.span("lbfgs.run"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    spans = prof.collect()["spans"]
    by_name = {s[0]: s for s in spans}
    assert by_name["objective"][3] == -1 and by_name["objective"][4] == seen[0]
    assert spans[by_name["objective.linalg"][3]][0] == "objective"
    assert by_name["lbfgs.run"][3] == -1


def test_spans_become_profiler_ranges_only_while_a_profiler_records():
    with prof.tracing():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            with prof.span("objective"):
                torch.ones(4).sum()
        with prof.span("objective.gram"):
            pass
    names = {e.name for e in p.events()}
    assert "objective" in names and "objective.gram" not in names
    assert [s[0] for s in prof.collect()["spans"]] == ["objective", "objective.gram"]


def test_span_names_are_one_tuple_of_the_port_s_spans():
    assert len(set(prof.SPAN_NAMES)) == len(prof.SPAN_NAMES) == 9
    assert {"lbfgs.run", "lbfgs.vg", "lbfgs.v", "lbfgs.read", "objective", "objective.grad"} <= set(prof.SPAN_NAMES)


# ------------------------------------------------------------------
# The optimizer and the objectives under tracing
# ------------------------------------------------------------------


def _dense_problem(n=40, seed=0):
    rng = np.random.default_rng(seed)
    spec = GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad"),), d_cont=2, ard=True)
    xc = torch.tensor(rng.uniform(-2, 2, size=(n, 2)))
    y = torch.sin(1.3 * xc[:, 0]) * torch.cos(0.9 * xc[:, 1]) + 0.1 * torch.tensor(rng.normal(size=n))
    xk = torch.zeros((n, 0), dtype=torch.long)
    la, lb = (torch.as_tensor(a) for a in ls_prior_params([0.05, 0.05], [4.0, 4.0]))
    u0s = initial_params(spec, la, lb, n_restarts=2, seed=0, device="cpu")
    return spec, xc, xk, y, la, lb, u0s


def _kron_problem(n=32, seed=1):
    rng = np.random.default_rng(seed)
    out = CoregTerm(name="Parameter", col=0, d_out=2)
    spec = GPSpec(terms=(GPTerm(suffix="total", kernel="ExpQuad", coregs=(out,)),), d_cont=2, ard=True,
                  noise_coreg=CoregTerm(name="Output_noise", col=0, d_out=2))
    xc = torch.tensor(rng.uniform(-2, 2, size=(n, 2)))
    f1 = torch.sin(1.3 * xc[:, 0]) * torch.cos(0.9 * xc[:, 1])
    Y = torch.stack([f1 + 0.1 * torch.tensor(rng.normal(size=n)), 0.7 * f1 + 0.15 * torch.tensor(rng.normal(size=n))], 1)
    la, lb = (torch.as_tensor(a) for a in ls_prior_params([0.05, 0.05], [4.0, 4.0]))
    u0s = initial_params(spec, la, lb, n_restarts=2, seed=0, device="cpu")
    return spec, xc, Y, la, lb, u0s


def _dense_objective():
    spec, xc, xk, y, la, lb, u0s = _dense_problem()
    return (lambda u: map_neg_logp(spec, u, xc, xk, y, la, lb)), {k: v[0] for k, v in u0s.items()}


def _kron_objective():
    spec, xc, Y, la, lb, u0s = _kron_problem()
    return (lambda u: kronecker.kron_neg_logp(spec, u, xc, Y, la, lb)), {k: v[1] for k, v in u0s.items()}


OBJECTIVES = {"dense": _dense_objective, "kron": _kron_objective}


@pytest.mark.parametrize("kind", list(OBJECTIVES))
def test_lbfgs_is_bit_equal_with_tracing_on_and_counts_its_work(kind):
    fun, x0 = OBJECTIVES[kind]()
    calls = {"vg": 0, "v": 0}

    def counted(u):
        calls["vg" if torch.is_grad_enabled() else "v"] += 1
        return fun(u)

    x_off, f_off, it_off = optimize.lbfgs_backtracking_minimize(fun, x0, maxiter=30, ftol=1e-9)
    assert prof.collect() == {"spans": [], "counts": {}}
    with prof.tracing():
        x_on, f_on, it_on = optimize.lbfgs_backtracking_minimize(counted, x0, maxiter=30, ftol=1e-9)
    got = prof.collect()
    assert it_on == it_off > 0 and torch.equal(f_on, f_off) and calls["v"] > 0
    for k in x_off:
        assert torch.equal(x_on[k], x_off[k]), k
    counts = got["counts"]
    assert counts["lbfgs.iters"] == it_on
    assert counts["lbfgs.vg"] == calls["vg"] and counts.get("lbfgs.v", 0) == calls["v"]
    totals = prof.span_totals(got["spans"])
    assert totals["lbfgs.run"][0] == 1
    assert totals["lbfgs.vg"][0] == calls["vg"] and totals.get("lbfgs.v", (0,))[0] == calls["v"]
    n_evals = calls["vg"] + calls["v"]
    assert totals["objective"][0] == n_evals and totals["objective.grad"][0] == calls["vg"]
    assert totals["lbfgs.read"][0] == n_evals
    # the run's time splits into objective, reads and the optimizer's own work, exactly
    own = sum(totals[k][2] for k in ("lbfgs.run", "lbfgs.vg", "lbfgs.v") if k in totals)
    parts = totals["objective"][1] + totals["objective.grad"][1] + totals["lbfgs.read"][1]
    assert own + parts == totals["lbfgs.run"][1]


@pytest.mark.parametrize("kind", list(OBJECTIVES))
def test_objective_value_and_grad_put_gram_linalg_and_prior_under_objective(kind):
    fun, x0 = OBJECTIVES[kind]()
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in x0.items()}
    with prof.tracing():
        with prof.span("objective"):
            value = fun(leaves)
        with prof.span("objective.grad"):
            torch.autograd.grad(value, list(leaves.values()))
    spans = prof.collect()["spans"]
    tree = _tree(spans)
    assert tree[0] == ("objective", None) and tree[-1] == ("objective.grad", None)
    inner = {name for name, parent in tree if parent == "objective"}
    assert inner == {"objective.gram", "objective.linalg", "objective.prior"}
    assert all(parent == "objective" for name, parent in tree[1:-1])


def test_multi_restart_records_one_lbfgs_run_a_restart():
    spec, xc, xk, y, la, lb, u0s = _dense_problem()
    with prof.tracing():
        _, _, aux = optimize.multi_restart_minimize(
            lambda u: map_neg_logp(spec, u, xc, xk, y, la, lb), u0s, maxiter=8
        )
    got = prof.collect()
    totals = prof.span_totals(got["spans"])
    assert totals["lbfgs.run"][0] == 2
    assert got["counts"]["lbfgs.iters"] == int(aux["iters"].sum())
    assert got["counts"]["lbfgs.vg"] + got["counts"].get("lbfgs.v", 0) == int(aux["evals"].sum())
