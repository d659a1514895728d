"""Run the sharded computations of :mod:`gumbi_tpu_torch.parallel` on a world
of local processes, one per rank, and bring their results back.

    results = launch(jobs, world=4, meshes={"2x2": 2, "1x4": 1})

starts ``world`` processes of ``python -m gumbi_tpu_torch.tools.mesh_jobs``
(a gloo group on localhost, or NCCL with ``device_type='cuda'``), builds in
each the named meshes (name → ``restart_axis``), and runs every job
``(name, function, kwargs)`` in order: ``function`` names a job of this
module, called as ``function(meshes, device, **kwargs)`` and returning a dict
of numpy arrays. A job that raises fails alone; each rank writes each job's
result (or its traceback) to its own file as it finishes. ``launch`` returns
``{name: [rank 0's result, rank 1's, ...]}``, a result being ``("ok", dict)``
or ``("error", text)``; a job that no rank finished within ``timeout``
seconds is missing, and every process is stopped by then. Every rank runs
one thread, and its process group times out after ``GROUP_TIMEOUT_S``, so
a mismatched collective fails its job instead of hanging the run.

The jobs import torch and this package only; the comparisons with any other
implementation stay in the caller.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

__all__ = ["launch"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Each rank's process group timeout (s): a mismatched collective fails its job
GROUP_TIMEOUT_S = 60


def launch(jobs, world, meshes, timeout=120.0, device_type="cpu", backend=None):
    """Run ``jobs`` on ``world`` local ranks; see the module docstring.
    ``backend`` defaults to gloo on the CPU and NCCL on CUDA (gloo on CUDA
    puts several ranks on one card)."""
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "jobs.pkl"), "wb") as f:
            pickle.dump({"jobs": jobs, "meshes": meshes, "device_type": device_type, "backend": backend}, f)
        port = _free_port()
        procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join([_ROOT, os.environ.get("PYTHONPATH", "")]))
            procs.append(subprocess.Popen([sys.executable, "-m", "gumbi_tpu_torch.tools.mesh_jobs", d], env=env,
                                          cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            logs = [p.communicate()[0].decode(errors="replace") for p in procs]
        results = {}
        for i, (name, _, _) in enumerate(jobs):
            per_rank = []
            for rank in range(world):
                path = os.path.join(d, f"{rank}_{i}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        per_rank.append(pickle.load(f))
                else:
                    per_rank.append(("error", f"rank {rank} did not finish job {name!r} within {timeout} s; "
                                              f"its output:\n{logs[rank][-4000:]}"))
            results[name] = per_rank
        return results


def _worker(d):
    import torch.distributed as dist

    from ..parallel import make_mesh

    with open(os.path.join(d, "jobs.pkl"), "rb") as f:
        cfg = pickle.load(f)
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = cfg["backend"] or ("nccl" if cfg["device_type"] == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    meshes = {name: make_mesh(restart_axis=ra, device_type=cfg["device_type"]) for name, ra in cfg["meshes"].items()}
    device = torch.device("cuda", torch.cuda.current_device()) if cfg["device_type"] == "cuda" else torch.device("cpu")
    for i, (name, fn, kwargs) in enumerate(cfg["jobs"]):
        try:
            out = ("ok", globals()[fn](meshes, device, **kwargs))
        except Exception:  # noqa: BLE001 - the job's own failure, reported to the caller
            out = ("error", traceback.format_exc())
        with open(os.path.join(d, f"{rank}_{i}.pkl.tmp"), "wb") as f:
            pickle.dump(out, f)
        os.replace(os.path.join(d, f"{rank}_{i}.pkl.tmp"), os.path.join(d, f"{rank}_{i}.pkl"))
    dist.destroy_process_group()


# ------------------------------------------------------------------
# Jobs: numpy in, numpy out
# ------------------------------------------------------------------


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _np(x) for k, x in v.items()}
    return np.asarray(v)


def _t(a, device, dtype=torch.float64):
    return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def restart_fit(meshes, device, mesh, kind, spec, arrays, u0s, maxiter, tol, mask=None):
    """One restart-sharded fit: ``kind`` in gp, kron, laplace, fitc, fitc_laplace."""
    from .. import parallel

    fn = {"gp": parallel.sharded_fit_gp_map, "kron": parallel.sharded_fit_kron_map,
          "laplace": parallel.sharded_fit_laplace_map, "fitc": parallel.sharded_fit_fitc_map,
          "fitc_laplace": parallel.sharded_fit_fitc_laplace_map}[kind]
    int_idx = {"gp": (1,), "laplace": (1,), "fitc": (1, 3), "fitc_laplace": (1, 3), "kron": ()}[kind]
    args = [_t(a, device, torch.long if i in int_idx else torch.float64) for i, a in enumerate(arrays)]
    kw = {} if kind == "kron" else {"mask": _t(mask, device)}
    params, f, aux = fn(meshes[mesh], spec, *args, {k: _t(v, device) for k, v in u0s.items()},
                        maxiter=maxiter, tol=tol, **kw)
    return {"params": _np(params), "f": float(f), "all_values": aux["all_values"], "iters": aux["iters"],
            "best_restart": aux["best_restart"], "n_padded": aux["n_padded"]}


def gram_mll(meshes, device, mesh, spec, params, xc, xk, y, dtype="float64"):
    """``sharded_gram_mll``'s value and its gradient in every parameter, at
    ``dtype``."""
    from ..parallel import sharded_gram_mll

    dt = getattr(torch, dtype)
    p = {k: _t(v, device, dt).requires_grad_(True) for k, v in params.items()}
    xc, xk, y = _t(xc, device, dt), _t(xk, device, torch.long), _t(y, device, dt)
    val = sharded_gram_mll(meshes[mesh], spec, p, xc, xk, y)
    grads = torch.autograd.grad(val, list(p.values()))
    with torch.no_grad():
        val_nograd = sharded_gram_mll(meshes[mesh], spec, p, xc, xk, y)
    return {"value": float(val.detach()), "value_nograd": float(val_nograd), "grads": _np(dict(zip(p, grads)))}


def quad_logdet(meshes, device, mesh, K, y, g_quad, g_logdet):
    """``blocked_cholesky``, and ``dist_quad_and_logdet``'s values with the
    gradients of g_quad·quad + g_logdet·logdet in K and y."""
    from ..parallel import blocked_cholesky, dist_quad_and_logdet

    Kt, yt = _t(K, device).requires_grad_(True), _t(y, device).requires_grad_(True)
    L = blocked_cholesky(meshes[mesh], Kt.detach())
    quad, logdet = dist_quad_and_logdet(meshes[mesh], Kt, yt)
    gK, gy = torch.autograd.grad(g_quad * quad + g_logdet * logdet, (Kt, yt))
    return {"L": _np(L), "quad": float(quad), "logdet": float(logdet), "gK": _np(gK), "gy": _np(gy)}


def data_fit(meshes, device, mesh, spec, xc, xk, y, ls_alpha, ls_beta, u0s, maxiter, tol):
    """``data_sharded_fit_gp_map``."""
    from ..parallel import data_sharded_fit_gp_map

    params, f, aux = data_sharded_fit_gp_map(
        meshes[mesh], spec, _t(xc, device), _t(xk, device, torch.long), _t(y, device), _t(ls_alpha, device),
        _t(ls_beta, device), {k: _t(v, device) for k, v in u0s.items()}, maxiter=maxiter, tol=tol)
    return {"params": _np(params), "f": float(f), "all_values": aux["all_values"], "iters": aux["iters"]}


def predict(meshes, device, mesh, spec, params, xc, xk, y, mask, xs, ks):
    """``sharded_predict_diag`` with and without noise on a posterior cache
    (bucket-masked where ``mask`` is given)."""
    from ..ops.posterior import posterior_cache
    from ..parallel import sharded_predict_diag

    p = {k: _t(v, device) for k, v in params.items()}
    cache = posterior_cache(spec, p, _t(xc, device), _t(xk, device, torch.long), _t(y, device),
                            mask=_t(mask, device))
    out = {}
    for noise in (True, False):
        m, v = sharded_predict_diag(meshes[mesh], spec, p, cache, _t(xs, device), _t(ks, device, torch.long),
                                    with_noise=noise)
        out[f"mean_{noise}"], out[f"var_{noise}"] = _np(m), _np(v)
    return out


def dist_iter(meshes, device, mesh, spec, cfg, uparams, xc, xk, y, ls_alpha, ls_beta, probe_n, probe_k, mask):
    """The distributed iterative objective's value, regime and gradient, and
    its posterior cache."""
    from ..ops.priors import constrain
    from ..parallel import dist_iter_map_neg_logp, dist_iter_posterior_cache

    u = {k: _t(v, device).requires_grad_(True) for k, v in uparams.items()}
    args = [_t(a, device) for a in (xc,)] + [_t(xk, device, torch.long)] + [
        _t(a, device) for a in (y, ls_alpha, ls_beta, probe_n, probe_k)]
    xc_t, xk_t, y_t, la, lb, pn, pk = args
    m = _t(mask, device)
    info = {}
    val = dist_iter_map_neg_logp(meshes[mesh], spec, u, xc_t, xk_t, y_t, la, lb, pn, pk, cfg, m, info=info)
    grads = torch.autograd.grad(val, list(u.values()))
    cinfo = {}
    cache = dist_iter_posterior_cache(meshes[mesh], spec, cfg, {k: v.detach() for k, v in constrain(u).items()},
                                      xc_t, xk_t, y_t, m, info=cinfo)
    return {"value": float(val), "grads": _np(dict(zip(u, grads))), "exhausted": bool(info["exhausted"]),
            "iters": int(info["iters"]), "cache": _np(cache), "cache_exhausted": bool(cinfo["exhausted"]),
            "cache_iters": int(cinfo["iters"])}


def model(meshes, device, mesh, cls, columns, outputs, fit_kw, find_kw, points, predict_mesh=True):
    """``ArrayTableGP``/``ArrayTableGPC(...).fit(..., MAP_kwargs={'mesh': ...})``,
    then ``predict`` at ``points`` with the mesh (where ``predict_mesh``) and
    without."""
    from .array_table import ArrayTable, ArrayTableGP, ArrayTableGPC

    klass = {"gp": ArrayTableGP, "gpc": ArrayTableGPC}[cls]
    table = ArrayTable({k: np.asarray(v) for k, v in columns.items()}, outputs=outputs)
    gp = klass(table, outputs=outputs, device=device)
    gp.fit(outputs=outputs, **fit_kw, MAP_kwargs=dict(find_kw, mesh=meshes[mesh]))
    out = {"MAP": gp.MAP, "neg_logp": gp._neg_logp, "structure": gp._structure,
           "has_cache": gp._cache is not None}
    if points is not None:
        pts = np.asarray(points)
        if predict_mesh:
            out["mean_mesh"], out["var_mesh"] = gp.predict(pts, mesh=meshes[mesh])
        out["mean"], out["var"] = gp.predict(pts)
    return out


if __name__ == "__main__":
    _worker(sys.argv[1])
