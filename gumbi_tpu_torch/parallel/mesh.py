"""Device-mesh construction on ``torch.distributed``, and the collectives the
sharded computations share.

Port of ``gumbi_tpu/parallel/mesh.py``. The reference is single-controller:
one process drives a ``jax.sharding.Mesh`` with axes ('restart', 'data') and
``shard_map`` runs one body per device. Here the idiom is SPMD: one process
per device, a ``DeviceMesh`` with ``mesh_dim_names=("restart", "data")``,
every rank running the same user code, and the collectives running over
``mesh.get_group(...)``. Every rank returns the same replicated result, as
JAX's replicated outputs do.

Inputs of the sharded functions are global tensors, the same on every rank;
each rank takes its own block. A gradient with respect to a replicated input
is summed over the 'data' ranks (:class:`ReplicatedIn`), as ``shard_map``
sums the cotangent of a replicated input.

Ranks must take the same host decisions: a rank that branches differently
makes other collective calls and hangs its group. Every decision that
chooses which collectives run next reads a value that all ranks agree on
(:meth:`Axis.agreement` broadcasts it from the group's first rank), and the
replicated arithmetic in between runs the same code on the same inputs.
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "replicated", "shard_leading", "mesh_device", "AXES", "GROUP_TIMEOUT"]

AXES = ("restart", "data")

# Every process group this package starts gets this timeout, so a stalled
# rank fails its collective instead of hanging the run.
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(n_devices=None, restart_axis=1, device_type="cuda"):
    """A ('restart', 'data') ``DeviceMesh`` of shape
    ``(restart_axis, world // restart_axis)`` over the default process group.

    ``restart_axis`` ranks are given to parallel restarts, the rest to the
    data axis (default: every rank on the data axis). Where no process group
    exists, one process on one device starts a one-rank group itself (NCCL
    for ``'cuda'``, gloo for ``'cpu'``) on a free localhost port, so
    ``GP(...).find_MAP(mesh=make_mesh())`` runs without setup. Several ranks
    start their group first (``torchrun --nproc-per-node N``, or
    ``init_process_group`` with an address, the world size and the rank).
    ``n_devices``, where given, must equal the world size: a mesh spans
    every rank of the group.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') needs CUDA; pass device_type='cpu' for a gloo mesh")
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0,
                                timeout=GROUP_TIMEOUT)
    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"a mesh spans every rank: n_devices={n_devices} but the world has {n}")
    if n % restart_axis != 0:
        raise ValueError(f"{n} devices not divisible by restart_axis={restart_axis}")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank())) % torch.cuda.device_count())
    return init_device_mesh(device_type, (restart_axis, n // restart_axis), mesh_dim_names=AXES)


def replicated(mesh):
    """DTensor placements of a fully replicated tensor on the mesh (the
    reference's ``NamedSharding(mesh, P())``)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def shard_leading(mesh, axis):
    """DTensor placements that shard the leading tensor axis over the named
    mesh axis (the reference's ``NamedSharding(mesh, P(axis))``)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def as_mesh(mesh):
    """``mesh`` if it is a ('restart', 'data') ``DeviceMesh``; raises otherwise."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (gumbi_tpu_torch.parallel.make_mesh), got {type(mesh)!r}")
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"mesh dims must be named {AXES}, got {mesh.mesh_dim_names}")
    return mesh


def mesh_device(mesh):
    """The device this rank computes on: its CUDA card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Axis:
    """One mesh axis as this rank sees it: its group, size and coordinate."""

    def __init__(self, mesh, name):
        mesh = as_mesh(mesh)
        self.group = mesh.get_group(name)
        self.size = mesh.shape[AXES.index(name)]
        self.rank = mesh.get_local_rank(name)

    def block(self, n):
        """This rank's slice of ``n`` rows split evenly over the axis."""
        nb = n // self.size
        return slice(self.rank * nb, (self.rank + 1) * nb)

    def gather_rows(self, t):
        """Every rank's ``t`` stacked along dim 0, in axis order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def broadcast(self, t, owner):
        """``t`` from the rank at axis coordinate ``owner``, in place."""
        dist.broadcast(t, src=dist.get_global_rank(self.group, owner), group=self.group)
        return t

    def reduce_to(self, t, owner):
        """The sum of every rank's ``t``, valid on ``owner`` only (in place)."""
        dist.reduce(t, dst=dist.get_global_rank(self.group, owner), group=self.group)
        return t

    def all_reduce(self, t):
        dist.all_reduce(t, group=self.group)
        return t

    def agreement(self, device):
        """None on a one-rank axis; else ``agree(values) -> np.ndarray``,
        which returns the axis's first rank's float64 values on every rank.
        Host decisions that choose the next collectives read these."""
        if self.size == 1:
            return None

        def agree(values):
            t = torch.as_tensor(np.atleast_1d(np.asarray(values, dtype=np.float64)), device=device).clone()
            return self.broadcast(t, 0).cpu().numpy()

        return agree


class ReplicatedIn(torch.autograd.Function):
    """Identity forward; the backward sums each gradient over the axis's
    group, so a replicated input whose rank-local blocks feed the loss gets
    the whole gradient on every rank (``shard_map``'s psum of a replicated
    input's cotangent)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        out, i = [], 0
        for g in grads:
            out.append(flat[i : i + g.numel()].view_as(g))
            i += g.numel()
        return (None, *out)

