"""Device meshes and the data-axis helpers over ``torch.distributed``.

Counterpart of ``ssar_tpu/parallel/mesh.py``.  One process runs a rank; the
ranks of the default process group form the mesh:

- ``get_mesh()``: a cached 1-D ``("data",)`` mesh over every rank (data
  parallelism over frames and batch rows); ``make_mesh(shape, names)`` for
  (data, tp) layouts.  Both are ``DeviceMesh``es on "cuda" (NCCL) unless the
  caller asks for the CPU (gloo).
- ``shard_batch``: this rank's rows of a batch along the data axis.
- ``replicate``: rank 0's tensors broadcast to every rank, in place.

A process with no process group and no ``WORLD_SIZE`` in its environment
(no ``torchrun``) is a world of one: ``get_mesh()`` is then a ``LocalMesh``
and ``shard_batch`` and ``replicate`` are identities, as they are on the JAX
side's one-device mesh.  Under ``torchrun`` the default group is created from
the environment at the first ``get_mesh``.
"""
from __future__ import annotations

import math
import os
import warnings

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import init_device_mesh

_warned_indivisible = False
_meshes: dict = {}   # (n, device type) -> (the default group it was built on, mesh)


class LocalMesh:
    """The mesh of a process that runs alone: every axis of size 1 and no
    process group.  Answers the ``DeviceMesh`` calls the port makes."""

    def __init__(self, shape: tuple[int, ...] = (1,), names: tuple[str, ...] = ("data",),
                 device_type: str = "cuda"):
        if math.prod(shape) != 1:
            raise ValueError(f"a local mesh has one device, not shape {shape}")
        self.shape, self.mesh_dim_names, self.device_type = tuple(shape), tuple(names), device_type

    def size(self, mesh_dim: int | None = None) -> int:
        return 1

    def get_local_rank(self, mesh_dim: int | str | None = None) -> int:
        return 0

    def get_group(self, mesh_dim: int | str | None = None):
        raise RuntimeError("a local mesh has no process group")


def _device_type(device) -> str:
    return "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"


def _distributed() -> bool:
    """Whether this process is one rank of several, or runs under ``torchrun``."""
    return (dist.is_available() and dist.is_initialized()) or "WORLD_SIZE" in os.environ


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def get_mesh(n_devices: int | None = None, device: str | torch.device | None = None):
    """The 1-D ``("data",)`` mesh over all ranks (cached per process group).
    ``n_devices`` may be 1 (every rank computes alone: a ``LocalMesh``) or
    the world size; `device` "cpu" asks for a gloo mesh."""
    world = _world_size()
    n = world if n_devices is None else int(n_devices)
    kind = _device_type(device)
    if n == 1 and (world > 1 or not _distributed()):
        return LocalMesh(device_type=kind)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} ranks")
    group = dist.group.WORLD if dist.is_initialized() else None
    cached = _meshes.get((n, kind))
    if cached is not None and group is not None and cached[0] is group:
        return cached[1]
    mesh = init_device_mesh(kind, (n,), mesh_dim_names=("data",))
    _meshes[(n, kind)] = (dist.group.WORLD, mesh)
    return mesh


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], device: str | torch.device | None = None):
    """A mesh of `shape` over all ranks with axes `names`, e.g. ``((2, 2),
    ("data", "tp"))``; a ``LocalMesh`` for one device outside a process group."""
    kind = _device_type(device)
    if math.prod(shape) == 1 and not _distributed():
        return LocalMesh(tuple(shape), tuple(names), kind)
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name: str) -> int:
    return mesh.get_local_rank(name)


def data_sharding(mesh, ndim: int) -> tuple:
    """The data-axis placement of an `ndim`-dimensional batch on `mesh`, one
    ``DTensor`` placement a mesh axis: ``Shard(0)`` (the leading axis) over
    ``"data"``, ``Replicate()`` over the others.  Counterpart of
    ``ssar_tpu.parallel.mesh.data_sharding``'s ``P("data", None, ...)``."""
    from torch.distributed.tensor import Replicate, Shard

    if ndim < 1:
        raise ValueError("a batch has a leading axis")
    return tuple(Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names)


def shard_batch(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """This rank's rows of `x` (its leading axis split over ``"data"``, as
    ``data_sharding`` places it); `x` itself on a one-device mesh.  A leading
    dim the data axis does not divide is kept whole on every rank (replicated),
    with one warning."""
    mesh = get_mesh(device=x.device) if mesh is None else mesh
    if mesh.size() == 1:
        return x
    n = axis_size(mesh, "data")
    if x.shape[0] % n != 0:
        global _warned_indivisible
        if not _warned_indivisible:
            _warned_indivisible = True
            warnings.warn(
                f"shard_batch: leading dim {x.shape[0]} not divisible by mesh size "
                f"{n}; batch REPLICATED (no data parallelism). "
                f"Pad the batch to a multiple of the mesh for full throughput.",
                stacklevel=2)
        return x
    b = x.shape[0] // n
    return x.narrow(0, axis_rank(mesh, "data") * b, b)


def replicate(tree, mesh=None):
    """Rank 0's values of every tensor in `tree` (a tensor, a dict, a list or
    tuple of them, or an ``nn.Module``'s parameters and buffers) broadcast
    to every rank, in place; returns `tree`.  An identity on one device."""
    if isinstance(tree, nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    else:
        tensors = []

        def collect(t):
            if isinstance(t, torch.Tensor):
                tensors.append(t)
            elif isinstance(t, dict):
                for v in t.values():
                    collect(v)
            elif isinstance(t, (list, tuple)):
                for v in t:
                    collect(v)

        collect(tree)
    if mesh is None:
        mesh = get_mesh(device=tensors[0].device if tensors else None)
    if mesh.size() == 1:
        return tree
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return tree
