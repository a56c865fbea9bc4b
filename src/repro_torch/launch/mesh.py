"""Process groups and device meshes for the partitioned paths.

Counterpart of ``repro.launch.mesh``. ``repro`` runs one controller over a
``jax.sharding.Mesh``; the port runs one process per mesh rank (SPMD, as
``torchrun`` starts them) over a :class:`torch.distributed.DeviceMesh`
with the same axis names.

* :func:`init_ranks` sets up the default process group from ``torchrun``'s
  environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``)
  with the backend it is given; without that environment it is a world of
  one. Rank r works on ``cuda:{r % torch.cuda.device_count()}``
  (:func:`rank_device`).
* :func:`make_debug_mesh` is the ``("data", "model")`` mesh over the ranks
  there are, and :func:`contraction_partitioning` the substrate's
  :class:`~repro_torch.nn.substrate.Partitioning` on it.

Backends are the caller's choice and nothing here changes one. ``gloo``
runs every rank on one card, its collectives on CUDA tensors staged
through ordinary host buffers (:mod:`repro_torch.nn.collectives`, which
counts the bytes). ``nccl`` needs a card a rank, and no machine with more
than one card has run the port yet, so it raises rather than run untried
(ROADMAP.md, queue 1 item 14).

The production meshes (16 × 16 and 2 × 16 × 16 devices) and the parameter,
batch and cache sharding rules serve ``repro``'s dry-run tooling, which is
ROADMAP.md queue 1 item 12; they raise here.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def _item14():
    raise NotImplementedError(
        "backend 'nccl' needs a card a rank, and no machine with more than "
        "one card has run the port's nccl path yet (ROADMAP.md, queue 1 "
        "item 14); run backend 'gloo'")


def _item12(what: str):
    raise NotImplementedError(
        f"{what} serves the TPU-mesh dry-run tooling (256 / 512 devices), "
        "which is not ported yet (ROADMAP.md, queue 1 item 12)")


def init_ranks(backend: str) -> int:
    """Join (or form) the default process group; returns this rank.

    Under ``torchrun`` the group spans its ``WORLD_SIZE`` ranks
    (``env://``); without its environment this process is a world of one.
    An already initialized group is kept, if its backend is ``backend``.
    ``nccl`` raises (:func:`_item14`).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        _item14()
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(
                f"the process group runs {dist.get_backend()!r}, not "
                f"{backend!r}")
        return dist.get_rank()
    env = os.environ
    distributed = "RANK" in env and "WORLD_SIZE" in env
    rank = int(env["RANK"]) if distributed else 0
    world = int(env["WORLD_SIZE"]) if distributed else 1
    if distributed:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return rank


def rank_device(device_type: str, rank: Optional[int] = None) -> torch.device:
    """The device rank ``rank`` (default: this one) works on: ``cpu``, or
    ``cuda:{rank % device_count}``."""
    if device_type == "cpu":
        return torch.device("cpu")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_debug_mesh(n_devices: Optional[int] = None):
    """``(n // 2, 2)`` ranks when n is even, ``(n, 1)`` when odd, named
    ``("data", "model")``, over the default group's ranks (``n`` defaults
    to its size and must equal it). The mesh's device type is ``cpu``:
    ``gloo``'s collectives run on host tensors."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs a process group: call "
                           "init_ranks(backend) first")
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a world of "
                         f"{dist.get_world_size()}")
    model = 2 if n % 2 == 0 else 1
    return init_device_mesh("cpu", (n // model, model),
                            mesh_dim_names=("data", "model"))


def contraction_partitioning(mesh, *, m_axis: str = "data",
                             k_axis: Optional[str] = "model"):
    """Substrate :class:`~repro_torch.nn.substrate.Partitioning` for this
    mesh: data-parallel M over ``m_axis``, reduce-scattered K over
    ``k_axis``; an axis missing from the mesh is dropped."""
    from repro_torch.nn import substrate as psub

    names = tuple(mesh.mesh_dim_names)
    m = m_axis if m_axis in names else None
    k = k_axis if (k_axis and k_axis in names) else None
    return psub.Partitioning(mesh, m_axis=m, k_axis=k)


def make_production_mesh(*, multi_pod: bool = False):
    _item12("make_production_mesh (16 x 16 or 2 x 16 x 16 devices)")


def param_shardings(tree, mesh):
    _item12("param_shardings")


def batch_shardings(tree, mesh):
    _item12("batch_shardings")


def cache_shardings(tree, mesh):
    _item12("cache_shardings")
