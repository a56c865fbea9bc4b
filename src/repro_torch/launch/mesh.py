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

* :func:`make_production_mesh` is ``repro``'s 16 × 16 ``("data",
  "model")`` or 2 × 16 × 16 ``("pod", "data", "model")`` mesh over a world
  of that many ranks: the dry run's fake world
  (:func:`repro_torch.launch.dryrun.fake_world`) or a real one.
* :func:`param_shardings`, :func:`batch_shardings` and
  :func:`cache_shardings` are ``repro``'s FSDP + TP rules by leaf name,
  returning a :class:`~repro_torch.models.sharding.NamedSharding` (the
  PartitionSpec and its ``DTensor`` placements) per leaf. ``repro``'s
  environment switches ``REPRO_NO_FSDP`` and ``REPRO_CACHE_SHARD`` are
  the keyword arguments ``fsdp`` and ``cache_shard``.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.models import sharding as sh

BACKENDS = ("gloo", "nccl")


def _item14():
    raise NotImplementedError(
        "backend 'nccl' needs a card a rank, and no machine with more than "
        "one card has run the port's nccl path yet (ROADMAP.md, queue 1 "
        "item 14); run backend 'gloo'")


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


#: the mesh's device type for the default group's backend: ``gloo`` runs
#: its collectives on host tensors; the dry run's fake group stands for
#: cards (its tensors are ``meta``; on a ``cpu`` mesh DTensor would run an
#: all-to-all as an all-gather)
_MESH_DEVICE = {"gloo": "cpu", "fake": "cuda"}


def make_debug_mesh(n_devices: Optional[int] = None):
    """``(n // 2, 2)`` ranks when n is even, ``(n, 1)`` when odd, named
    ``("data", "model")``, over the default group's ranks (``n`` defaults
    to its size and must equal it). The mesh's device type is ``cpu``
    under ``gloo``, whose collectives run on host tensors."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs a process group: call "
                           "init_ranks(backend) first")
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a world of "
                         f"{dist.get_world_size()}")
    model = 2 if n % 2 == 0 else 1
    return init_device_mesh(_MESH_DEVICE.get(dist.get_backend(), "cpu"),
                            (n // model, model),
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
    """The production mesh over the default group: 16 × 16 ranks
    ``("data", "model")``, or 2 × 16 × 16 ``("pod", "data", "model")`` with
    ``multi_pod`` (the "pod" axis pure data parallelism). The world must
    have exactly that many ranks (:func:`repro_torch.launch.dryrun.fake_world`
    forms one in one process)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs a process group: "
                           "call init_ranks(backend), or run under "
                           "dryrun.fake_world(n)")
    n = 512 if multi_pod else 256
    if dist.get_world_size() != n:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    device = _MESH_DEVICE.get(dist.get_backend(), "cuda")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


# ---------------------------------------------------------------------------
# name-based parameter sharding rules
# ---------------------------------------------------------------------------

_FSDP = ("pod", "data")

# leaf-name -> PartitionSpec for the *trailing* dims (leading stack dims are
# added as None automatically). Rules are matched on the last path
# components, most-specific first.
_RULES = [
    (("router",), (None, "model")),
    (("moe", "wi"), ("model", _FSDP, None)),
    (("moe", "wg"), ("model", _FSDP, None)),
    (("moe", "wo"), ("model", None, _FSDP)),
    (("wq", "w"), (_FSDP, "model")),
    (("wk", "w"), (_FSDP, "model")),
    (("wv", "w"), (_FSDP, "model")),
    (("wo", "w"), ("model", _FSDP)),
    (("wi", "w"), (_FSDP, "model")),
    (("wg", "w"), (_FSDP, "model")),
    (("wz", "w"), (_FSDP, "model")),
    (("wf", "w"), (_FSDP, "model")),
    (("wo_gate", "w"), (_FSDP, "model")),
    (("in_proj", "w"), (_FSDP, "model")),
    (("out_proj", "w"), ("model", _FSDP)),
    (("patch_proj", "w"), (_FSDP, "model")),
    (("emb",), ("model", _FSDP)),
]


def _segments(key) -> list:
    """A tree key's name segments: a dotted parameter name, a tree path
    (``adafactor``'s state keys) or a list index."""
    parts = key if isinstance(key, tuple) else (key,)
    return [seg for p in parts for seg in str(p).split(".")]


def _map_leaves(fn, tree, names=()):
    """``fn(names, leaf)`` over a tree of dicts, lists and tuples (an
    ``nn.Module``: its named parameters), keeping the structure."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, names + tuple(_segments(k)))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(list(names), tree)


def _match_rule(names: list) -> Optional[tuple]:
    alpha = [n for n in names if not n.isdigit()]
    for pattern, spec in _RULES:
        lp = len(pattern)
        if tuple(alpha[-lp:]) == pattern:
            return spec
        # optimizer-state leaves live one level deeper (m/v/vr/vc)
        if alpha and alpha[-1] in ("m", "v", "vr", "vc") and \
                tuple(alpha[-lp - 1:-1]) == pattern:
            return spec
    return None


def _fit_spec(spec: tuple, shape, mesh, path_names) -> tuple:
    """Right-align the rule to the leaf shape; drop non-dividing axes.
    Factored optimizer leaves (vr: rule minus last dim, vc: rule minus
    second-to-last) are handled by name."""
    sizes = sh.axis_sizes(mesh)
    dims = list(spec)
    leaf = path_names[-1] if path_names else ""
    if leaf == "vr":
        dims = dims[:-1]
    elif leaf == "vc":
        dims = dims[:-2] + dims[-1:] if len(dims) >= 2 else dims
    if len(dims) > len(shape):
        dims = dims[-len(shape):]
    full = [None] * (len(shape) - len(dims)) + dims
    out = []
    for size, d in zip(shape, full):
        if d is None:
            out.append(None)
            continue
        names = d if isinstance(d, tuple) else (d,)
        present = tuple(n for n in names if n in sizes)
        prod = math.prod(sizes[n] for n in present)
        if not present or size % prod != 0:
            out.append(None)
        else:
            out.append(present if len(present) > 1 else present[0])
    return tuple(out)


def param_shardings(tree, mesh, *, fsdp: bool = True):
    """:class:`~repro_torch.models.sharding.NamedSharding` per parameter (a
    module's named parameters, or a dict of them) or optimizer-state leaf,
    by the name rules. ``fsdp=False`` drops the ("pod", "data") weight
    sharding (TP only, weights resident): ``repro``'s ``REPRO_NO_FSDP``."""
    def leaf(names, x):
        spec = _match_rule(names)
        if spec is None:
            return sh.NamedSharding(mesh, ())
        if not fsdp:
            spec = tuple(None if (isinstance(d, tuple) or d in _FSDP) else d
                         for d in spec)
        return sh.NamedSharding(mesh, _fit_spec(spec, x.shape, mesh, names))

    return _map_leaves(leaf, tree)


def batch_shardings(tree, mesh):
    """Inputs: batch dim over ("pod", "data"), rest unsharded; scalars
    replicated."""
    sizes = sh.axis_sizes(mesh)
    present = tuple(n for n in _FSDP if n in sizes)
    prod = math.prod(sizes[n] for n in present)

    def leaf(_names, x):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return sh.NamedSharding(mesh, ())
        if x.shape[0] % prod == 0:
            return sh.NamedSharding(
                mesh, (present,) + (None,) * (len(x.shape) - 1))
        return sh.NamedSharding(mesh, ())

    return _map_leaves(leaf, tree)


def cache_shardings(tree, mesh, *, cache_shard: str = "auto", stacks=None):
    """Decode caches: shard the batch-like dim over ("pod", "data"), and the
    head dim of KV caches over "model".

    ``repro``'s rule, on ``repro``'s leaves: ``stacks`` (a tree like
    ``tree``, :func:`repro_torch.models.registry.decode_state_stacks`)
    gives the number of layers ``repro`` stacks a leaf with, or None. A
    stacked leaf is judged as ``repro``'s ``(n, *shape)``: the first of its
    leading two dims that divides is sharded, else (``cache_shard="auto"``)
    its longest dim; ``"heads"`` (``repro``'s ``REPRO_CACHE_SHARD=heads``)
    tries only the leading dim and never shards a sequence. Where ``repro``
    shards the layer dim, the port's per-layer tensor shards its first free
    dim that divides by the same axes: a device holds the same bytes.
    """
    if cache_shard not in ("auto", "heads"):
        raise ValueError(f"cache_shard must be 'auto' or 'heads', got "
                         f"{cache_shard!r}")
    sizes = sh.axis_sizes(mesh)
    present = tuple(n for n in _FSDP if n in sizes)
    prod = math.prod(sizes[n] for n in present)

    def rule(shape):
        spec = [None] * len(shape)
        batch_dims = 1 if cache_shard == "heads" else min(2, len(shape))
        for dim in range(batch_dims):
            if shape[dim] % prod == 0:
                spec[dim] = present
                break
        else:
            # batch doesn't divide (e.g. long_500k batch=1): shard the
            # longest dim instead (sequence sharding of the KV cache)
            if cache_shard != "heads":
                s, i = max((s, i) for i, s in enumerate(shape))
                if s % prod == 0:
                    spec[i] = present
        # head dim of KV caches (ndim-2) over "model" when divisible
        if "model" in sizes and len(shape) >= 4:
            hd = len(shape) - 2
            if spec[hd] is None and shape[hd] % sizes["model"] == 0:
                spec[hd] = "model"
        return spec

    def leaf(names, x, n):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return sh.NamedSharding(mesh, ())
        shape = tuple(x.shape)
        if not n:
            return sh.NamedSharding(mesh, tuple(rule(shape)))
        spec = rule((n,) + shape)
        layer, spec = spec[0], spec[1:]
        if layer is not None:
            for d, e in enumerate(spec):
                if e is None and shape[d] % prod == 0:
                    spec[d] = layer
                    break
        return sh.NamedSharding(mesh, tuple(spec))

    if stacks is None:
        return _map_leaves(lambda names, x: leaf(names, x, None), tree)
    flat_n = {tuple(k): n for k, n in _flatten(stacks)}
    return _map_leaves(lambda names, x: leaf(names, x, flat_n[tuple(names)]),
                       tree)


def _flatten(tree, names=()):
    """``[(names, leaf)]`` of a tree, as :func:`_map_leaves` walks it."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _flatten(v, names + tuple(_segments(k)))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _flatten(v, names + (str(i),))]
    return [(list(names), tree)]
