"""Collectives over one axis of a ``DeviceMesh``, with their gradients.

Counterpart of the ``jax.lax`` collectives that ``repro``'s ``shard_map``
bodies call: :func:`psum`, :func:`psum_scatter` (tiled, along one
dimension), :func:`all_gather` (tiled), :func:`all_to_all` (``split_axis``
/ ``concat_axis``, tiled, as ``jax.lax.all_to_all``) and :func:`pmax`.
Each takes the tensor, the mesh and the name of the axis whose process
group it runs over, and returns a new tensor.

The port runs SPMD: one process per mesh rank, every rank executing the
same program. So every rank of a group must call the same collectives in
the same order.

Gradients follow ``jax``'s transposes, so a body written as ``repro``'s
differentiates as ``jax.grad`` of it:

* :func:`psum`'s backward is a :func:`psum` of the gradient;
* :func:`psum_scatter`'s is an :func:`all_gather`, and back;
* :func:`all_to_all`'s is the reverse :func:`all_to_all`;
* :func:`pmax` carries none (it scales quantization codes).

Backends. ``gloo`` runs these collectives on host tensors; on CUDA tensors
it offers only ``broadcast`` and ``all_reduce``. Under ``gloo`` a CUDA
tensor is therefore copied into a host buffer, reduced or exchanged there
and copied back, for every collective alike, and each copy's bytes are
added to :data:`STAGED` (``staged_bytes()``). The buffers are ordinary
host memory, freed with the tensor: pinned buffers come from a caching
allocator that keeps every block (rounded up to a power of two), and four
ranks' staging of multi-GB gradients would hold tens of GB of the host's
memory. Its all-to-all is an
all-gather of which each rank keeps its blocks, since not every torch
release gives ``gloo`` an all-to-all; the dry run's fake group
(:func:`repro_torch.launch.dryrun.fake_world`) runs ``all_to_all``. ``gloo`` is the one backend the port
runs (``launch.mesh.init_ranks`` refuses ``nccl`` until a machine with a
card a rank has run it); nothing here chooses a backend.
"""
from __future__ import annotations

import threading
import torch
import torch.distributed as dist

Tensor = torch.Tensor

_STAGED_LOCK = threading.Lock()
#: bytes copied between device and host buffers for ``gloo``
STAGED = {"bytes": 0}


def staged_bytes() -> int:
    """Bytes staged through the host so far in this process."""
    return STAGED["bytes"]


def reset_staged() -> None:
    with _STAGED_LOCK:
        STAGED["bytes"] = 0


def _count(n: int) -> None:
    with _STAGED_LOCK:
        STAGED["bytes"] += n


# ---------------------------------------------------------------------------
# mesh axes
# ---------------------------------------------------------------------------


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _dim(mesh, axis: str) -> int:
    names = axis_names(mesh)
    if axis not in names:
        raise ValueError(f"{axis!r} is not a mesh axis (mesh has {names})")
    return names.index(axis)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return int(mesh.size(_dim(mesh, axis)))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    """The process group of the ranks that share this rank's other
    coordinates, ordered by their coordinate along ``axis``."""
    return mesh.get_group(axis)


# ---------------------------------------------------------------------------
# raw collectives (no autograd)
# ---------------------------------------------------------------------------


def _staging(t: Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: Tensor) -> Tensor:
    h = t.to("cpu", copy=True)
    _count(t.numel() * t.element_size())
    return h


def _to_device(h: Tensor, like: Tensor) -> Tensor:
    out = h.to(like.device)
    _count(h.numel() * h.element_size())
    return out


def _all_reduce(t: Tensor, group, op) -> Tensor:
    t = t.contiguous()
    if _staging(t, group):
        h = _to_host(t)
        dist.all_reduce(h, op=op, group=group)
        return _to_device(h, t)
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(t: Tensor, group, dim: int) -> Tensor:
    n = dist.get_world_size(group)
    src = t.contiguous()
    stage = _staging(src, group)
    if stage:
        src = _to_host(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return _to_device(out, t) if stage else out


def _reduce_scatter(t: Tensor, group, dim: int) -> Tensor:
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"psum_scatter: dimension {dim} of size "
                         f"{t.shape[dim]} does not divide into {n} shards")
    stage = _staging(t, group)
    src = _to_host(t.contiguous()) if stage else t
    parts = [c.contiguous() for c in src.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return _to_device(out, t) if stage else out


def _all_to_all(t: Tensor, group, split_axis: int, concat_axis: int) -> Tensor:
    n = dist.get_world_size(group)
    if t.shape[split_axis] % n:
        raise ValueError(f"all_to_all: split axis {split_axis} of size "
                         f"{t.shape[split_axis]} does not divide into {n}")
    if dist.get_backend(group) != "gloo":   # the dry run's fake group
        ins = [c.contiguous() for c in t.chunk(n, dim=split_axis)]
        outs = [torch.empty_like(c) for c in ins]
        dist.all_to_all(outs, ins, group=group)
        return torch.cat(outs, dim=concat_axis)
    # gloo has no all_to_all in every torch release: each rank gathers
    # every input and keeps its own block of each (n times the bytes)
    i = dist.get_group_rank(group, dist.get_rank())
    everyone = _all_gather(t[None], group, 0)
    return torch.cat([x.chunk(n, dim=split_axis)[i] for x in everyone],
                     dim=concat_axis)


def broadcast_host(t: Tensor, group, src: int = 0) -> Tensor:
    """Broadcast a host tensor from global rank ``src`` over ``group``, in
    place (``gloo`` sends host memory as it is)."""
    dist.broadcast(t, src=src, group=group)
    return t


# ---------------------------------------------------------------------------
# differentiable collectives over a mesh axis
# ---------------------------------------------------------------------------


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, dist.ReduceOp.SUM), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(g, ctx.group, concat_axis, split_axis),
                None, None, None)


def psum(x: Tensor, mesh, axis: str) -> Tensor:
    """Sum over ``axis`` (``jax.lax.psum``); integers sum exactly in
    their ring."""
    return _Psum.apply(x, axis_group(mesh, axis))


def psum_scatter(x: Tensor, mesh, axis: str, dim: int) -> Tensor:
    """Sum over ``axis``, each rank keeping its block of ``dim``
    (``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``)."""
    return _PsumScatter.apply(x, axis_group(mesh, axis), dim % x.dim())


def all_gather(x: Tensor, mesh, axis: str, dim: int) -> Tensor:
    """The ranks' blocks along ``axis`` concatenated along ``dim`` in
    coordinate order (``jax.lax.all_gather(..., axis=dim, tiled=True)``)."""
    return _AllGather.apply(x, axis_group(mesh, axis), dim % x.dim())


def all_to_all(x: Tensor, mesh, axis: str, split_axis: int,
               concat_axis: int) -> Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``x`` splits into as many
    blocks along ``split_axis`` as ``axis`` has ranks, block j goes to rank
    j, and the blocks received are concatenated along ``concat_axis`` in
    the senders' order."""
    return _AllToAll.apply(x, axis_group(mesh, axis), split_axis % x.dim(),
                           concat_axis % x.dim())


def pmax(x: Tensor, mesh, axis: str) -> Tensor:
    """Maximum over ``axis`` (``jax.lax.pmax``); no gradient."""
    return _all_reduce(x.detach(), axis_group(mesh, axis), dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# the shard_map boundary
# ---------------------------------------------------------------------------


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, dist.ReduceOp.SUM), None


class _ReplicatedOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def replicated_in(x: Tensor, mesh, axis: str) -> Tensor:
    """``x`` as a body input replicated over ``axis`` (an in_spec of
    ``shard_map`` that leaves ``axis`` out): the identity, whose gradient
    is summed over ``axis``, as ``shard_map``'s transpose sums it."""
    return _ReplicatedIn.apply(x, axis_group(mesh, axis))


def replicated_out(x: Tensor, mesh, axis: str) -> Tensor:
    """``x`` as a body output replicated over ``axis`` (an out_spec that
    leaves ``axis`` out): the identity, whose gradient is divided by the
    axis size, as ``shard_map``'s transpose divides it; every rank of the
    axis then holds a share of the one gradient that its consumers, run on
    each of them alike, produce."""
    return _ReplicatedOut.apply(x, axis_size(mesh, axis))
