"""Logical-axis sharding: one model code path for one card and for the
256 / 512-rank dry run.

Counterpart of ``repro.models.sharding``. Model code annotates tensors
with *logical* axis names (``constrain(x, "batch", "seq", "embed")``); a
rules table maps logical names to mesh axes. ``repro`` makes a mesh
current with ``with mesh:``; here a mesh is current inside
:func:`mesh_scope` (thread-local, as the other ambients of the port), and
the expert-parallel MoE reads it too (:func:`current_mesh`).

``repro``'s ``with_sharding_constraint`` tells its compiler where a value
lives; the port is eager, so :func:`constrain` redistributes a
``DTensor`` (the dry run's tensors, :mod:`repro_torch.launch.dryrun`) to
the placements the rules give. On a plain tensor, which is every tensor
outside the dry run, and with no mesh current it is the identity: the
partitioned paths of the port (one process per rank, local tensors and
explicit collectives) do not go through it.

A ``PartitionSpec`` here is a tuple with one entry per tensor dimension:
None, a mesh axis name, or a tuple of them (the dimension split over
several mesh axes, the first the major one), as ``repro``'s ``P(...)``.
:func:`placements` turns it into the ``DTensor`` placements, one per mesh
dimension.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import threading
from typing import Any, Optional, Tuple

import torch

_state = threading.local()

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES = {
    "batch": ("pod", "data"),     # batch parallel across pods × data axis
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_cap": ("pod", "data"),
    "tokens": ("pod", "data"),    # flattened batch*seq rows
    "kv_seq": None,
    "conv_w": None,
    "state": None,
    "frames": None,
}


def set_rules(rules: Optional[dict]) -> None:
    """Replace the rules table for this thread; ``None`` restores
    :data:`DEFAULT_RULES`."""
    _state.rules = rules


def get_rules() -> dict:
    return getattr(_state, "rules", None) or DEFAULT_RULES


def current_mesh():
    """The ``DeviceMesh`` of the enclosing :func:`mesh_scope`, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_scope(mesh):
    """Make ``mesh`` current for the block (``repro``'s ``with mesh:``);
    ``None`` clears it. Thread-local: a block run on another thread (the
    recompute of a checkpointed layer) enters it again."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (``repro``'s
    ``mesh.shape``)."""
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def _resolve(axis_name: Optional[str], mesh) -> Optional[object]:
    if axis_name is None:
        return None
    rule = get_rules().get(axis_name, None)
    if rule is None:
        return None
    names = rule if isinstance(rule, tuple) else (rule,)
    present = tuple(n for n in names if n in mesh.mesh_dim_names)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def spec(*logical_axes: Optional[str]) -> Tuple:
    """PartitionSpec for logical axes under the current mesh (or ``()``)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    resolved = []
    used: set = set()
    for ax in logical_axes:
        r = _resolve(ax, mesh)
        # a mesh axis may appear at most once in a PartitionSpec
        if r is not None:
            rs = r if isinstance(r, tuple) else (r,)
            if any(x in used for x in rs):
                r = None
            else:
                used.update(rs)
        resolved.append(r)
    return tuple(resolved)


def placements(pspec: Tuple, mesh) -> Tuple:
    """The ``DTensor`` placements of a PartitionSpec: per mesh dimension,
    ``Shard(d)`` for the tensor dimension ``d`` it splits, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(pspec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``repro``'s ``NamedSharding``: a mesh, the PartitionSpec and its
    ``DTensor`` placements."""

    mesh: Any
    spec: Tuple

    @property
    def placements(self) -> Tuple:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one device's shard (every split divides)."""
        sizes = axis_sizes(self.mesh)
        out = list(shape)
        for d, e in enumerate(self.spec):
            if e is not None:
                names = e if isinstance(e, tuple) else (e,)
                out[d] //= math.prod(sizes[n] for n in names)
        return tuple(out)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor``. None exists before its module is
    imported, so this imports nothing (nor pays for it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def is_distributed(x) -> bool:
    """Whether ``x`` is a ``DTensor`` under a current mesh: the dry run's
    tensors. False at once when no mesh is current."""
    return current_mesh() is not None and is_dtensor(x)


def constrain(x, *logical_axes: Optional[str]):
    """``with_sharding_constraint`` in eager SPMD: a ``DTensor`` under a
    current mesh is redistributed to the rules' placements, and so is its
    cotangent (:class:`_Held`); anything else is returned as it is.

    Axes whose size does not divide the mesh-axis product are left
    unsharded (``repro``'s rule: head counts like kv = 8 on a 16-way model
    axis stay whole).
    """
    if not is_distributed(x):
        return x
    mesh = current_mesh()
    sizes = axis_sizes(mesh)
    resolved = list(spec(*logical_axes))
    for i, r in enumerate(resolved):
        if r is None:
            continue
        names = r if isinstance(r, tuple) else (r,)
        if i < x.ndim and x.shape[i] % math.prod(sizes[n] for n in names):
            resolved[i] = None
    target = placements(tuple(resolved), x.device_mesh)
    if x.is_leaf and x.requires_grad:
        # a parameter: its gradient goes back to its own shards
        # (reduce-scattered), as GSPMD's all-reduce and slice fuse
        return x.redistribute(x.device_mesh, target)
    return _Held.apply(x, target)


class _Held(torch.autograd.Function):
    """``DTensor.redistribute`` whose backward puts the cotangent on the
    same placements, as the transpose of ``with_sharding_constraint`` does.
    A plain ``redistribute``'s backward returns the cotangent to the
    input's placements: a pending sum (``Partial``) then flows on
    unreduced, and ``DTensor`` may run a later contraction whole on every
    rank of an axis rather than reduce it."""

    @staticmethod
    def forward(ctx, t, target):
        ctx.target = target
        return t.redistribute(t.device_mesh, target)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.target), None


def reduce_pending(x):
    """A contraction's result with its pending sums reduced: a ``DTensor``
    under a current mesh that is ``Partial`` over a mesh axis (a
    contraction split over that axis, as a row-parallel projection) is
    summed there (GSPMD's all-reduce after the dot), and its cotangent is
    held to the result's placements. Anything else is returned as it
    is."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate

    return _Held.apply(x, tuple(Replicate() if p.is_partial() else p
                                for p in x.placements))


def is_split(x, dim: int) -> bool:
    """Whether ``x`` is a ``DTensor`` under a current mesh split along
    ``dim`` (a long sequence's cache, split along its positions)."""
    return is_distributed(x) and any(p.is_shard(dim % x.ndim)
                                     for p in x.placements)


def whole_along(x, dim: int):
    """``x`` with its split along ``dim`` gathered, its other splits kept:
    a cache split along its positions, gathered once before a loop takes
    blocks of them (``DTensor`` would gather the whole of it for each
    block). Anything else is returned as it is."""
    if not is_split(x, dim):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(dim % x.ndim) else p for p in x.placements])


def write_at(cache, new, start: int, dim: int) -> None:
    """``cache``'s positions ``start …`` along ``dim`` set to ``new``, in
    place, for a cache split along ``dim`` (:func:`is_split`): written on
    the rank that holds those positions, from ``new`` whole over the
    split, and nothing else moves, as GSPMD updates such a cache in place
    on each shard; ``DTensor`` would gather the whole cache."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = cache.device_mesh
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    n = new.shape[dim]
    lo, hi = max(start, offset[dim]), min(start + n, offset[dim] + shape[dim])
    whole = new.to(cache.dtype).redistribute(mesh, [
        Replicate() if c.is_shard(dim) else p
        for c, p in zip(cache.placements, new.placements)]).to_local()
    if lo < hi:
        cache._local_tensor.narrow(dim, lo - offset[dim], hi - lo).copy_(
            whole.narrow(dim, lo - start, hi - lo))


def placed_as(x, ref):
    """``x`` on ``ref``'s placements: a ``DTensor`` under a current mesh
    (a statistic reduced over a sharded dimension, pending) is
    redistributed to where ``ref`` (the state it updates) lives, as GSPMD
    reduces it to the state's sharding. Anything else is returned as it
    is."""
    if not is_distributed(x):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def split_like(t, ref, dims):
    """``t``, a tensor the model makes (a zero state), split as ``ref``
    is: ``t``'s dimension ``i`` follows ``ref``'s dimension ``dims[i]``
    (None: whole), as GSPMD shards a value like its uses. Each rank keeps
    its own slice; nothing moves. ``t`` is returned as it is unless
    ``ref`` is a ``DTensor`` under a current mesh."""
    if not is_distributed(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mine = {r: i for i, r in enumerate(dims) if r is not None}
    return distribute_tensor(t, ref.device_mesh, [
        Shard(mine[p.dim]) if p.is_shard() and p.dim in mine else Replicate()
        for p in ref.placements], src_data_rank=None)


def split(x, sizes, dim: int):
    """``torch.split(x, sizes, dim)`` of (batch, positions, ...) ``x``. A
    ``DTensor`` under a current mesh split along ``dim`` (a projection's
    output features) has its pieces split as GSPMD splits them: each along
    ``dim`` where the split divides its size, else whole, the feature split
    moved through the positions and back, each move an all-to-all.
    ``DTensor`` would gather the whole of ``x`` and compute on every piece
    whole on each rank of the axis."""
    if not is_split(x, dim):
        return torch.split(x, sizes, dim)
    from torch.distributed.tensor import Replicate, Shard

    dim, alt = dim % x.ndim, 1
    mesh = x.device_mesh
    moved = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    n = math.prod(mesh.size(i) for i in moved)
    taken = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                      if p.is_shard(alt))
    if x.shape[alt] % (taken * n):
        return torch.split(x, sizes, dim)
    y = x.redistribute(mesh, [Shard(alt) if i in moved else p
                              for i, p in enumerate(x.placements)])
    return tuple(
        piece.redistribute(mesh, [
            (Shard(dim) if piece.shape[dim] % n == 0 else Replicate())
            if i in moved else p for i, p in enumerate(piece.placements)])
        for piece in torch.split(y, sizes, dim))


def regroup(x, groups: int, dim: int, alt: int):
    """``x`` ready for its dimension ``dim`` to be viewed as ``(groups,
    -1)`` (the query heads as KV groups): a ``DTensor`` under a current
    mesh whose split of ``dim`` does not divide ``groups`` (internlm2-20b's
    48 query heads in 8 KV groups, 3 a rank of a 16-way "model" axis) has
    that split
    moved to dimension ``alt`` (the query positions) where it divides
    there, else gathered; its cotangent is held to the same placements.
    GSPMD splits such a dimension over both factors; a ``DTensor`` would
    gather it at the view and run the attention whole on every rank of the
    axis. Anything else is returned as it is."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    split = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    n = math.prod(mesh.size(i) for i in split)
    if groups % n == 0 or groups == 1:
        return x
    taken = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                      if p.is_shard(alt))
    movable = x.shape[alt] % (taken * n) == 0
    return _Held.apply(x, tuple(
        (Shard(alt) if movable else Replicate()) if i in split else p
        for i, p in enumerate(x.placements)))


def gather_fsdp(w, x=None):
    """A weight at its use: a ``DTensor`` under a current mesh is gathered
    over the mesh axes that shard the batch (its FSDP split), its
    tensor-parallel split kept, as GSPMD gathers an FSDP weight before a
    contraction; the gather's backward reduce-scatters the gradient. Given
    the activation ``x`` it contracts with (along ``x``'s last dimension),
    only the axes that split ``x`` along another dimension are gathered:
    where the batch is too small to split (a decode of one sequence),
    GSPMD keeps the weight split and sums the partial products, and so
    does the port (:func:`reduce_pending`). Anything else is returned as
    it is. Left to itself, ``DTensor``'s sharding propagation
    takes each op's cheapest placement and may gather the activations
    instead, which runs the contraction whole on every data rank."""
    if not is_distributed(w):
        return w
    from torch.distributed.tensor import Replicate

    batch = get_rules().get("batch") or ()
    batch = batch if isinstance(batch, tuple) else (batch,)
    if x is not None:
        batch = tuple(n for n, p in zip(x.device_mesh.mesh_dim_names,
                                        x.placements)
                      if n in batch and p.is_shard() and p.dim < x.ndim - 1
                      ) if is_dtensor(x) else ()
    target = tuple(Replicate() if name in batch else pl for name, pl in
                   zip(w.device_mesh.mesh_dim_names, w.placements))
    if tuple(w.placements) == target:
        return w
    return w.redistribute(w.device_mesh, target)


@contextlib.contextmanager
def remat_scope():
    """Mark the block as a checkpointed (remat) region: its backward reads
    what its recompute made. Thread-local; a recompute run on autograd's
    thread enters it again."""
    prev = getattr(_state, "remat", False)
    _state.remat = True
    try:
        yield
    finally:
        _state.remat = prev


@dataclasses.dataclass
class _Regather:
    """A saved view of a gathered weight, kept as the weight's shard and
    the view's layout: :meth:`value` gathers the shard again and takes the
    same view of it."""

    shard: Any
    placements: Tuple
    view: Tuple          # (DTensor placements, shape, stride)
    local: Tuple         # the local view's (size, stride, storage offset)

    def value(self):
        from torch.distributed.tensor import DTensor

        with torch.no_grad():
            full = self.shard.redistribute(self.shard.device_mesh,
                                           self.placements)
        pl, shape, stride = self.view
        loc = full._local_tensor.as_strided(*self.local)
        return DTensor.from_local(loc, full.device_mesh, pl, run_check=False,
                                  shape=shape, stride=stride)


def gathered(w, x):
    """``with gathered(w, x) as w:`` — ``w`` at its use with ``x`` for the
    block (:func:`gather_fsdp`). Outside a remat region
    (:func:`remat_scope`) the block's backward does not keep the gathered
    weight: each view of it that an op saves is kept as the shard and
    gathered again where the backward reads it, as GSPMD gathers an FSDP
    weight for the transposed contraction too. In a remat region the
    recompute's gather serves the backward, so nothing changes there.
    Anything but a ``DTensor`` under a current mesh is yielded as it is."""
    if not is_distributed(w):
        return contextlib.nullcontext(w)
    return _gathered(w, x)


@contextlib.contextmanager
def _gathered(w, x):
    full = gather_fsdp(w, x)
    if full is w or getattr(_state, "remat", False) or \
            not torch.is_grad_enabled():
        yield full
        return
    key = full._local_tensor.untyped_storage()._cdata
    target = tuple(full.placements)

    def pack(t):
        if is_dtensor(t) and \
                t._local_tensor.untyped_storage()._cdata == key:
            loc = t._local_tensor
            return _Regather(w, target, (tuple(t.placements), t.shape,
                                         t.stride()),
                             (loc.size(), loc.stride(), loc.storage_offset()))
        return t

    def unpack(t):
        return t.value() if isinstance(t, _Regather) else t

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield full


def named_sharding(*logical_axes: Optional[str]) -> Optional[NamedSharding]:
    mesh = current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, spec(*logical_axes))


# ---------------------------------------------------------------------------
# the dry run's DTensors where the model's code has no sharding rule: each
# helper is the plain computation on plain tensors
# ---------------------------------------------------------------------------


def global_size(x, dim: int, axes) -> int:
    """The size of ``x``'s dimension ``dim`` over the ranks of mesh
    ``axes``: a ``DTensor``'s own (its shape is the global one), a plain
    tensor's (one rank's shard, split over ``axes``) times their sizes."""
    if is_distributed(x):
        return x.shape[dim]
    mesh = current_mesh()
    return x.shape[dim] * math.prod(axis_sizes(mesh)[a] for a in axes)


def on_whole(fn, *args):
    """``fn(*args)``; with a ``DTensor`` among them under a current mesh,
    ``fn`` runs on every argument's whole value on each rank, and its
    result is replicated: a computation with no sharding rule (the
    routing's sort and search, a contraction over local operands) runs
    whole on every rank, as GSPMD replicates it."""
    held = [a for a in args if is_distributed(a)]
    if not held:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = held[0].device_mesh
    out = fn(*(a.full_tensor() if is_distributed(a) else a for a in args))
    return DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard_map(fn, mesh, in_specs, out_spec, *args, partial_over=()):
    """``repro``'s ``shard_map``: ``fn`` on each rank's shards. Plain
    tensors (one process a rank) go to ``fn`` as they are. ``DTensor``s
    are redistributed to their PartitionSpecs in ``in_specs`` and ``fn``
    gets their local shards; its local result is a ``DTensor`` of
    ``out_spec``. An argument replicated over an axis of ``partial_over``
    has a partial gradient on each of its ranks (each rank's body saw its
    own shard of the rows)."""
    if not any(is_distributed(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial

    local = []
    for a, sp in zip(args, in_specs):
        pl = placements(sp, mesh)
        grad = tuple(Partial() if n in partial_over and not p.is_shard() else p
                     for n, p in zip(mesh.mesh_dim_names, pl))
        local.append(a.redistribute(mesh, pl).to_local(grad_placements=grad))
    out = fn(*local)
    if isinstance(out_spec, list):      # one spec for each of fn's results
        return tuple(DTensor.from_local(o, mesh, placements(sp, mesh),
                                        run_check=False)
                     for o, sp in zip(out, out_spec))
    return DTensor.from_local(out, mesh, placements(out_spec, mesh),
                              run_check=False)


def on_shards(fn, in_axes, out_axes, *args):
    """``fn(*args)``; on the dry run's ``DTensor``s, ``fn`` runs on each
    rank's shards (:func:`shard_map`) with each argument split by the rules
    for its logical axes ``in_axes`` (one tuple an argument) and its result
    by ``out_axes`` (a tuple; a list of them, one a result, where ``fn``
    returns several), as GSPMD runs a computation split along the
    dimensions every operand shares (a scan's batch and heads). An argument
    replicated over a mesh axis gets its gradient summed over it. Where a
    split does not divide its dimension, ``fn`` runs on the ``DTensor``s
    as they are."""
    if not any(is_distributed(a) for a in args):
        return fn(*args)
    mesh = current_mesh()
    sizes = axis_sizes(mesh)
    in_specs = [spec(*ax) for ax in in_axes]
    for a, sp in zip(args, in_specs):
        for n, e in zip(a.shape, sp):
            if e is not None and n % math.prod(
                    sizes[m] for m in (e if isinstance(e, tuple) else (e,))):
                return fn(*args)
    out_specs = ([spec(*ax) for ax in out_axes]
                 if isinstance(out_axes, list) else spec(*out_axes))
    return shard_map(fn, mesh, in_specs, out_specs, *args,
                     partial_over=tuple(mesh.mesh_dim_names))


def lookup(table, ids):
    """``table[ids]``. A ``DTensor`` table split along its rows (the
    vocabulary) is looked up as Megatron's vocab-parallel embedding: each
    rank looks its ids up in its slice, zero where an id is another
    slice's, and the rows are a partial sum over the vocabulary's mesh
    dims. ``DTensor``'s own rules for indexing differ between torch
    releases."""
    if not is_distributed(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    tok = ids.redistribute(mesh, [Replicate() if i in vocab else p
                                  for i, p in enumerate(ids.placements)])
    # the table's gradient from this rank's ids is a partial sum over the
    # mesh dims that split the ids (the batch)
    t = table.to_local(grad_placements=[
        Partial() if p.is_replicate() and tp.is_shard() else p
        for p, tp in zip(table.placements, tok.placements)])
    lo = 0
    for i in vocab:     # the first vocabulary mesh dim is the major one
        lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    local = tok.to_local().to(torch.int64) - lo * t.shape[0]
    hit = (local >= 0) & (local < t.shape[0])
    rows = torch.nn.functional.embedding(torch.where(hit, local, 0), t)
    return DTensor.from_local(
        rows * hit[..., None].to(t.dtype), mesh,
        [Partial() if i in vocab else p for i, p in enumerate(tok.placements)],
        run_check=False)


def xent_sum(logits, labels):
    """Σ (logsumexp − gold logit) over the last axis of float32 ``logits``.
    On a ``DTensor`` split along that axis (the vocabulary), where a gather
    has no sharding rule, the max, the sum of exponentials and the gold
    logit (a masked sum) each reduce over the shards."""
    if not is_distributed(logits):
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return (logz - gold).sum()
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    # each product's and sum's cotangent held to its split: a sum's
    # backward hands back a whole (expanded) cotangent, which DTensor would
    # otherwise meet by gathering the product's other operand
    def held(t):
        return _Held.apply(t, tuple(t.placements))

    m = logits.amax(dim=-1, keepdim=True).detach()   # cancels in the gradient
    logz = torch.log(reduce_pending(held(torch.exp(logits - m)).sum(dim=-1)))
    logz = logz + m[..., 0]
    # the vocabulary ids, split as the logits' vocabulary is (no transfer)
    last = logits.ndim - 1
    vocab = distribute_tensor(
        torch.arange(logits.shape[-1], device=logits.device),
        logits.device_mesh,
        [Shard(0) if p.is_shard(last) else Replicate()
         for p in logits.placements], src_data_rank=None)
    gold = reduce_pending(held(logits * (vocab == labels[..., None])).sum(-1))
    return (logz - gold).sum()


def blocks(x, n: int, size: int):
    """Slices of ``n`` positions, ``size`` at a time, for a loop that
    bounds its temporaries; one slice of all of them for a ``DTensor``
    (sharded already, and its slices of a split dim have no rule)."""
    if is_distributed(x):
        return [slice(None)]
    return [slice(i, i + size) for i in range(0, n, size)]
