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
    held to the result's placements. Inside :func:`reduce_onto` the sum
    lands on the placements of its tensor (the residual stream): where
    that is split along a dimension over the axis (vlm's stream, split
    along its features), it is reduce-scattered there, and its cotangent
    gathered in the backward.
    The cotangent of a tensor that :func:`gather_last` gathered is
    reduce-scattered back onto its split. Anything else is returned as it
    is."""
    if not is_distributed(x):
        return x
    split = getattr(x, "_split_placements", None)
    if split is not None:
        return _GradOn.apply(x, split)
    from torch.distributed.tensor import Replicate

    like = getattr(_state, "onto", None)
    lp = like.placements if is_distributed(like) \
        else (None,) * x.device_mesh.ndim
    return _Held.apply(x, tuple(
        (q if q is not None and q.is_shard() and q.dim < x.ndim
         else Replicate()) if p.is_partial() else p
        for p, q in zip(x.placements, lp)))


def is_split(x, dim: int) -> bool:
    """Whether ``x`` is a ``DTensor`` under a current mesh split along
    ``dim`` (a long sequence's cache, split along its positions)."""
    return is_distributed(x) and any(p.is_shard(dim % x.ndim)
                                     for p in x.placements)


@contextlib.contextmanager
def reduce_onto(like):
    """Inside the block, :func:`reduce_pending` sums a contraction's
    pending result onto ``like``'s placements (the residual stream a
    row-parallel projection is added to). Thread-local."""
    prev = getattr(_state, "onto", None)
    _state.onto = like
    try:
        yield
    finally:
        _state.onto = prev


def gather_last(x):
    """``x`` split along its last dimension (vlm's residual stream, split
    along its features) gathered once for the products that read it, as
    GSPMD gathers it before them; each product's cotangent is
    reduce-scattered back onto the split (:func:`reduce_pending`), as
    GSPMD does each transposed dot's. Anything else is returned as it
    is."""
    if not is_split(x, -1):
        return x
    from torch.distributed.tensor import Replicate

    y = x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(x.ndim - 1) else p for p in x.placements])
    y._split_placements = tuple(x.placements)
    return y


class _GradOn(torch.autograd.Function):
    """The identity, whose cotangent is put on ``target`` (None: its
    pending sums reduced, its splits kept)."""

    @staticmethod
    def forward(ctx, t, target):
        ctx.target = target
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if not is_dtensor(g):
            return g, None
        from torch.distributed.tensor import Replicate

        target = ctx.target or [Replicate() if p.is_partial() else p
                                for p in g.placements]
        return g.redistribute(g.device_mesh, target), None


def reduce_grad(w):
    """``w`` (a replicated parameter: a norm's scale) as it is; on the dry
    run's mesh its gradient's pending sums over the batch are reduced on
    each rank's slice of it before anything gathers the slices, as GSPMD
    reduces the statistic (``DTensor`` would gather first and reduce the
    whole of it)."""
    if not is_distributed(w):
        return w
    return _GradOn.apply(w, None)


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
def remat_scope(recompute: bool = False):
    """Mark the block as a checkpointed (remat) region: its backward reads
    what its recompute made; ``recompute`` marks the backward's run of it
    (:func:`recomputing`). Thread-local; a recompute run on autograd's
    thread enters it again."""
    prev = getattr(_state, "remat", False), getattr(_state, "recompute", False)
    _state.remat, _state.recompute = True, recompute
    try:
        yield
    finally:
        _state.remat, _state.recompute = prev


def recomputing() -> bool:
    """Whether a checkpointed region is being recomputed for the
    backward."""
    return getattr(_state, "recompute", False)


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


# ---------------------------------------------------------------------------
# GSPMD's own movements of a split dimension, made explicit: blocks moved
# between ranks by collective-permutes, pieces regrouped by all-to-alls
# through the batch, a position-split cache brought to every rank block by
# block. Each helper is the plain computation on plain tensors.
# ---------------------------------------------------------------------------


def _c10d(op: str, *args):
    """Functional collective ``op`` on local tensors, waited for."""
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(getattr(ops, op)(*args))


def permute(t, dim: int, to, frm, size: int, mesh, axis: int):
    """One collective-permute of local tensors over mesh dim ``axis``: this
    rank's ``t`` goes to rank ``to`` of the axis (None: it sends nothing),
    and ``size`` slices along ``dim`` come from rank ``frm`` (None:
    nothing comes, and the result is empty along ``dim``). Issued as an
    ``all_to_all_single`` with one non-zero split a side, which the
    counter reads as a permute
    (:func:`repro_torch.launch.roofline.kind_of`)."""
    n = mesh.size(axis)
    rows = t.movedim(dim, 0)
    send, recv = [0] * n, [0] * n
    if to is None:
        rows = rows[:0]
    else:
        send[to] = rows.shape[0]
    if frm is not None:
        recv[frm] = size
    return _c10d("all_to_all_single", rows.contiguous(), recv, send,
                 mesh.get_group(axis).group_name).movedim(0, dim)


def all_to_all(t, split_dim: int, concat_dim: int, mesh, axis: int):
    """``jax.lax.all_to_all`` of local tensors over mesh dim ``axis``:
    ``t``'s equal chunks along ``split_dim`` go to the ranks in order, and
    the chunks received are concatenated along ``concat_dim`` in rank
    order."""
    n = mesh.size(axis)
    rows = torch.stack(t.chunk(n, split_dim)).contiguous()
    out = _c10d("all_to_all_single", rows, [1] * n, [1] * n,
                mesh.get_group(axis).group_name)
    return torch.cat(out.unbind(0), concat_dim)


def _moves(total: int, n: int, pieces):
    """A dimension of ``total`` in ``n`` equal blocks, one a rank, and its
    ``pieces`` ``(offset, size)``, each to be split in ``n`` equal blocks of
    its own: the moves, ``(piece, shift, {rank: (lo, hi)})``, each range
    (the dimension's coordinates) going from ``rank`` to ``rank + shift``;
    shift 0 stays in place, every other is one collective-permute."""
    w = total // n
    out = []
    for i, (o, size) in enumerate(pieces):
        b = size // n
        for k in range(n):
            pairs = {}
            for q in range(n):
                t = (q + k) % n
                lo = max(q * w, o + t * b)
                hi = min((q + 1) * w, o + (t + 1) * b)
                if lo < hi:
                    pairs[q] = (lo, hi)
            if pairs:
                out.append((i, k, pairs))
    return out


def _empty(t, dim: int):
    return t.narrow(dim, 0, 0)


def _to_pieces(loc, dim: int, total: int, pieces, mesh, axis: int):
    """This rank's block of a dimension (``loc``) → its block of each
    piece, by the moves of :func:`_moves`."""
    n, r = mesh.size(axis), mesh.get_local_rank(axis)
    w = total // n
    got = [[] for _ in pieces]
    for i, k, pairs in _moves(total, n, pieces):
        mine, src = pairs.get(r), (r - k) % n
        part = loc.narrow(dim, mine[0] - r * w, mine[1] - mine[0]) \
            if mine else _empty(loc, dim)
        if k == 0:
            if mine:
                got[i].append((mine[0], part))
            continue
        frm = pairs.get(src)
        out = permute(part, dim, (r + k) % n if mine else None,
                      src if frm else None, frm[1] - frm[0] if frm else 0,
                      mesh, axis)
        if frm:
            got[i].append((frm[0], out))
    return [torch.cat([t for _, t in sorted(g, key=lambda e: e[0])], dim)
            for g in got]


def _from_pieces(locs, dim: int, total: int, pieces, mesh, axis: int):
    """The transpose of :func:`_to_pieces`: each moved range goes back by
    the inverse permute."""
    n, r = mesh.size(axis), mesh.get_local_rank(axis)
    back = []
    for i, k, pairs in _moves(total, n, pieces):
        base = pieces[i][0] + r * (pieces[i][1] // n)
        mine, held = pairs.get(r), pairs.get((r - k) % n)
        if k == 0:
            if mine:
                back.append((mine[0], locs[i].narrow(
                    dim, mine[0] - base, mine[1] - mine[0])))
            continue
        part = locs[i].narrow(dim, held[0] - base, held[1] - held[0]) \
            if held else _empty(locs[i], dim)
        out = permute(part, dim, (r - k) % n if held else None,
                      (r + k) % n if mine else None,
                      mine[1] - mine[0] if mine else 0, mesh, axis)
        if mine:
            back.append((mine[0], out))
    return torch.cat([t for _, t in sorted(back, key=lambda e: e[0])], dim)


def _cat_through(locs, dim: int, alt: int, mesh, axis: int):
    """Pieces' local blocks along ``dim`` → the local block of their
    concatenation: each piece's split moved to ``alt`` by an all-to-all,
    the pieces concatenated whole, the split moved back by another."""
    whole = [all_to_all(t, alt, dim, mesh, axis) for t in locs]
    return all_to_all(torch.cat(whole, dim), dim, alt, mesh, axis)


def _as_dtensor(local, mesh, placements, shape):
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for d in reversed(shape):
        stride.insert(0, acc)
        acc *= d
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _held_local(g, mesh, placements, like):
    """A cotangent's local shard on ``placements``; zeros shaped as the
    ``(shape, dtype, device)`` ``like`` for None."""
    if g is None:
        return torch.zeros(like[0], dtype=like[1], device=like[2])
    return g.redistribute(mesh, placements)._local_tensor


class _Pieces(torch.autograd.Function):
    """A ``DTensor`` split along ``dim`` over mesh dim ``axis`` → its
    ``pieces``, each split the same way, by collective-permutes. The
    backward concatenates the cotangents by all-to-alls through ``alt``
    (``jnp.split``'s transpose, a concatenate), or with ``alt`` None
    moves them back by the inverse permutes (separate slices' transposes,
    pads)."""

    @staticmethod
    def forward(ctx, x, dim, pieces, axis, alt):
        mesh, pl = x.device_mesh, tuple(x.placements)
        locs = _to_pieces(x._local_tensor, dim, x.shape[dim], pieces, mesh,
                          axis)
        ctx.args = (mesh, pl, tuple(x.shape), dim, pieces, axis, alt,
                    [(t.shape, t.dtype, t.device) for t in locs])
        return tuple(_as_dtensor(loc, mesh, pl, x.shape[:dim] + (size,)
                                 + x.shape[dim + 1:])
                     for loc, (_, size) in zip(locs, pieces))

    @staticmethod
    def backward(ctx, *gs):
        mesh, pl, shape, dim, pieces, axis, alt, locs = ctx.args
        gl = [_held_local(g, mesh, pl, loc) for g, loc in zip(gs, locs)]
        loc = _cat_through(gl, dim, alt, mesh, axis) if alt is not None \
            else _from_pieces(gl, dim, shape[dim], pieces, mesh, axis)
        return _as_dtensor(loc, mesh, pl, shape), None, None, None, None


class _Cat(torch.autograd.Function):
    """``DTensor`` pieces, each split along ``dim`` over mesh dim ``axis``
    → their concatenation split the same way, by all-to-alls through
    ``alt``; the backward splits the cotangent by collective-permutes."""

    @staticmethod
    def forward(ctx, dim, axis, alt, *xs):
        mesh, pl = xs[0].device_mesh, tuple(xs[0].placements)
        sizes = [x.shape[dim] for x in xs]
        pieces = [(sum(sizes[:i]), size) for i, size in enumerate(sizes)]
        shape = xs[0].shape[:dim] + (sum(sizes),) + xs[0].shape[dim + 1:]
        ctx.args = (mesh, pl, shape, dim, pieces, axis)
        loc = _cat_through([x._local_tensor for x in xs], dim, alt, mesh, axis)
        return _as_dtensor(loc, mesh, pl, shape)

    @staticmethod
    def backward(ctx, g):
        mesh, pl, shape, dim, pieces, axis = ctx.args
        gl = g.redistribute(mesh, pl)._local_tensor
        locs = _to_pieces(gl, dim, shape[dim], pieces, mesh, axis)
        return (None, None, None) + tuple(
            _as_dtensor(loc, mesh, pl, shape[:dim] + (size,) + shape[dim + 1:])
            for loc, (_, size) in zip(locs, pieces))


def _moved_split(x, dim: int, sizes, through: bool):
    """``(mesh dim, alt)`` where pieces of ``sizes`` along ``dim`` of
    ``x`` move as GSPMD moves them: ``x`` a ``DTensor`` under a current
    mesh split along ``dim`` over one mesh dim into equal blocks, each
    piece dividing too, and (``through``) a dimension whose local size the
    mesh dim divides, to regroup through (the batch first); else None."""
    if not is_distributed(x):
        return None
    split = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    if len(split) != 1:
        return None
    axis = split[0]
    n = x.device_mesh.size(axis)
    if x.shape[dim] % n or any(size % n for size in sizes) \
            or sum(sizes) != x.shape[dim]:
        return None
    if not through:
        return axis, None
    local = x._local_tensor.shape
    alt = next((d for d in range(x.ndim)
                if d != dim and local[d] and local[d] % n == 0), None)
    return None if alt is None else (axis, alt)


def split(x, sizes, dim: int):
    """``torch.split(x, sizes, dim)``. A ``DTensor`` under a current mesh
    split along ``dim`` (a projection's output features) has each piece
    split the same way, as GSPMD splits ``jnp.split``'s pieces: every
    block brought to its rank by collective-permutes, and the cotangents
    concatenated back by all-to-alls through the batch (the concatenate
    that transposes the split; by the inverse permutes where the batch does
    not divide). ``DTensor`` would gather the whole of ``x`` and compute on
    every piece whole on each rank of the axis, and does so where a piece
    does not divide."""
    dim %= x.ndim
    how = _moved_split(x, dim, sizes, through=True) or \
        _moved_split(x, dim, sizes, through=False)
    if how is None:
        return torch.split(x, sizes, dim)
    pieces = [(sum(sizes[:i]), size) for i, size in enumerate(sizes)]
    return _Pieces.apply(x, dim, pieces, how[0], how[1])


def halves(x, half: int):
    """``(x[..., :half], x[..., half:2 * half])``, rope's halves. A
    ``DTensor`` under a current mesh split along its last dimension
    (paligemma's one KV head, split along head_dim) has each half split the
    same way, as GSPMD slices it: the blocks brought to their ranks by
    collective-permutes, the cotangents sent back by the inverse permutes
    (the pads that transpose the slices). Elsewhere the plain slices."""
    dim = x.ndim - 1
    how = _moved_split(x, dim, (half, half), through=False) \
        if 2 * half == x.shape[-1] else None
    if how is None:
        return x[..., :half], x[..., half:2 * half]
    return _Pieces.apply(x, dim, ((0, half), (half, half)), how[0], None)


def cat(xs, dim: int):
    """``torch.cat(xs, dim)``. ``DTensor`` pieces under a current mesh, each
    split along ``dim`` over the same one mesh dim (rope's rotated halves
    after :func:`halves`), are concatenated split the same way, as GSPMD
    concatenates them: each piece's split moved to the batch by an
    all-to-all, the pieces joined, the split moved back by another; the
    cotangent is split by collective-permutes. Elsewhere ``torch.cat``."""
    dim %= xs[0].ndim
    how = [_moved_split(x, dim, (x.shape[dim],), through=True) for x in xs]
    if any(h is None or h != how[0] for h in how) or any(
            tuple(x.placements) != tuple(xs[0].placements) for x in xs):
        return torch.cat(xs, dim)
    return _Cat.apply(dim, how[0][0], how[0][1], *xs)


def gather_local(logical: str, dim: int):
    """A function of a local tensor inside :func:`on_shards`: it gathers
    the tensor along ``dim`` over the mesh axis that the rules give the
    logical axis ``logical``, and its backward reduce-scatters the
    cotangent there. The identity with no mesh current, and on a
    ``DTensor`` (where ``on_shards`` found a split that does not
    divide)."""
    mesh = current_mesh()
    axis = spec(logical)[0] if mesh is not None else None
    if axis is None:
        return lambda t: t
    group = mesh.get_group(axis)
    # a DTensor: on_shards found a split that does not divide
    return lambda t: t if is_dtensor(t) else _Gather.apply(t, dim, group)


def _gather(t, dim: int, group):
    return _c10d("all_gather_into_tensor", t.movedim(dim, 0).contiguous(),
                 group.size(), group.group_name).movedim(0, dim)


def _reduce_scatter(t, dim: int, group):
    return _c10d("reduce_scatter_tensor", t.movedim(dim, 0).contiguous(),
                 "sum", group.size(), group.group_name).movedim(0, dim)


def _all_reduce(t, group):
    return _c10d("all_reduce", t.contiguous(), "sum", group.group_name)


class _Gather(torch.autograd.Function):
    """All-gather of a local tensor along ``dim`` over ``group``; the
    backward reduce-scatters the cotangent."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.args = (dim, group)
        return _gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        return _reduce_scatter(g, dim, group), None, None


def block(x, dim: int, start: int, size: int):
    """``x``'s ``size`` positions from ``start`` along ``dim`` (a block of a
    cache). A ``DTensor`` under a current mesh split along ``dim`` (a long
    sequence's cache, split along its positions) is brought to every rank
    of the axis as GSPMD brings each block of ``repro``'s attention scan: the
    block's parts collective-permuted to the axis' first rank, then summed
    over the axis from there (an all-reduce of the block, zeros on the
    other ranks); its other splits are kept, and no rank holds the whole
    cache. ``DTensor`` would gather the whole of ``x`` for each block. A
    cache is only read, so this has no gradient."""
    split = [i for i, p in enumerate(x.placements) if p.is_shard(dim)] \
        if is_distributed(x) else []
    if len(split) != 1 or x.shape[dim] % x.device_mesh.size(split[0]):
        return x[(slice(None),) * dim + (slice(start, start + size),)]
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("block() of a split tensor has no gradient")
    from torch.distributed.tensor import Replicate

    axis, mesh = split[0], x.device_mesh
    n, r = mesh.size(axis), mesh.get_local_rank(axis)
    w, loc = x.shape[dim] // n, x._local_tensor
    parts = []
    for q in range(n):
        lo, hi = max(start, q * w), min(start + size, (q + 1) * w)
        if lo >= hi:
            continue
        part = loc.narrow(dim, lo - q * w, hi - lo) if r == q else None
        if q:
            part = permute(part if r == q else _empty(loc, dim), dim,
                           0 if r == q else None, q if r == 0 else None,
                           hi - lo, mesh, axis)
        parts.append(part)
    out = torch.cat(parts, dim) if r == 0 else torch.zeros(
        [size if d == dim else s for d, s in enumerate(loc.shape)],
        dtype=loc.dtype, device=loc.device)
    out = _all_reduce(out, mesh.get_group(axis))
    shape = list(x.shape)
    shape[dim] = size
    return _as_dtensor(out, mesh, [Replicate() if i == axis else p
                                   for i, p in enumerate(x.placements)],
                       shape)


class _Psum(torch.autograd.Function):
    """All-reduce (sum) of a local tensor over ``group``; the cotangent is
    summed too (``psum``'s transpose)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Outer(torch.autograd.Function):
    """``e[..., None] * c[..., None, :]`` of local ``e`` (..., H / M) split
    over the heads and ``c`` (..., n / M) split along the state dim, both
    over mesh dim ``axis`` of ``mesh``: the (..., H / M, n) heads split of the
    product, formed as GSPMD forms it. The forward gathers ``e`` and moves
    the product's split from n to the heads by an all-to-all; a
    checkpointed region's recompute (``recompute``) gathers ``c`` instead;
    the backward gathers ``c`` again and reduce-scatters its cotangent.
    Both forms save the same tensors, as a checkpoint's recompute must."""

    @staticmethod
    def forward(ctx, e, c, mesh, axis, recompute):
        ctx.save_for_backward(e, c)
        ctx.group = mesh.get_group(axis)
        if recompute:
            full = _gather(c, c.ndim - 1, ctx.group)
            return e[..., None] * full[..., None, :]
        full = _gather(e, e.ndim - 1, ctx.group)
        return all_to_all(full[..., None] * c[..., None, :], e.ndim - 1,
                          e.ndim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        e, c = ctx.saved_tensors
        full = _gather(c, c.ndim - 1, ctx.group)
        return ((g * full[..., None, :]).sum(-1),
                _reduce_scatter((g * e[..., None]).sum(-2), c.ndim - 1,
                                ctx.group), None, None, None)


def state_split_ops(logical: str, x) -> dict:
    """``mamba_scan``'s ``psum`` and ``outer`` hooks for B and C split along
    the state dim over the mesh axis the rules give ``logical`` (the
    heads'), inside :func:`on_shards`, as GSPMD partitions ``repro``'s SSD:
    the partial C·B scores all-reduced, and ``e[..., None] * c[..., None,
    :]`` (``e`` per head, ``c`` per state element) formed by
    :class:`_Outer`. Empty (the plain products) unless ``x`` (the scan's
    input) is a ``DTensor`` under a current mesh; each hook is the plain
    product on a ``DTensor`` (where ``on_shards`` found a split that does
    not divide)."""
    mesh = current_mesh()
    axis = spec(logical)[0] if is_distributed(x) else None
    if axis is None:
        return {}
    group, dim = mesh.get_group(axis), mesh.mesh_dim_names.index(axis)
    recompute = recomputing()

    def psum(t):
        return t if is_dtensor(t) else _Psum.apply(t, group)

    def outer(e, c):
        if is_dtensor(e):
            return e[..., None] * c[:, :, None, :]
        return _Outer.apply(e, c, mesh, dim, recompute)

    return {"psum": psum, "outer": outer}
