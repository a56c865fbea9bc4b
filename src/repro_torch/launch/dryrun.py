"""Multi-pod dry run: run every (arch × shape × mesh) cell's step on
``meta`` tensors over a 256 / 512-rank ``DeviceMesh``, and count it.

Counterpart of ``repro.launch.dryrun``. ``repro`` forces 512 host devices
through ``XLA_FLAGS`` before JAX starts, lowers and compiles each cell with
explicit FSDP + TP shardings and reads the compiled program's costs. The
port forms the world in one process instead: :func:`fake_world` is an
n-rank world on torch's fake process group, as its rank 0, whose
collectives return at once and move nothing. Per cell:

* the model is built on ``meta`` (:func:`repro_torch.models.registry.param_specs`)
  and its parameters become ``DTensor``s with ``repro``'s placements
  (:func:`repro_torch.launch.mesh.param_shardings`), as do the optimizer
  state, the batch and the decode state (``batch_shardings``,
  ``cache_shardings``);
* one step runs: train = loss, backward, optimizer step (with ``repro``'s
  microbatching, bf16 gradient accumulation), serve = prefill or one
  decode step. ``DTensor``'s sharding propagation inserts the collectives,
  the eager counterpart of GSPMD, with the placements made explicit where
  its cheapest choice would run a product whole on every rank of an axis
  (:mod:`repro_torch.models.sharding`); constants the model makes itself (rope
  tables, masks) are replicated (``implicit_replication``); a reshape that
  would split a sharded dimension unevenly (8 KV heads on a 16-way
  "model" axis) gathers that dimension first, where GSPMD would reshard;
* :class:`~repro_torch.launch.roofline.CostCounter` counts rank 0's
  flops, bytes, collectives and temp bytes; the argument and output bytes
  are rank 0's shards.

Under ``--dot-partition`` every ``dense`` contraction runs through the
substrate's ``Partitioning`` (data-parallel M over "data",
reduce-scattered K over "model"): the mesh path for ``approx_stat``. The
hand-written kernels refuse ``meta`` tensors, so the dry run runs
``exact`` (the default) or ``approx_stat``.

Usage::

  python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k \\
      [--multi-pod] [--out results.json] [--dot-mode exact] [--dot-partition]
  python -m repro_torch.launch.dryrun --all --both-meshes [--out results.json]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline
from repro_torch.models import registry as reg
from repro_torch.models import sharding as sh
from repro_torch.nn import substrate as psub
from repro_torch.optim import adafactor, adamw

#: the fixed learning rate of the counted step (``repro``'s)
LR = 1e-4


@contextlib.contextmanager
def fake_world(n: int):
    """An ``n``-rank world on torch's fake process group, this process its
    rank 0: collectives return at once and move no data. Refuses when a
    default group exists; destroys its groups on exit."""
    if dist.is_initialized():
        raise RuntimeError(
            f"fake_world({n}): a process group exists already (backend "
            f"{dist.get_backend()!r}, {dist.get_world_size()} ranks)")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _world(n: int):
    """The world the cell needs: the current one, else a fake one."""
    if dist.is_initialized():
        yield
    else:
        with fake_world(n):
            yield


class _ReshardViews(TorchDispatchMode):
    """A view of a ``DTensor`` that would split a sharded dimension where
    its shards do not line up (8 KV heads, 128 wide, from a 1024-wide
    dimension split 16 ways) has no ``DTensor`` rule, and some views of a
    shard whose local strides or sizes differ from the global ones fail
    locally; GSPMD reshards there. This copies such a shard contiguous,
    then gathers the input's sharded mesh dimensions, innermost first,
    until the view goes through, and counts each such gather. It
    sits above :class:`~repro_torch.launch.roofline.CostCounter`, which
    counts the gathers' collectives, in the forward, the backward and a
    checkpointed layer's recompute alike."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor, Replicate

        self._dtensor, self._replicate = DTensor, Replicate
        self._views = {torch.ops.aten.view.default,
                       torch.ops.aten._unsafe_view.default}
        self.gathers = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self._views or not isinstance(args[0], self._dtensor):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            # its message only: the exception's traceback (and its context's)
            # would hold this frame and its tensors in a reference cycle
            # until the garbage collector runs
            err = str(e)
        x = args[0]
        pl = list(x.placements)
        for i in [None] + list(reversed(range(len(pl)))):
            if i is not None:
                if not pl[i].is_shard():
                    continue
                pl[i] = self._replicate()
                self.gathers += 1
                x = x.redistribute(x.device_mesh, pl)
            try:
                return func(x, *args[1:], **kwargs)
            except RuntimeError:
                pass
            # a local shard whose strides differ from the global view's:
            # copy it, as a reshape would
            try:
                return func(x.clone(memory_format=torch.contiguous_format),
                            *args[1:], **kwargs)
            except RuntimeError:
                pass
        raise RuntimeError(err)


def _to_dtensor(t: torch.Tensor, ns: sh.NamedSharding):
    """A ``meta`` tensor as a ``DTensor`` of rank 0's shard."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(ns.shard_shape(t.shape), dtype=t.dtype, device="meta")
    return DTensor.from_local(local, ns.mesh, ns.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute(tree, shardings):
    """Every tensor of ``tree`` (dicts, lists, tuples) as its ``DTensor``;
    a module's parameters are replaced in place."""
    if isinstance(tree, torch.nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner)
            mod._parameters[leaf] = torch.nn.Parameter(
                _to_dtensor(p.data, shardings[name]),
                requires_grad=p.requires_grad)
        return tree
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s) for v, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor):
        return _to_dtensor(tree, shardings)
    return tree


def local_bytes(tree) -> int:
    """Rank 0's bytes of a tree of tensors (a ``DTensor``: its shard)."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if sh.is_dtensor(tree) else tree
        return t.numel() * t.element_size()
    return 0


def _microbatch(x, i: int, accum: int):
    """Microbatch ``i`` of ``accum`` along the batch: a plain tensor's
    ``i``-th block of rows (``repro``'s ``dynamic_slice``); a ``DTensor``'s
    is each rank's ``i``-th block of its own rows, so no rank's rows move."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    if not sh.is_dtensor(x):
        n = x.shape[0] // accum
        return x[i * n:(i + 1) * n]
    from torch.distributed.tensor import DTensor

    loc = x.to_local()
    n = loc.shape[0] // accum
    return DTensor.from_local(loc[i * n:(i + 1) * n], x.device_mesh,
                              x.placements, run_check=False)


def make_train_step(bundle: reg.ModelBundle, optimizer, accum: int = 1,
                    lr: float = LR):
    """Train step ``(params, opt_state, batch) -> (loss, params,
    opt_state)``: the loss and its gradient (``accum`` > 1 microbatches the
    batch, the gradients summed in bf16, ``repro``'s production trade-off
    for trillion-parameter configs), then the optimizer's in-place update at
    a fixed learning rate (a schedule would read the step on the host)."""
    def grads_of(params, names, batch):
        loss = bundle.loss_fn(params, batch)
        return loss, torch.autograd.grad(loss, [params.get_parameter(n)
                                                for n in names])

    def train_step(params, opt_state, batch):
        names = [n for n, _ in params.named_parameters()]
        params.requires_grad_(True)
        try:
            if accum == 1:
                loss, grads = grads_of(params, names, batch)
            else:
                loss = None
                grads = [torch.zeros_like(params.get_parameter(n),
                                          dtype=torch.bfloat16) for n in names]
                for i in range(accum):
                    mb = {k: _microbatch(v, i, accum) for k, v in batch.items()}
                    l, g = grads_of(params, names, mb)
                    loss = l / accum if loss is None else loss + l / accum
                    grads = [(a.to(torch.float32) + b.to(torch.float32) / accum
                              ).to(a.dtype) for a, b in zip(grads, g)]
        finally:
            params.requires_grad_(False)
        named = dict(params.named_parameters())
        optimizer.update(dict(zip(names, grads)), opt_state, named, lr)
        return loss.detach(), params, opt_state
    return train_step


def pick_optimizer(bundle: reg.ModelBundle):
    """Factored moments (Adafactor on ``repro``'s stacked tree) for the MoE
    configs, AdamW for the rest, as ``repro``'s launcher chooses."""
    return adafactor(bundle.layout) if bundle.cfg.n_experts else adamw()


def train_accum(cfg, shape: reg.ShapeSpec, data_ranks: int) -> int:
    """``repro``'s microbatch count (8; 32 above 3e11 parameters, for a
    global batch of at least 8 rows a microbatch), at most one row a
    microbatch on each data rank."""
    accum = 1
    for cand in (32, 16, 8):
        if shape.global_batch % cand == 0 and shape.global_batch // cand >= 8:
            accum = cand if cfg.param_count() > 3e11 else 8
            break
    while accum > 1 and (shape.global_batch // data_ranks) % accum:
        accum //= 2
    return accum


def production_accum(cfg, shape: reg.ShapeSpec, mesh) -> int:
    """The microbatch count of a cell's step: :func:`train_accum` on the
    mesh's data ranks for training, else 1."""
    if shape.kind != "train":
        return 1
    sizes = sh.axis_sizes(mesh)
    data = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    return train_accum(cfg, shape, data)


@dataclasses.dataclass
class Cell:
    """One counted step: its counts, rank 0's argument and output bytes,
    the parameters measured, the seconds to set up and to run, and the
    reshape gathers inserted."""
    counts: Dict[str, Any]
    argument_bytes: int
    output_bytes: int
    params: int
    setup_s: float
    step_s: float
    gathers: int


def count_step(cfg, shape: reg.ShapeSpec, mesh=None, *, part=None,
               accum: int = 1, fsdp: bool = True, cache_shard: str = "auto",
               device="meta", seed: int = 0) -> Cell:
    """Run and count one step of ``cfg`` at ``shape``.

    With a ``mesh`` every tensor is a ``meta`` ``DTensor`` with its
    shardings; without, the step runs on one device's plain tensors:
    ``meta`` (the 1-device dry run), or a real device, whose parameters are
    drawn from ``seed`` and whose tokens are random, which counts what that
    device runs."""
    t0 = time.time()
    bundle = reg.build_bundle(cfg)
    dev = torch.device(device)
    if dev.type == "meta":
        params = reg.param_specs(bundle)
    else:
        params = bundle.init_params(torch.Generator(dev).manual_seed(seed), dev)
    measured = sum(p.numel() for p in params.parameters())
    batch = reg.input_specs(cfg, shape)
    if dev.type != "meta":
        gen = torch.Generator(dev).manual_seed(seed + 1)
        batch = {k: (torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                   dtype=v.dtype, device=dev)
                     if not v.dtype.is_floating_point else
                     torch.randn(v.shape, generator=gen, device=dev).to(v.dtype))
                 for k, v in batch.items()}
    state = opt_state = optimizer = None
    if shape.kind == "train":
        optimizer = pick_optimizer(bundle)
        opt_state = optimizer.init(dict(params.named_parameters()))
    elif shape.kind == "decode":
        state = bundle.init_decode_state(shape.global_batch, shape.seq_len,
                                         device=dev)
    if mesh is not None:
        distribute(params, mesh_lib.param_shardings(params, mesh, fsdp=fsdp))
        batch = distribute(batch, mesh_lib.batch_shardings(batch, mesh))
        if opt_state is not None:
            opt_state = distribute(opt_state, mesh_lib.param_shardings(
                opt_state, mesh, fsdp=fsdp))
        if state is not None:
            state = distribute(state, mesh_lib.cache_shardings(
                state, mesh, cache_shard=cache_shard,
                stacks=reg.decode_state_stacks(cfg, state)))
    if shape.kind == "decode":
        batch = dict(batch, cache_len=shape.seq_len - 1)   # a host integer
    args = {"train": (params, opt_state, batch), "prefill": (params, batch),
            "decode": (params, state, batch)}[shape.kind]
    arg_bytes = local_bytes(args)
    setup_s = time.time() - t0

    if shape.kind == "train":
        step = make_train_step(bundle, optimizer, accum=accum)
    elif shape.kind == "prefill":
        step = torch.no_grad()(bundle.prefill)
    else:
        step = torch.no_grad()(bundle.decode_step)
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            from torch.distributed.tensor.experimental import (
                implicit_replication)

            stack.enter_context(implicit_replication())
        stack.enter_context(sh.mesh_scope(mesh))
        stack.enter_context(psub.partitioning_scope(part))
        counter = stack.enter_context(roofline.CostCounter(dev.type))
        if mesh is not None:
            views = stack.enter_context(_ReshardViews())
        out = step(*args)
    step_s = time.time() - t0
    return Cell(counter.result(), arg_bytes, local_bytes(out), measured,
                setup_s, step_s, views.gathers if mesh is not None else 0)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               dot_mode: str = "exact", dot_partition: bool = False,
               accum: Optional[int] = None, **overrides) -> Dict[str, Any]:
    """Count one (arch × shape × mesh) cell at full depth: ``repro``'s
    row, its ``memory`` rank 0's argument, output and temp bytes (no
    generated code), ``step_s`` the step's seconds in place of
    ``compile_s``."""
    shape = reg.SHAPES[shape_name]
    cfg = reg.get_config(arch, dot_plan=dot_mode, **overrides)
    with _world(512 if multi_pod else 256):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        n_dev = mesh.size()
        part = mesh_lib.contraction_partitioning(mesh) if dot_partition else None
        if accum is None:
            accum = production_accum(cfg, shape, mesh)
        cell = count_step(cfg, shape, mesh, part=part, accum=accum)
    # measured active params: measured total minus the formula's
    # (total − active) expert surplus
    n_active = cell.params - (cfg.param_count() - cfg.active_param_count())
    rf = roofline.derive(cell.counts, n_dev,
                         roofline.model_flops_for(cfg, shape, n_active=n_active))
    return dict(
        arch=arch, shape=shape_name,
        mesh="2x16x16" if multi_pod else "16x16",
        n_devices=n_dev, kind=shape.kind, dot_mode=dot_mode,
        dot_partition=dot_partition, accum=accum,
        params=cell.params, active_params=n_active,
        flops_per_device=rf.flops_per_device,
        bytes_per_device=rf.bytes_per_device,
        collective_bytes=rf.collective_bytes,
        collective_breakdown=cell.counts["coll_by"],
        collective_counts=cell.counts["coll_counts"],
        model_flops=rf.model_flops,
        memory=dict(argument_size_in_bytes=cell.argument_bytes,
                    output_size_in_bytes=cell.output_bytes,
                    temp_size_in_bytes=cell.counts["temp"],
                    generated_code_size_in_bytes=None),
        reshard_gathers=cell.gathers,
        setup_s=round(cell.setup_s, 1), step_s=round(cell.step_s, 1),
        **rf.row(),
    )


def run_cells(cells, out_path: str, dot_mode: str = "exact",
              dot_partition: bool = False, lower=None):
    """Count each cell with ``lower`` (default :func:`lower_cell`); a
    failure is recorded and the sweep goes on. Cells already in
    ``out_path`` are skipped."""
    lower = lower or lower_cell
    results = []
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("dot_mode", "exact"),
             r.get("dot_partition", False))
            for r in results if r.get("ok", True)}
    for arch, shape_name, multi_pod in cells:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        key = (arch, shape_name, mesh_name, dot_mode, dot_partition)
        if key in done:
            print(f"[skip] {key}")
            continue
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name} ...", flush=True)
        try:
            r = lower(arch, shape_name, multi_pod, dot_mode=dot_mode,
                      dot_partition=dot_partition)
            r["ok"] = True
            print(f"  ok: flops/dev={r['flops_per_device']:.3e} "
                  f"coll={r['collective_bytes']:.3e}B "
                  f"bottleneck={r['bottleneck']} "
                  f"step={r['step_s']}s", flush=True)
        except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
            r = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                     dot_mode=dot_mode, ok=False,
                     error=f"{type(e).__name__}: {e}"[:2000],
                     traceback=traceback.format_exc()[-2000:])
            print(f"  FAIL: {r['error'][:300]}", flush=True)
        results.append(r)
        if out_path:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1, default=str)
    return results


def all_cells(multi_pod: bool):
    cells = []
    for arch in reg.list_archs():
        if arch == "edge-detect":
            continue
        for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if shape_name == "long_500k" and arch not in reg.SUBQUADRATIC:
                continue
            cells.append((arch, shape_name, multi_pod))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default="train_4k", choices=list(reg.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every (arch × shape)")
    ap.add_argument("--out", default="")
    ap.add_argument("--dot-mode", default="exact")
    ap.add_argument("--dot-partition", action="store_true",
                    help="run substrate contractions through the substrate's "
                         "Partitioning (data-parallel M over 'data', "
                         "reduce-scattered K over 'model')")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells(multi_pod=args.multi_pod)
        if args.both_meshes:
            cells = all_cells(False) + all_cells(True)
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        cells = [(args.arch, args.shape, args.multi_pod)]
        if args.both_meshes:
            cells = [(args.arch, args.shape, False), (args.arch, args.shape, True)]
    results = run_cells(cells, args.out, dot_mode=args.dot_mode,
                        dot_partition=args.dot_partition)
    ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{ok}/{len(results)} cells ok")
    if not args.out:
        print(json.dumps(results[-1], indent=2, default=str))
    return results


if __name__ == "__main__":
    main()
