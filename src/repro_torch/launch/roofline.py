"""Roofline terms of one dry-run step, for an NVIDIA H100.

Counterpart of ``repro.launch.roofline``. Three terms, per (arch × shape ×
mesh), in seconds, each a lower bound from the card's data-sheet peak:

  compute    = flops_per_device / PEAK_FLOPS        (989e12, dense bf16)
  memory     = bytes_per_device / HBM_BW            (3.35e12 B/s)
  collective = collective_bytes_per_device / LINK_BW  (450e9 B/s)

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W power
limit: dense bf16 tensor-core FLOP/s, HBM3 bytes/s, and NVLink bytes/s each
way from one card to the other cards of its host. A mesh larger than one
host's 8 cards crosses the hosts' network, for which the repo has no
figure: there the collective term is a lower bound only. These are
estimates; what the card reaches is measured by ``chip_smoke.py``'s
``roofline_path``.

``repro`` reads its terms from the compiled program (``cost_analysis``
and the collectives of the HLO text). The port has no compiled program:
:class:`CostCounter`, a ``TorchDispatchMode``, watches one rank's step as
it runs (on ``meta`` tensors in the dry run, on the card's in the smoke)
and counts

* **flops** by ``torch.utils.flop_counter``'s formulas: matmuls,
  convolutions and attention products, the tensor-core work. XLA counts
  every op's flops, so the port's ``useful_ratio`` is not comparable with
  ``repro``'s;
* **bytes**: each op's input and output bytes (views move none), the
  counterpart of XLA's "bytes accessed", which prices a collective the
  same way: its input (a shard, say) read and its output written;
* **collectives** by ``repro``'s five kinds, summing output bytes as its
  HLO parse does, and output elements (a count that does not depend on
  the dtype a backend moves them in): the ``_c10d_functional`` ops that
  ``DTensor`` issues and the ``c10d`` ops that
  :mod:`repro_torch.nn.collectives` issues;
* **temp bytes**: the peak of the bytes the step allocated and still
  holds (its arguments excluded), ``memory_analysis``'s temp size. The
  garbage collector is off while the counter is active: a storage that a
  reference cycle holds is freed when the collector happens to run, and
  the peak moved with it from one run to the next.

Eager execution counts every loop iteration, so ``repro``'s
``cost_unroll`` switch has no counterpart.
"""
from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Dict, Optional

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet, 700 W (per card)
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, NVLink, each way, within one host

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: op name (namespace.name) -> collective kind
_KIND = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}
#: the in-place ``c10d`` ops' (input, output) argument positions: a
#: separate input, or the output read and written in place; ``send`` has
#: no output and ``recv_`` no input. The functional ops read ``args[0]``
#: and write their result.
_C10D_IO = {"c10d.allgather_": (1, 0), "c10d._allgather_base_": (1, 0),
            "c10d.allgather_coalesced_": (1, 0),
            "c10d.allgather_into_tensor_coalesced_": (1, 0),
            "c10d.reduce_scatter_": (1, 0),
            "c10d._reduce_scatter_base_": (1, 0),
            "c10d.alltoall_": (1, 0), "c10d.alltoall_base_": (1, 0),
            "c10d.allreduce_": (0, 0), "c10d.allreduce_coalesced_": (0, 0),
            "c10d.send": (0, None), "c10d.recv_": (None, 0)}
#: collective bookkeeping ops: no data of their own
_SILENT = {"_c10d_functional.wait_tensor",
           "_c10d_functional._wrap_tensor_autograd", "c10d.barrier"}
#: allocation without reading or writing data
_ALLOC = {"aten.empty", "aten.empty_strided", "aten.empty_like",
          "aten.new_empty", "aten.new_empty_strided"}


def _tensor_bytes(dtype: torch.dtype, shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _numel(x) -> int:
    return sum(t.numel() for t in _tensors(x))


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]
    elements_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in _COLLECTIVES})

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


class CostCounter(TorchDispatchMode):
    """Counts one rank's flops, bytes, collectives and temp bytes while
    active (``with CostCounter() as c: step()``).

    It sees the ops a rank runs: a ``DTensor`` op is let through to
    ``DTensor`` (``NotImplemented``), which runs the local ops and
    collectives that come back here; the ops ``DTensor`` runs on fake
    tensors to propagate shapes are not counted. Given the step's
    ``device`` type, an op with no tensor there is not counted either:
    ``DTensor`` computes shard sizes and offsets with small host tensors,
    and more of them the first time it meets a sharding than later.
    """

    def __init__(self, device: Optional[str] = None):
        super().__init__()
        self._device = device
        from torch._subclasses.fake_tensor import FakeTensor

        self._fake = FakeTensor
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll = CollectiveStats({k: 0 for k in _COLLECTIVES},
                                    {k: 0 for k in _COLLECTIVES})
        self._live = [0]
        self.peak_temp = 0

    def __enter__(self):
        gc.collect()
        self._gc = gc.isenabled()
        gc.disable()
        return super().__enter__()

    def __exit__(self, *exc):
        if self._gc:
            gc.enable()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._fake) for t in types) or \
                torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)
        if any(t not in (torch.Tensor, torch.nn.Parameter) for t in types):
            return NotImplemented   # DTensor, AsyncCollectiveTensor: unwrap
        out = func(*args, **kwargs)
        if self._device is None or any(
                t.device.type == self._device
                for t in _tensors((args, kwargs, out))):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
        if name in _SILENT:
            return
        self.ops += 1
        kind = _KIND.get(name)
        if kind is not None:
            if func.namespace == "c10d":
                i, o = _C10D_IO[name]
                read = args[i] if i is not None else ()
                written = args[o] if o is not None else ()
            else:
                read, written = args[0], out
            # what crosses the link: the output (a send's: its input)
            moved = written if _numel(written) else read
            self.coll.bytes_by_kind[kind] += _nbytes(moved)
            self.coll.elements_by_kind[kind] += _numel(moved)
            self.coll.count_by_kind[kind] += 1
            self.bytes += _nbytes(read) + _nbytes(written)
            if func.namespace != "c10d":
                self._track(out)
            return
        if func.namespace in ("c10d", "_c10d_functional", "_dtensor"):
            raise ValueError(f"uncounted collective {name}")
        rets = func._schema.returns
        if rets and all(r.alias_info is not None and not r.alias_info.is_write
                        for r in rets):
            return      # a view: no data moved, no storage made
        packet = func.overloadpacket
        fn = flop_counter.flop_registry.get(packet)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        if name in _ALLOC:
            self._track(out)
            return
        self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        if not any(r.alias_info is not None for r in rets):
            self._track(out)

    def _track(self, out) -> None:
        """Add the new storages of ``out`` to the live bytes until they are
        freed; keep the peak."""
        live = self._live
        for t in _tensors(out):
            st = t.untyped_storage()
            n = st.nbytes()
            live[0] += n
            weakref.finalize(st, _release, live, n)
        if live[0] > self.peak_temp:
            self.peak_temp = live[0]

    def result(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll": float(self.coll.total_bytes),
                "coll_by": dict(self.coll.bytes_by_kind),
                "coll_counts": dict(self.coll.count_by_kind),
                "coll_elems": dict(self.coll.elements_by_kind),
                "temp": float(self.peak_temp), "ops": self.ops}


def _release(live: list, n: int) -> None:
    live[0] -= n


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    n_devices: int
    model_flops: float          # 6·N·D (train) or 2·N_active·D (inference)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """The least time of the step: its largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops of all devices (remat and
        replication overhead). The port counts tensor-core work only, so
        this is not ``repro``'s ratio."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time over the dominating term (a bound estimate,
        not a wall-clock measurement)."""
        t_useful = (self.model_flops / self.n_devices) / PEAK_FLOPS
        return t_useful / self.t_bound if self.t_bound else 0.0

    def row(self) -> dict:
        return dict(
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, bottleneck=self.bottleneck,
            useful_ratio=self.useful_flops_ratio,
            roofline_fraction=self.roofline_fraction,
        )


def derive(counts: dict, n_devices: int, model_flops: float) -> Roofline:
    """The roofline of one rank's counts (:meth:`CostCounter.result`)."""
    return Roofline(
        flops_per_device=float(counts["flops"]),
        bytes_per_device=float(counts["bytes"]),
        collective_bytes=float(counts["coll"]),
        n_devices=n_devices,
        model_flops=model_flops,
    )


def model_flops_for(cfg, shape, n_active: float | None = None) -> float:
    """MODEL_FLOPS per step: 6·N_active·D (train) / 2·N_active·D (fwd).

    n_active: measured active-parameter count (falls back to the config
    formula when not provided).
    """
    if n_active is None:
        n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
