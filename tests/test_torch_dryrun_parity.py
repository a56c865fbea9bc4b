"""The mesh dry run held to ``repro``'s compiled step, family by family:
training cells (this module) and serving cells
(``tests/test_torch_dryrun_parity_serve.py``).

``repro``'s side runs once per module in a subprocess with 8 forced host
devices, on a 4 × 2 mesh with **Auto** axes (``repro``'s debug mesh is
Explicit, and its sharded code fails there: ``tests/test_distributed.py``'s
dry-run cells). Each cell is lowered and compiled by
``repro.launch.rooffix._metrics_for`` with ``cost_unroll=True``, at one
repeating unit of layers (two for xlstm and zamba, which unroll theirs in
Python), so the layer scan has trip count 1 and XLA counts its body once
and exactly: no depths are differenced. From each compiled step come its
``cost_analysis`` bytes and the flops of its ``dot``s; from the module
right after the SPMD partitioner (``xla_dump_hlo_pass_re``) its
collectives, by kind, element type and count. The port's side is
``repro_torch.launch.dryrun.count_step`` on a fake 8-rank world and
``make_debug_mesh()``, at the same config, and on one ``meta`` device
(``tools/dryrun_cells.py``, which also counts the cells where JAX does
not run).

The bar, cell by cell:

* **collective bytes by kind** within 10% of ``repro``'s, each collective
  priced at the element type the partitioner gave it: XLA:CPU then widens
  every bf16 collective to f32 (a ``convert`` before it), which a TPU or
  GPU compile does not do (:func:`test_partitioned_collectives_are_bf16`).
  An all-reduce whose only users are ``dynamic-slice``s, each one group
  member's share of it, is the reduce-scatter that the GPU and TPU
  pipelines form from it (XLA's ``ReduceScatterCreator``, which XLA:CPU
  does not run, matches only a slice of that size), and is counted as
  one, at the slice's size. A kind one side moves and the other does not
  is an error;
* **tensor-core flops** within 2% of the compiled step's ``dot`` flops
  (XLA's ``cost_analysis`` counts every op's; the port counts products);
* **the mesh's share** of the one-device flops (8 × a rank's over one
  device's) within 5% of ``repro``'s: a rank may count above an eighth
  where ``repro`` does too;
* **HBM bytes** within 20% of ``cost_analysis``'s "bytes accessed".

A difference that is understood and is not the port's fault is entered
in :data:`KNOWN` with its port / ``repro`` factor and its cause; the test
holds the factor to 10%, so that an entry cannot drift.
"""
from __future__ import annotations

import collections
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from tests.test_torch_xlstm import one_torch_thread, once  # noqa: F401 (autouse)
from tools import dryrun_cells
from tools.dryrun_cells import CHUNK, FAMILIES, cell_spec

ROOT = Path(__file__).resolve().parents[1]

CELLS = [f"train:{f}" for f in FAMILIES]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_EAGER = ("the port's step runs eagerly and its counter prices each op's "
          "input and output (src/repro_torch/launch/roofline.py:219 "
          "_count), where XLA prices a fusion's operands and result once: "
          "the backward's elementwise chains and the optimizer's update "
          "are not fused")
_BF16 = ("XLA:CPU runs bf16 as f32: each bf16 weight of the decode step is "
         "read and written again as f32 by a convert fusion before its "
         "all-gather and dot, and the all-gathers move f32, where the "
         "port's step reads the bf16 weight (the partitioned module's "
         "collectives are bf16, test_partitioned_collectives_are_bf16); at "
         "float32 the two decode steps' bytes agree within 20% "
         "(tests/test_torch_dryrun_parity_serve.py, decode:*:f32)")
#: (cell, kind or "bytes") -> (port / repro factor, cause)
KNOWN = {
    ("train:dense", "bytes"): (1.19, _EAGER),
    ("decode:dense", "bytes"): (0.60, _BF16),
    ("decode:moe", "bytes"): (0.50, _BF16),
    ("decode:dense:long", "bytes"): (0.725, _BF16),
}

# ---------------------------------------------------------------------------
# HLO text: collectives and dots
# ---------------------------------------------------------------------------

_INSTR = re.compile(
    r"^\s*(ROOT\s+)?%([\w.\-]+)\s*=\s*(.*?)\s([a-z][a-z0-9\-]*)\((.*)$")
_HEAD = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s.*\{\s*$")
_SHAPE = re.compile(r"\b(pred|[a-z]+[0-9]+)\[([0-9,]*)\]")
_SIZE = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
         "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8}
#: ops that pass a value on unchanged in content
_PASS = ("copy", "bitcast", "reshape", "convert", "get-tuple-element")


def _shapes(typ: str):
    return [(dt, [int(d) for d in dims.split(",") if d])
            for dt, dims in _SHAPE.findall(typ)]


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def _group_size(line: str) -> int:
    """The size of a collective's replica groups: ``[2,4]<=[4,2]T(1,0)``
    (iota form: 2 groups of 4) or ``{{0,2,4,6},{1,3,5,7}}``."""
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=", line)
    if m:
        return int(m.group(2))
    m = re.search(r"replica_groups=\{\{([0-9,]*)\}", line)
    return len(m.group(1).split(",")) if m else 1


class Hlo:
    """One HLO module's text: its instructions by name, their users, and
    the computation each belongs to."""

    def __init__(self, text: str):
        self.ins, self.users, self.comp = {}, collections.defaultdict(list), {}
        self.calls = collections.defaultdict(list)
        comp = None
        for line in text.splitlines():
            h = _HEAD.match(line)
            if h and not line.startswith(" "):
                comp = h.group(1)
                continue
            m = _INSTR.match(line)
            if not m:
                continue
            root, name, typ, op, rest = m.groups()
            args = rest.split("), ")[0] if "), " in rest else rest.rstrip(")")
            ops = re.findall(r"%([\w.\-]+)", args)
            self.ins[name] = (typ, op, ops, line)
            self.comp[name] = (comp, bool(root))
            for o in ops:
                self.users[o].append(name)
            if op == "call":
                self.calls[re.search(r"to_apply=%([\w.\-]+)", line).group(1)
                           ].append(name)

    def _ends(self, name):
        """The ops that consume ``name``'s value, past ops that pass it on
        and across a called computation's result tuple."""
        out, todo = [], [name]
        while todo:
            src = todo.pop()
            for u in self.users[src]:
                typ, op, ops, line = self.ins[u]
                comp, root = self.comp[u]
                if op in _PASS:
                    todo.append(u)
                elif op == "tuple" and root and self.calls[comp]:
                    i = ops.index(src)
                    todo.extend(
                        g for c in self.calls[comp] for g in self.users[c]
                        if self.ins[g][1] == "get-tuple-element" and re.search(
                            r"index=(\d+)", self.ins[g][3]).group(1) == str(i))
                else:
                    out.append(u)
        return out

    def collectives(self, reduce_scatter: bool = True):
        """``{kind: {dtype: elements}}`` of the collectives; with
        ``reduce_scatter``, an all-reduce whose only consumers are
        ``dynamic-slice``s, each of one group member's share of it,
        counts as a reduce-scatter of the slice."""
        out = {k: collections.Counter() for k in KINDS}
        for name, (typ, op, ops, line) in self.ins.items():
            op = op[:-6] if op.endswith("-start") else op
            if op not in KINDS:
                continue
            shapes = _shapes(typ)
            if reduce_scatter and op == "all-reduce":
                ends = self._ends(name)
                share = _numel(shapes[0][1]) // _group_size(line)
                if ends and all(self.ins[e][1] == "dynamic-slice" and _numel(
                        _shapes(self.ins[e][0])[0][1]) == share for e in ends):
                    op, shapes = "reduce-scatter", _shapes(self.ins[ends[0]][0])
            for dt, dims in shapes:
                out[op][dt] += _numel(dims)
        return out

    def dot_flops(self) -> int:
        """2 · output elements · contracted size of every ``dot``."""
        flops = 0
        for typ, op, ops, line in self.ins.values():
            if op == "convolution":
                raise NotImplementedError(f"convolution in the step: {line}")
            if op != "dot":
                continue
            lhs = _shapes(self.ins[ops[0]][0])[0][1]
            cd = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", line).group(1)
            flops += 2 * _numel(_shapes(typ)[0][1]) * _numel(
                lhs[int(c)] for c in cd.split(",") if c)
        return flops


def nbytes(by_dtype) -> int:
    return sum(_SIZE[dt] * n for dt, n in by_dtype.items())


# ---------------------------------------------------------------------------
# the two sides
# ---------------------------------------------------------------------------

_REPRO = """
import glob, os, pickle, sys, tempfile
import jax
import jax.numpy as jnp
import jax.stages
from jax.sharding import AxisType
from repro.launch import rooffix
from repro.models import registry as reg

FAMILIES, CELLS, CHUNK, OUT, ONE_OP = pickle.loads(
    bytes.fromhex(sys.argv[1]))
MESH = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
ONE = jax.make_mesh((1, 1), ("data", "model"),
                    axis_types=(AxisType.Auto,) * 2, devices=jax.devices()[:1])
DUMP, TEXT = [None], []
compile_ = jax.stages.Lowered.compile


def compile_dumped(self, compiler_options=None):
    # the module after the SPMD partitioner, in the subprocess only
    opts = dict(compiler_options or {})
    if DUMP[0]:
        opts.update(xla_dump_to=DUMP[0],
                    xla_dump_hlo_pass_re="spmd-partitioning")
    c = compile_(self, compiler_options=opts or None)
    TEXT.append(c.as_text())
    return c


jax.stages.Lowered.compile = compile_dumped
res = {}
for cell, (kind, fam, f32, batch, seq) in CELLS:
    arch, over = FAMILIES[fam]
    cfg = reg.get_config(arch, cost_unroll=True, attn_chunk=CHUNK,
                         loss_chunk=CHUNK, **over,
                         **({"dtype": jnp.float32} if f32 else {}))
    shape = reg.ShapeSpec("cell", kind, seq, batch)
    DUMP[0] = tempfile.mkdtemp()
    m = rooffix._metrics_for(cfg, shape, MESH)
    (part,) = glob.glob(os.path.join(DUMP[0], "*after_spmd-partitioning*"))
    DUMP[0] = None
    with open(part) as f:
        m["partitioned"] = f.read()
    m["compiled"] = TEXT[-1]
    rooffix._metrics_for(cfg, shape, ONE)
    m["one_compiled"] = TEXT[-1]
    res[cell] = m
    jax.clear_caches()
if ONE_OP:
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:4])
    x = jax.ShapeDtypeStruct((1024, 256), jnp.float32)
    for name, body, out in (
            ("all-gather", lambda v: jax.lax.all_gather(v, "data", tiled=True),
             P(None, None)),
            ("all-reduce", lambda v: jax.lax.psum(v, "data"), P("data", None))):
        f = shard_map(body, mesh=mesh, in_specs=P("data", None),
                      out_specs=out, check_rep=False)
        res[name] = jax.jit(f).lower(x).compile().cost_analysis()[
            "bytes accessed"]
with open(OUT, "wb") as f:
    pickle.dump(res, f)
"""


def start_repro(cells, tmp: Path, one_op: bool = False):
    """``repro``'s side in a subprocess with 8 forced host devices,
    started now; :func:`finish_repro` waits for it."""
    out = tmp / "repro_side.pkl"
    arg = pickle.dumps((FAMILIES, [(c, cell_spec(c)) for c in cells], CHUNK,
                        str(out), one_op)).hex()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.Popen([sys.executable, "-c", _REPRO, arg], env=env,
                            cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def finish_repro(proc, out: Path) -> dict:
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    with open(out, "rb") as f:
        raw = pickle.load(f)
    side = {}
    for cell, m in raw.items():
        if not isinstance(m, dict):
            side[cell] = m
            continue
        part, comp = Hlo(m["partitioned"]), Hlo(m["compiled"])
        side[cell] = dict(
            flops=m["flops"], bytes=m["bytes"],
            coll=part.collectives(),
            partitioned=part.collectives(reduce_scatter=False),
            compiled=comp.collectives(reduce_scatter=False),
            dot=comp.dot_flops(), one_dot=Hlo(m["one_compiled"]).dot_flops())
    return side


def port_side(cell: str) -> dict:
    """The port's counts of ``cell`` (``tools/dryrun_cells.py``)."""
    c = dryrun_cells.count(cell)
    assert not dist.is_initialized()
    return dict(flops=c["flops"], bytes=c["bytes"],
                coll=c["collective_bytes"], one_flops=c["one_device_flops"])


def both_sides(cells, tmp: Path, one_op: bool = False) -> dict:
    """``{cell: (repro, port)}``: ``repro``'s subprocess runs while the
    port counts."""
    proc, out = start_repro(cells, tmp, one_op)
    try:
        port = {c: port_side(c) for c in cells}
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    repro = finish_repro(proc, out)
    return {c: (repro[c], port[c]) for c in cells} | {
        k: v for k, v in repro.items() if k not in cells}


# ---------------------------------------------------------------------------
# the bar
# ---------------------------------------------------------------------------


def miss(cell: str, what: str, port: float, repro: float, tol: float):
    """Why ``port`` is not held to ``repro`` (within ``tol`` of it, or
    within 10% of the factor that :data:`KNOWN` states), or None."""
    ratio = port / repro if repro else float("inf") if port else 1.0
    said = f"{cell} {what}: port {port} / repro {repro} = {ratio:.4g}"
    if (cell, what) in KNOWN:
        factor, why = KNOWN[cell, what]
        if repro == 0 or abs(ratio - factor) > 0.10 * factor:
            return f"{said}, KNOWN {factor} ({why[:60]}...)"
        return None
    return None if abs(ratio - 1) <= tol else said


def held(cell: str, what: str, port: float, repro: float, tol: float):
    why = miss(cell, what, port, repro, tol)
    assert why is None, why


def check_collectives(cell, repro, port):
    """Bytes by kind, each side at the partitioner's element types."""
    missed = [miss(cell, kind, port["coll"][kind],
                   nbytes(repro["coll"][kind]), 0.10) for kind in KINDS]
    assert not any(missed), "\n".join(m for m in missed if m)


def check_flops(cell, repro, port):
    held(cell, "flops", port["flops"], repro["dot"], 0.02)


def check_share(cell, repro, port):
    """8 × a rank's flops over one device's, each side's own."""
    held(cell, "share", 8 * port["flops"] / port["one_flops"],
         8 * repro["dot"] / repro["one_dot"], 0.05)


def check_bytes(cell, repro, port, tol=0.20):
    held(cell, "bytes", port["bytes"], repro["bytes"], tol)


def check_widened(repro):
    """The partitioner's collectives move bf16 where the model computes
    in bf16; the compiled module moves the same elements by kind, and none
    of them in bf16: XLA:CPU widened them."""
    part, comp = repro["partitioned"], repro["compiled"]
    assert sum(part[k]["bf16"] for k in KINDS) > 0
    assert sum(comp[k]["bf16"] for k in KINDS) == 0
    for k in KINDS:
        assert sum(comp[k].values()) == pytest.approx(
            sum(part[k].values()), rel=0.10), k


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    return once("dryrun_parity_train", lambda: both_sides(
        CELLS, tmp_path_factory.mktemp("dryrun_parity_train")))


@pytest.mark.parametrize("cell", CELLS)
def test_collective_bytes_by_kind(sides, cell):
    check_collectives(cell, *sides[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_tensor_core_flops(sides, cell):
    check_flops(cell, *sides[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_mesh_share_of_the_one_device_flops(sides, cell):
    check_share(cell, *sides[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_hbm_bytes(sides, cell):
    check_bytes(cell, *sides[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_partitioned_collectives_are_bf16(sides, cell):
    check_widened(sides[cell][0])


def test_known_entries_name_cells_and_causes():
    """Every :data:`KNOWN` entry names a cell of the two modules, a kind
    or ``"bytes"``, a factor and a cause; each line of the port a cause
    cites (``path:line name``) holds that name."""
    from tests.test_torch_dryrun_parity_serve import ALL

    for (cell, what), (factor, why) in KNOWN.items():
        assert cell in CELLS + ALL, cell
        assert what in KINDS + ("bytes",), what
        assert factor >= 0 and re.search(r"\.py:\d+|XLA", why), why
        for path, line, name in re.findall(r"(src/[\w/]+\.py):(\d+) (\w+)",
                                           why):
            text = (ROOT / path).read_text().splitlines()[int(line) - 1]
            assert name in text, (path, line, name, text)


def main():
    """Print each cell's port / ``repro`` ratios, the serving module's
    cells too: ``PYTHONPATH=src:. JAX_PLATFORMS=cpu python
    tests/test_torch_dryrun_parity.py``."""
    import tempfile

    from tests.test_torch_dryrun_parity_serve import ALL

    with tempfile.TemporaryDirectory() as tmp:
        sides = both_sides(CELLS + ALL, Path(tmp))
    print("| cell | " + " | ".join(KINDS) + " | tensor-core flops | share "
          "| HBM bytes |")
    print("|---" * (len(KINDS) + 4) + "|")
    for cell in CELLS + ALL:
        repro, port = sides[cell]
        ratios = [(port["coll"][k], nbytes(repro["coll"][k])) for k in KINDS]
        ratios += [(port["flops"], repro["dot"]),
                   (port["flops"] / port["one_flops"],
                    repro["dot"] / repro["one_dot"]),
                   (port["bytes"], repro["bytes"])]
        what = KINDS + ("flops", "share", "bytes")
        print(f"| {cell} | " + " | ".join(
            "–" if not r and not p else
            f"{p / r:.3f}{' (K)' if (cell, w) in KNOWN else ''}" if r else
            f"{p:.0f} B vs 0" for (p, r), w in zip(ratios, what)) + " |")


if __name__ == "__main__":
    main()
