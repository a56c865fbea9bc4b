"""The collectives GSPMD places around chosen products of ``repro``'s step.

``tests/test_torch_dryrun_parity.py`` holds the port's mesh dry run to
``repro``'s partitioned step on a 4 × 2 mesh. This probe reads the same
module (after the SPMD partitioner) on another mesh and at other widths, so
that the port's explicit placements can be checked where the harness does
not reach: the 16 × 16 production mesh at reduced widths. It runs JAX on
forced host devices (compile only: nothing is executed) and prints, for
every collective whose op name holds one of the ``--match`` einsum
strings, its kind, shape and einsum, with a count.

Usage::

  PYTHONPATH=src JAX_PLATFORMS=cpu \\
  XLA_FLAGS=--xla_force_host_platform_device_count=256 \\
  python tools/gspmd_collectives.py --arch zamba2-1.2b --mesh 16x16 \\
      --shape train:1024:16 --chunk 512 --match btn,bun --match bhdn \\
      n_layers=2 d_model=256 d_ff=512 n_heads=16 n_kv_heads=16 \\
      vocab=1024 ssm_state=64 shared_attn_every=2
"""
from __future__ import annotations

import argparse
import collections
import glob
import os
import re
import tempfile

_COLL = re.compile(r"= (\S+) (all-gather|all-reduce|all-to-all|"
                   r"collective-permute|reduce-scatter)(?:-start)?\(")


def partitioned_text(arch: str, mesh_shape, kind: str, seq: int, batch: int,
                     chunk: int, over: dict) -> str:
    """``repro``'s step of one cell lowered by ``rooffix._metrics_for`` on
    an Auto mesh: the module right after the SPMD partitioner."""
    import jax
    import jax.stages
    from jax.sharding import AxisType

    from repro.launch import rooffix
    from repro.models import registry as reg

    mesh = jax.make_mesh(mesh_shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cfg = reg.get_config(arch, cost_unroll=True, attn_chunk=chunk,
                         loss_chunk=chunk, **over)
    dump = tempfile.mkdtemp()
    compile_ = jax.stages.Lowered.compile

    def compile_dumped(self, compiler_options=None):
        opts = dict(compiler_options or {})
        opts.update(xla_dump_to=dump, xla_dump_hlo_pass_re="spmd-partitioning")
        return compile_(self, compiler_options=opts)

    jax.stages.Lowered.compile = compile_dumped
    try:
        rooffix._metrics_for(cfg, reg.ShapeSpec("cell", kind, seq, batch), mesh)
    finally:
        jax.stages.Lowered.compile = compile_
    (path,) = glob.glob(os.path.join(dump, "*after_spmd-partitioning*"))
    with open(path) as f:
        return f.read()


def collectives(text: str, match) -> collections.Counter:
    """``(kind, shape, einsum) -> count`` of the collectives whose op name
    holds one of ``match``."""
    out = collections.Counter()
    for line in text.splitlines():
        m = _COLL.search(line)
        name = re.search(r'op_name="([^"]*)"', line)
        if not m or not name:
            continue
        hit = [s for s in match if s in name.group(1)]
        if hit:
            out[(m.group(2), m.group(1).split("{")[0], hit[0])] += 1
    return out


def _value(v: str):
    try:
        return int(v)
    except ValueError:
        return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--shape", default="train:1024:16",
                    help="kind:positions:batch")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--match", action="append", required=True)
    ap.add_argument("over", nargs="*", help="config field=value")
    args = ap.parse_args(argv)
    kind, seq, batch = args.shape.split(":")
    over = {k: _value(v) for k, v in (o.split("=") for o in args.over)}
    text = partitioned_text(args.arch, tuple(map(int, args.mesh.split("x"))),
                            kind, int(seq), int(batch), args.chunk, over)
    for (kind_, shape, einsum), n in sorted(collectives(text, args.match).items()):
        print(f"{n:3d} × {kind_:18s} {shape:24s} {einsum}")


if __name__ == "__main__":
    main()
