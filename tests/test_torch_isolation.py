"""The port stands alone: no file of ``src/repro_torch/`` (the model stack,
configs, LM engine and launcher included) and not ``chip_smoke.py`` imports
``jax`` or ``repro``; importing the port loads no JAX; and with no CUDA
device the entry points raise instead of quietly running on the CPU (a
tensor's device decides, an explicit ``device="cpu"`` is the only way to the
plain versions)."""
import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.launch import autotune as launch_autotune
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import registry as reg
from repro_torch.serving import EdgeDetectService, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
#: the port's drivers beside the JAX package's: the paper tables and
#: benches under benchmarks/, the examples under examples/
TORCH_DRIVERS = (sorted((ROOT / "benchmarks").glob("torch_*.py"))
                 + sorted((ROOT / "examples").glob("torch_*.py")))
#: the JAX package's machine-readable results, which no port driver writes
REFERENCE_BENCH_JSON = sorted(p.name for p in ROOT.glob("BENCH_*.json")
                              if not p.name.startswith("BENCH_torch_"))
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", TORCH_DRIVERS,
                         ids=[str(p.relative_to(ROOT)) for p in TORCH_DRIVERS])
def test_torch_drivers_import_no_jax_or_repro(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_six_torch_drivers():
    """Named when the port had its six paper-table drivers; it now lists
    all sixteen: those six, the four benches and the harness beside them,
    and the five examples."""
    assert [str(p.relative_to(ROOT)) for p in TORCH_DRIVERS] == [
        "benchmarks/torch_autotune_plan.py", "benchmarks/torch_edge_serving.py",
        "benchmarks/torch_fig10_tradeoff.py", "benchmarks/torch_fig9_edge.py",
        "benchmarks/torch_kernelbench.py", "benchmarks/torch_qat_recovery.py",
        "benchmarks/torch_run.py", "benchmarks/torch_table2_compressors.py",
        "benchmarks/torch_table3_compressor4.py",
        "benchmarks/torch_table4_errors.py", "benchmarks/torch_table5_hardware.py",
        "examples/torch_edge_detection.py", "examples/torch_quickstart.py",
        "examples/torch_serve_edge.py", "examples/torch_serve_lm.py",
        "examples/torch_train_lm.py"]


def _load_driver(path: Path):
    spec = importlib.util.spec_from_file_location(f"_driver_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", TORCH_DRIVERS,
                         ids=[str(p.relative_to(ROOT)) for p in TORCH_DRIVERS])
def test_no_driver_defaults_to_a_reference_bench_json(path, monkeypatch):
    """A driver's default JSON path, where it has one, is a BENCH_torch_*.json
    at the repo root: never one of the JAX package's BENCH_*.json."""
    assert REFERENCE_BENCH_JSON == ["BENCH_autotune.json", "BENCH_kernels.json",
                                    "BENCH_qat.json", "BENCH_serving.json"]
    monkeypatch.syspath_prepend(str(ROOT))
    default = getattr(_load_driver(path), "DEFAULT_JSON", None)
    if default is None:
        return
    assert default.parent == ROOT and default.name.startswith("BENCH_torch_")
    assert default.name not in REFERENCE_BENCH_JSON


NEW_DRIVERS = {
    "examples/torch_edge_detection.py": lambda m: m.main(),
    "examples/torch_quickstart.py": lambda m: m.main(),
    "examples/torch_serve_edge.py": lambda m: m.main([]),
    "examples/torch_serve_lm.py": lambda m: m.main(),
    "examples/torch_train_lm.py": lambda m: m.main([]),
    "benchmarks/torch_kernelbench.py": lambda m: m.run(json_path=None),
    "benchmarks/torch_edge_serving.py": lambda m: m.run(json_path=None),
    "benchmarks/torch_autotune_plan.py": lambda m: m.run(json_path=None),
    "benchmarks/torch_qat_recovery.py": lambda m: m.run(json_path=None),
    "benchmarks/torch_run.py": lambda m: m.main([]),
}


@pytest.mark.parametrize("rel", sorted(NEW_DRIVERS))
def test_drivers_default_to_cuda(rel, monkeypatch):
    """Called with their defaults, the drivers run on the card: with no
    card they raise before any work, and only ``--device cpu`` (the tests'
    ``device="cpu"``) reaches the plain versions."""
    if torch.cuda.is_available():
        assert launch_train.resolve_device("cuda").type == "cuda"
        return
    monkeypatch.syspath_prepend(str(ROOT))
    mod = _load_driver(ROOT / rel)
    with pytest.raises(RuntimeError, match="--device cpu"):
        NEW_DRIVERS[rel](mod)


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in PORT_FILES[:-1])
    code = ("import sys\n"
            + "".join(f"import {m.removesuffix('.__init__')}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro')]\n"
              "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                                 "PATH": "/usr/bin:/bin"},
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_service_defaults_to_cuda():
    if torch.cuda.is_available():
        svc = EdgeDetectService(start=False)
        assert svc.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            EdgeDetectService()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            EdgeDetectService("approx_cuda", device="cuda")


def test_build_without_nvcc_raises_and_leaves_no_library(tmp_path, monkeypatch):
    """No toolkit → a loud error, never a quiet switch to the plain version."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build.os, "access", lambda *_a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(("fused_conv",))
    assert not list(tmp_path.glob("*.so"))
    assert build.library_path("fused_conv").name.startswith("libfused_conv_")


LM_MODULES = ["configs", "models/common.py", "models/lm.py",
              "models/registry.py", "models/convert.py", "serving/engine.py",
              "obs/export.py", "launch/serve.py"]


@pytest.mark.parametrize("rel", LM_MODULES)
def test_lm_slice_modules_are_checked(rel):
    """The LM slice's modules are among the files checked above."""
    path = ROOT / "src" / "repro_torch" / rel
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files and all(f in PORT_FILES for f in files)
    assert all(not (_imported_roots(f) & FORBIDDEN) for f in files)


TRAIN_MODULES = ["checkpoint", "optim", "train", "data/synthetic.py",
                 "launch/train.py", "nn/substrate.py", "models/convert.py"]


@pytest.mark.parametrize("rel", TRAIN_MODULES)
def test_training_slice_modules_are_checked(rel):
    """The training slice's modules are among the files checked above."""
    path = ROOT / "src" / "repro_torch" / rel
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files and all(f in PORT_FILES for f in files)
    assert all(not (_imported_roots(f) & FORBIDDEN) for f in files)


TOOLS_MODULES = ["core/metrics.py", "core/energy.py", "obs/meter.py",
                 "launch/autotune.py", "nn/approx_dot.py"]


@pytest.mark.parametrize("rel", TOOLS_MODULES)
def test_tools_slice_modules_are_checked(rel):
    """The paper-table, meter and autotuner modules are among the files
    checked above."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in PORT_FILES and not (_imported_roots(path) & FORBIDDEN)


def test_autotune_defaults_to_cuda():
    if torch.cuda.is_available():
        assert launch_autotune.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_autotune.autotune_edge(n_images=1, size=(8, 8))
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_autotune.autotune_lm("minitron-8b", overrides={"n_layers": 1})
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_autotune.main(["--out", "unused_bundle"])


def test_train_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        assert launch_train.resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_train.main(["--arch", "minitron-8b", "--n-layers", "1"])


def test_serving_engine_and_launcher_default_to_cuda():
    bundle = reg.get_bundle("minitron-8b", n_layers=1, d_model=32, d_ff=64,
                            vocab=64, n_heads=2, n_kv_heads=2)
    if torch.cuda.is_available():
        params = bundle.init_params(torch.Generator("cuda").manual_seed(0),
                                    "cuda")
        assert ServingEngine(bundle, params).device.type == "cuda"
        return
    params = bundle.init_params(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(bundle, params)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_serve.main(["--arch", "minitron-8b", "--n-layers", "1"])


DRYRUN_MODULES = ["launch/roofline.py", "launch/dryrun.py", "launch/rooffix.py",
                  "launch/hillclimb.py", "launch/report.py"]


@pytest.mark.parametrize("rel", DRYRUN_MODULES)
def test_dryrun_slice_modules_are_checked(rel):
    """The dry run's and the roofline's modules are among the files checked
    above."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in PORT_FILES and not (_imported_roots(path) & FORBIDDEN)


PARTITION_MODULES = ["nn/collectives.py", "launch/mesh.py", "models/sharding.py",
                     "optim/grad_utils.py", "train/loop.py",
                     "serving/edge_service.py", "nn/conv.py"]


@pytest.mark.parametrize("rel", PARTITION_MODULES)
def test_partition_slice_modules_are_checked(rel):
    """The partitioned paths' modules are among the files checked above."""
    path = ROOT / "src" / "repro_torch" / rel
    assert path in PORT_FILES and not (_imported_roots(path) & FORBIDDEN)


SHARDED_ENTRY_POINTS = {
    "launch.train --mesh debug": lambda: launch_train.main(
        ["--arch", "minitron-8b", "--mesh", "debug"]),
    "torch_kernelbench --sharded": lambda: _load_driver(
        ROOT / "benchmarks/torch_kernelbench.py").run(sharded=True,
                                                      json_path=None),
    "torch_run --sharded": lambda: _load_driver(
        ROOT / "benchmarks/torch_run.py").main(["--sharded"]),
    "torch_serve_edge --sharded": lambda: _load_driver(
        ROOT / "examples/torch_serve_edge.py").main(["--sharded"]),
}


@pytest.mark.parametrize("name", sorted(SHARDED_ENTRY_POINTS))
def test_sharded_entry_points_default_to_cuda(name, monkeypatch):
    """The sharded options run on the card too: with no card they raise
    before a process group forms, never falling back to the CPU."""
    import torch.distributed as dist

    if torch.cuda.is_available():
        return
    monkeypatch.syspath_prepend(str(ROOT))
    with pytest.raises(RuntimeError, match="--device cpu"):
        SHARDED_ENTRY_POINTS[name]()
    assert not dist.is_initialized()


def test_backends_are_never_switched():
    """``nccl`` raises, citing item 14 (no quiet ``gloo``); an unknown
    backend raises; the production meshes need their 256 / 512 ranks (a
    world of one raises ``ValueError``), and the sharding rules give
    placements."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import mesh as ml

    with pytest.raises(ValueError, match="backend must be one of"):
        ml.init_ranks("mpi")
    with pytest.raises(NotImplementedError, match="nccl.*queue 1 item 14"):
        ml.init_ranks("nccl")
    assert not dist.is_initialized()
    ml.init_ranks("gloo")
    try:
        for multi_pod, n in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {n} ranks"):
                ml.make_production_mesh(multi_pod=multi_pod)
        mesh = ml.make_debug_mesh()
        sh = ml.param_shardings({"layers.0.attn.wq.w": torch.empty(4, 6),
                                 "embed.ln_f": torch.empty(4)}, mesh)
        assert sh["layers.0.attn.wq.w"].spec == ("data", "model")
        assert sh["layers.0.attn.wq.w"].placements == (Shard(0), Shard(1))
        assert sh["embed.ln_f"].placements == (Replicate(), Replicate())
    finally:
        dist.destroy_process_group()
