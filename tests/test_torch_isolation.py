"""The port stands alone: no file of ``src/repro_torch/`` (the model stack,
configs, LM engine and launcher included) and not ``chip_smoke.py`` imports
``jax`` or ``repro``; importing the port loads no JAX; and with no CUDA
device the entry points raise instead of quietly running on the CPU (a
tensor's device decides, an explicit ``device="cpu"`` is the only way to the
plain versions)."""
import ast
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
#: the paper-table drivers of the port, beside the JAX package's
TORCH_DRIVERS = sorted((ROOT / "benchmarks").glob("torch_*.py"))
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
                         ids=[p.name for p in TORCH_DRIVERS])
def test_torch_drivers_import_no_jax_or_repro(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_six_torch_drivers():
    assert [p.name for p in TORCH_DRIVERS] == [
        "torch_fig10_tradeoff.py", "torch_fig9_edge.py",
        "torch_table2_compressors.py", "torch_table3_compressor4.py",
        "torch_table4_errors.py", "torch_table5_hardware.py"]


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
