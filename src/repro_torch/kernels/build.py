"""Build, load and count the port's CUDA kernels, and keep their tables.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries go to ``build/repro_torch_kernels/`` at the
repository root, at first use; the file name carries a hash of the sources
and flags, so an edited source rebuilds and a stale library is never
loaded. A file lock covers the build (pytest-xdist runs processes, serving
workers run threads), and :func:`build` starts one ``nvcc`` per source, all
at once. Only sources from this package are compiled; nothing is fetched.

Calling convention of every entry point: pointers and the CUDA stream as
``c_void_p``, sizes as ``c_int``; the function returns ``cudaGetLastError()``
after its launch, and :func:`check` raises on anything but 0.

:func:`device_constant` keeps the constant tables the kernels read (product
tables, per-tap columns) on the card, built once per key and device, so no
launch uploads a table.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Hashable, Iterable, Sequence

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("fused_conv", "approx_matmul", "lut_matmul", "approx_mul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOAD_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_CONST_LOCK = threading.Lock()
_CONSTS: Dict[tuple, torch.Tensor] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from csrc/ at first use on a machine with the CUDA "
            "toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing; return all paths.

    One ``nvcc`` per source, all started together, under an exclusive file
    lock. The compiler's output (``-Xptxas -v``: registers, spills) is kept
    beside each library as ``.log``. Raises with that output if any fails.
    """
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = []
            for name in names:
                out = library_path(name)
                if out.exists():
                    continue
                tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
                log = out.with_suffix(".log")
                with open(log, "w") as fh:
                    p = subprocess.Popen(
                        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                         str(CSRC / f"{name}.cu")],
                        stdout=fh, stderr=subprocess.STDOUT)
                procs.append((name, p, tmp, out, log))
            failed = []
            for name, p, tmp, out, log in procs:
                if p.wait() == 0:
                    os.replace(tmp, out)
                else:
                    failed.append(f"{name}.cu:\n{log.read_text()}")
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return {name: library_path(name) for name in names}


def build_log(name: str) -> str:
    """The compiler output kept beside the library of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


def load_function(source: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, building the
    library first if needed; ``restype`` is ``c_int`` (a CUDA error code)."""
    with _LOAD_LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build((source,))[source]))
            _LIBS[source] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise unless a C entry point returned ``cudaSuccess`` (0)."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error code {rc}")


def device_constant(key: Hashable, device,
                    make: Callable[[], "np.ndarray | torch.Tensor"]
                    ) -> torch.Tensor:
    """The tensor ``make()`` on ``device``, built once per (key, device).

    ``make`` returns a host array, or a tensor it built on ``device`` itself
    (a table a kernel writes on the card). On the card the upload or build
    runs once, then the stream is synchronised: the table is complete before
    any worker's stream reads it, and no later call copies from the host (a
    pageable copy per batch would block the worker until its stream
    drained).
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _CONST_LOCK:
        t = _CONSTS.get((key, device))
        if t is None:
            t = make()
            if not torch.is_tensor(t):
                t = torch.from_numpy(np.array(t, order="C"))
            t = t.to(device).contiguous()
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            _CONSTS[(key, device)] = t
        return t


class LaunchCounter:
    """Thread-safe count of kernel launches, kept on each kernel wrapper so a
    run can show that its main path went through the kernel. A launch that
    names its shape is also counted under that shape (:meth:`by_shape`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._shapes: Dict[tuple, int] = {}

    def add(self, shape: Sequence[int] = ()) -> None:
        with self._lock:
            self._n += 1
            if shape:
                key = tuple(int(d) for d in shape)
                self._shapes[key] = self._shapes.get(key, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._shapes = {}

    def by_shape(self) -> Dict[tuple, int]:
        """Launches by the shape their launch named, e.g. ``(B, M, K, N)``."""
        with self._lock:
            return dict(self._shapes)

    @property
    def value(self) -> int:
        with self._lock:
            return self._n
