"""Atomic, async checkpointing and substrate-plan bundles.

Counterpart of ``repro.checkpoint.ckpt``, with its on-disk formats byte for
byte, so a directory written by either package loads in the other:

* **checkpoint** — ``<dir>/step_%010d/`` holding ``arrays.npz`` (one array
  per tree leaf, keyed by the ``/``-joined path of dict keys and list
  indices) and ``manifest.json`` (``step``, ``n_arrays``, ``dtypes``,
  ``time``, ``extra``). It is written under a ``.tmp`` name and renamed into
  place once complete, so a crashed save is never taken for a step;
  restore picks the newest complete step.
* **plan bundle** — ``plan.json`` (the :class:`repro_torch.nn.plan.SubstratePlan`
  schema), ``manifest.json`` (``kind: substrate-plan-bundle``, ``version:
  1``, ``has_params``, ``dtypes``, ``extra``) and, with params,
  ``arrays.npz`` in the same encoding; written and replaced atomically.

npz holds only numpy's own dtypes. ``repro`` writes a ``bfloat16`` leaf as
its ``uint16`` bits and records ``"bfloat16"`` in ``dtypes``; it reads it
back through ``ml_dtypes``. The port needs no ``ml_dtypes``: it writes a
``torch.bfloat16`` leaf the same way and reads those bits back as
``torch.bfloat16`` (a ``uint16`` container viewed as bf16). Any other
recorded dtype raises.

Trees are dicts and lists of tensors (or numpy arrays). Loads return
tensors on ``device``: given, else the template leaf's device, else the
CPU. :class:`CheckpointManager` adds async saves (a synchronous copy to
host memory, then a writer thread), retention of the newest ``keep`` steps
and resume discovery.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

SEP = "/"

# numpy can't hold bf16: bitcast to a same-width unsigned container and
# record the true dtype in the manifest (repro's encoding)
_CONTAINER = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def tree_leaves(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of a tree of dicts and lists, dict keys in sorted order
    (``jax.tree_util``'s order); a path holds dict keys and list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def tree_map(tree, fn):
    """``fn`` at every leaf; dicts and lists rebuilt around the results."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(v, fn) for v in tree]
    return fn(tree)


def _key(path: Tuple) -> str:
    return SEP.join(str(p) for p in path)


def _encode(leaf) -> Tuple[np.ndarray, Optional[str]]:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind in "biufc":  # plain numpy dtypes pass through
        return arr, None
    return arr.view(_CONTAINER[arr.dtype.itemsize]), str(arr.dtype)


def _decode(arr: np.ndarray, dtype_name: Optional[str], device) -> torch.Tensor:
    if dtype_name is None:
        return torch.from_numpy(arr).to(device)
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    raise ValueError(f"leaf dtype {dtype_name!r} has no torch counterpart here "
                     "(only bfloat16 is stored in a container)")


def _write_arrays(directory: str, tree) -> Tuple[int, dict]:
    """``arrays.npz`` of the tree's leaves → (number of arrays, dtypes)."""
    encoded, dtypes = {}, {}
    for path, leaf in tree_leaves(tree):
        arr, dt = _encode(leaf)
        encoded[_key(path)] = arr
        if dt is not None:
            dtypes[_key(path)] = dt
    np.savez(os.path.join(directory, "arrays.npz"), **encoded)
    return len(encoded), dtypes


def _read_arrays(directory: str, dtypes: dict, device) -> dict:
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        return {k: _decode(z[k], dtypes.get(k), device) for k in z.files}


def _device_of(leaf, device):
    if device is not None:
        return torch.device(device)
    if torch.is_tensor(leaf) and leaf.device.type != "meta":
        return leaf.device
    return torch.device("cpu")


def unflatten_into(template, flat: dict, device=None):
    """``template``'s structure with the leaves of ``flat``, the
    ``{path: tensor}`` dict a load returns (shapes checked), on ``device``
    or else each template leaf's device."""
    def fill(path, leaf):
        key = _key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = flat[key]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
        return t.to(_device_of(leaf, device))

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        return fill(path, tree)

    return walk(template, ())


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[dict] = None) -> str:
    """Synchronous atomic save of a tree at a step."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    n, dtypes = _write_arrays(tmp, tree)
    manifest = {"step": step, "n_arrays": n, "dtypes": dtypes,
                "time": time.time(), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_steps(directory: str) -> list:
    """The complete steps in ``directory`` (a manifest present), sorted."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def load_checkpoint(directory: str, template, step: Optional[int] = None,
                    device=None):
    """Restore the newest (or given) step into ``template``'s structure →
    ``(tree, step, extra)``. Only the template's shapes are read, so meta
    tensors make a template that allocates nothing."""
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _read_arrays(path, manifest.get("dtypes", {}), "cpu")
    return unflatten_into(template, flat, device), step, manifest.get("extra", {})


def save_plan_bundle(directory: str, plan, params=None,
                     extra: Optional[dict] = None) -> str:
    """Atomic write of a substrate-plan bundle directory: ``plan.json``,
    ``manifest.json`` and, with ``params`` (a tree), ``arrays.npz``. An
    existing bundle at ``directory`` is replaced."""
    from repro_torch.nn import plan as plan_mod

    plan = plan_mod.as_plan(plan)
    directory = os.path.abspath(directory)
    os.makedirs(os.path.dirname(directory) or ".", exist_ok=True)
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "plan.json"), "w") as f:
        json.dump(plan.to_dict(), f, indent=2)
        f.write("\n")
    manifest = {"kind": "substrate-plan-bundle", "version": 1,
                "time": time.time(), "has_params": params is not None,
                "dtypes": {}, "extra": extra or {}}
    if params is not None:
        manifest["n_arrays"], manifest["dtypes"] = _write_arrays(tmp, params)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)
    return directory


def load_plan_bundle(directory: str, params_template=None, device=None):
    """Load a plan bundle → ``(plan, params, extra)``.

    ``params_template`` restores the saved arrays into its structure;
    without one, ``params`` is the flat ``{path: tensor}`` dict when the
    bundle carries arrays, else None.
    """
    from repro_torch.nn import plan as plan_mod

    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("kind") != "substrate-plan-bundle":
        raise ValueError(f"{directory} is not a substrate-plan bundle "
                         f"(kind={manifest.get('kind')!r})")
    plan = plan_mod.load_plan(os.path.join(directory, "plan.json"))
    params = None
    if manifest.get("has_params"):
        flat = _read_arrays(directory, manifest.get("dtypes", {}),
                            "cpu" if params_template is not None
                            else _device_of(None, device))
        params = (flat if params_template is None
                  else unflatten_into(params_template, flat, device))
    elif params_template is not None:
        raise ValueError(f"bundle {directory} carries no params to restore")
    return plan, params, manifest.get("extra", {})


class CheckpointManager:
    """Async save + retention + resume discovery."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()
        # a host copy now: the training step updates the tensors in place
        host_tree = tree_map(tree, lambda t: t.detach().to("cpu", copy=True)
                             if torch.is_tensor(t) else np.array(t))

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()
        save_checkpoint(self.directory, step, tree, extra)
        self._gc()

    def latest_step(self) -> Optional[int]:
        steps = list_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, device=None):
        return load_checkpoint(self.directory, template, step, device)

    def _gc(self):
        steps = list_steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
