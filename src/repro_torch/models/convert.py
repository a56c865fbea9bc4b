"""Parameters and optimizer state between ``repro``'s layout and the port's.

``repro.models.lm.init_params`` returns a pytree: ``{"embed": {"emb",
"ln_f"}, "unit": [per in-unit position u: that layer's dict stacked over
unit repeats], "tail": [layer dicts]}``. :func:`lm_params_from_jax` takes
that tree with numpy arrays at its leaves (``jax.tree.map(np.asarray,
params)``; this module imports neither ``jax`` nor ``repro``) and builds the
:class:`~repro_torch.models.lm.LM` that holds the same numbers: repeat ``r``
of position ``u`` becomes layer ``r * unit_period + u``, then the tail
follows. An MoE layer's ``{"moe": {"router", "wi", "wg", "wo", "ln",
"shared"}}`` holds bare arrays (stacked: ``(n_units, E, d, f)``), the vlm
adds a top-level ``patch_proj``. :func:`encdec_params_from_jax` does the
same for ``repro.models.encdec``'s ``{"embed", "enc", "dec"}``, whose
``enc`` and ``dec`` are stacked over layers; :func:`xlstm_params_from_jax`
and :func:`zamba_params_from_jax` for the recurrent families' trees,
``{"embed", "layers": [...]}`` and ``{"embed", "mamba": [...], "shared":
{"attn", "ffn"}}``, whose layers are Python lists (not stacked). Dtypes are
kept (numpy's
``bfloat16`` from ``ml_dtypes`` is read bit for bit).

The other direction goes through a :class:`TreeLayout`: it maps the port's
flat parameter names (``module.named_parameters()``: ``embed.emb``,
``layers.5.attn.wq.w``) to ``repro``'s tree paths and back, stacking and
unstacking the unit repeats. A name may carry extra segments after the
parameter's own (``layers.5.attn.wq.w.m``), which land below it in the tree:
that is how an optimizer's per-parameter statistics ``{"m", "v"}`` (AdamW)
take ``repro``'s layout ``{"step", "mv": tree of {"m", "v"}}``. An
optimizer state keyed by tree path instead (Adafactor on ``repro``'s
stacked leaves, whose statistics belong to a whole stack:
:func:`keyed_by_path`) goes into the tree as it is (``state_to_tree``), and
:meth:`TreeLayout.groups` lists the layers each stacked leaf holds.
Checkpoints and plan bundles of the port store these trees, so files
written by either package restore in the other. :func:`lm_params_to_jax`
and :func:`state_to_jax` give the same trees as numpy arrays (a bfloat16
leaf as ``ml_dtypes.bfloat16``, which every ``repro`` installation has).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.ckpt import tree_leaves, tree_map
from repro_torch.models import common as cm
from repro_torch.models import encdec, lm, xlstm, zamba


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: jax's arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch.bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _dense(d: Dict[str, Any], device, r=None) -> cm.Dense:
    pick = (lambda a: a) if r is None else (lambda a: a[r])
    b = d.get("b")
    return cm.Dense(_tensor(pick(d["w"]), device),
                    None if b is None else _tensor(pick(b), device))


def _attn(a: Dict[str, Any], device, r=None) -> cm.Attn:
    pick = (lambda x: x) if r is None else (lambda x: x[r])
    return cm.Attn(*(_dense(a[k], device, r) for k in ("wq", "wk", "wv", "wo")),
                   ln=_tensor(pick(a["ln"]), device))


def _ffn(f: Dict[str, Any], device, r=None) -> cm.FFN:
    pick = (lambda x: x) if r is None else (lambda x: x[r])
    return cm.FFN(*(_dense(f[k], device, r) for k in ("wi", "wg", "wo")),
                  ln=_tensor(pick(f["ln"]), device))


def _moe(m: Dict[str, Any], device, r=None) -> cm.MoE:
    """``repro``'s MoE dict: bare ``router`` / ``wi`` / ``wg`` / ``wo``
    arrays, ``ln`` and an optional ``shared`` FFN dict."""
    pick = (lambda x: x) if r is None else (lambda x: x[r])
    shared = _ffn(m["shared"], device, r) if "shared" in m else None
    return cm.MoE(*(_tensor(pick(m[k]), device)
                    for k in ("router", "wi", "wg", "wo", "ln")), shared)


def _layer(p: Dict[str, Any], window: int, device, r=None) -> lm.Layer:
    attn = _attn(p["attn"], device, r)
    if "moe" in p:
        return lm.Layer(attn, window=window, moe=_moe(p["moe"], device, r))
    return lm.Layer(attn, _ffn(p["ffn"], device, r), window)


def lm_params_from_jax(cfg: cm.ModelConfig, tree: Dict[str, Any],
                       device="cpu") -> lm.LM:
    """``repro``'s ``lm.init_params(cfg, key)`` tree, as numpy arrays, → the
    port's :class:`~repro_torch.models.lm.LM` on ``device`` (MoE layers and
    the vlm's ``patch_proj`` included)."""
    plan = lm.layer_plan(cfg)
    period = lm.unit_period(cfg)
    n_units = cfg.n_layers // period
    if len(tree["unit"]) != (period if n_units else 0) or \
            len(tree["tail"]) != cfg.n_layers - n_units * period:
        raise ValueError(f"{cfg.name}: the tree's unit/tail layout does not "
                         f"match {cfg.n_layers} layers in units of {period}")
    layers = [None] * cfg.n_layers
    for u, stacked in enumerate(tree["unit"]):
        for r in range(n_units):
            i = r * period + u
            layers[i] = _layer(stacked, plan[i]["window"], device, r)
    for t, p in enumerate(tree["tail"]):
        i = n_units * period + t
        layers[i] = _layer(p, plan[i]["window"], device)
    for i, layer in enumerate(layers):
        if (layer.moe is not None) != plan[i]["moe"]:
            raise ValueError(f"{cfg.name}: layer {i} of the tree is "
                             f"{'MoE' if layer.moe is not None else 'dense'}")
    return lm.LM(_embed(tree["embed"], device), layers,
                 _dense(tree["patch_proj"], device) if "patch_proj" in tree
                 else None)


def _embed(e: Dict[str, Any], device) -> cm.Embed:
    return cm.Embed(_tensor(e["emb"], device), _tensor(e["ln_f"], device))


def encdec_params_from_jax(cfg: cm.ModelConfig, tree: Dict[str, Any],
                           device="cpu") -> encdec.EncDec:
    """``repro``'s ``encdec.init_params(cfg, key)`` tree ``{"embed", "enc",
    "dec"}`` (``enc`` / ``dec`` stacked over layers), as numpy arrays, →
    the port's :class:`~repro_torch.models.encdec.EncDec` on ``device``."""
    ne = cfg.n_encoder_layers or cfg.n_layers
    for part, n in (("enc", ne), ("dec", cfg.n_layers)):
        got = tree[part]["ffn"]["ln"].shape[0]
        if got != n:
            raise ValueError(f"{cfg.name}: the tree's {part} stacks {got} "
                             f"layers, the config {n}")
    enc = [encdec.EncLayer(_attn(tree["enc"]["attn"], device, r),
                           _ffn(tree["enc"]["ffn"], device, r)) for r in range(ne)]
    d = tree["dec"]
    dec = [encdec.DecLayer(_attn(d["self"], device, r), _attn(d["cross"], device, r),
                           _ffn(d["ffn"], device, r)) for r in range(cfg.n_layers)]
    return encdec.EncDec(_embed(tree["embed"], device), enc, dec)


def xlstm_params_from_jax(cfg: cm.ModelConfig, tree: Dict[str, Any],
                          device="cpu") -> xlstm.XLSTM:
    """``repro``'s ``xlstm.init_params(cfg, key)`` tree ``{"embed",
    "layers": [mLSTM dict, sLSTM dict, ...]}``, as numpy arrays, → the
    port's :class:`~repro_torch.models.xlstm.XLSTM` on ``device``."""
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the tree holds {len(tree['layers'])} "
                         f"layers, the config {cfg.n_layers}")
    layers = []
    for i, p in enumerate(tree["layers"]):
        cls, leaves = ((xlstm.MLSTM, xlstm.MLSTM_LEAVES) if xlstm._kind(i) == "m"
                       else (xlstm.SLSTM, xlstm.SLSTM_LEAVES))
        if set(p) != {"ln", *leaves}:
            raise ValueError(f"{cfg.name}: layer {i} holds {sorted(p)}, a "
                             f"{cls.__name__} {sorted({'ln', *leaves})}")
        layers.append(cls(_tensor(p["ln"], device),
                          *(_dense(p[k], device) for k in leaves)))
    return xlstm.XLSTM(_embed(tree["embed"], device), layers)


def zamba_params_from_jax(cfg: cm.ModelConfig, tree: Dict[str, Any],
                          device="cpu") -> zamba.Zamba:
    """``repro``'s ``zamba.init_params(cfg, key)`` tree ``{"embed", "mamba":
    [layer dicts], "shared": {"attn", "ffn"}}``, as numpy arrays, → the
    port's :class:`~repro_torch.models.zamba.Zamba` on ``device``."""
    if len(tree["mamba"]) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the tree holds {len(tree['mamba'])} "
                         f"mamba layers, the config {cfg.n_layers}")
    layers = [zamba.Mamba(_tensor(p["ln"], device), _dense(p["in_proj"], device),
                          *(_tensor(p[k], device)
                            for k in ("conv_w", "a_log", "d_skip", "dt_bias")),
                          _dense(p["out_proj"], device))
              for p in tree["mamba"]]
    shared = zamba.Shared(_attn(tree["shared"]["attn"], device),
                          _ffn(tree["shared"]["ffn"], device))
    return zamba.Zamba(_embed(tree["embed"], device), layers, shared)


# ---------------------------------------------------------------------------
# the port's flat names <-> repro's trees
# ---------------------------------------------------------------------------


def _put(tree, path: Tuple, value) -> None:
    node = tree
    for seg in path[:-1]:
        node = node[seg] if isinstance(node, list) else node.setdefault(seg, {})
    node[path[-1]] = value


class TreeLayout:
    """Flat names ↔ tree paths, one ``.``-separated segment per level: the
    layout of a plain dict of tensors (the edge model's ``{"kernel",
    "gain", "bias"}``). :func:`lm_layout` adds the LM's unit stacking."""

    def _split(self, name: str) -> Tuple[Tuple, Optional[int]]:
        """(tree path, repeat index where the leaf is stacked, else None)."""
        return tuple(name.split(".")), None

    def _join(self, path: Tuple, leaf) -> Iterator[Tuple[str, Any]]:
        yield ".".join(str(p) for p in path), leaf

    def _skeleton(self) -> dict:
        return {}

    def to_tree(self, flat: Dict[str, Any]) -> dict:
        """Flat ``{name: tensor}`` → the tree (stacked leaves: ``torch.stack``
        of the repeats, so meta tensors give a template without copies)."""
        tree, stacks = self._skeleton(), {}
        for name, t in flat.items():
            path, r = self._split(name)
            if r is None:
                _put(tree, path, t)
            else:
                stacks.setdefault(path, {})[r] = t
        for path, parts in stacks.items():
            _put(tree, path, torch.stack([parts[r] for r in sorted(parts)]))
        return tree

    def from_tree(self, tree) -> Dict[str, Any]:
        """The tree → flat ``{name: leaf}`` (a stacked leaf's repeats are
        views of it)."""
        return {name: leaf for path, t in tree_leaves(tree)
                for name, leaf in self._join(path, t)}

    def groups(self, names) -> Dict[Tuple, Tuple[list, bool]]:
        """The tree's leaves that ``names`` form: {tree path: (the names of
        its parts, in stack order, and whether it is their stack)}. An
        unstacked leaf has one part, itself."""
        parts: Dict[Tuple, Dict[Optional[int], str]] = {}
        for name in names:
            path, r = self._split(name)
            parts.setdefault(path, {})[r] = name
        return {path: ([d[None]], False) if None in d
                else ([d[r] for r in sorted(d)], True)
                for path, d in parts.items()}

    def state_to_tree(self, state: Dict[str, Any]) -> dict:
        """Optimizer state ``{"step", "mv": {key: {stat: tensor}}}`` → the
        same with ``mv`` in the tree layout, a ``{stat: ...}`` dict at each
        leaf's place. A key is a parameter's name (its statistics are
        stacked with the other repeats', as the parameter is) or a tree path
        (:func:`keyed_by_path`: the statistics of that leaf as a whole, put
        there as they are)."""
        if keyed_by_path(state):
            mv = self._skeleton()
            for path, d in state["mv"].items():
                _put(mv, path, dict(d))
            return {"step": state["step"], "mv": mv}
        return {"step": state["step"], "mv": self.to_tree(
            {f"{n}.{k}": t for n, d in state["mv"].items() for k, t in d.items()})}

    def state_from_tree(self, tree, by_path: bool = False) -> Dict[str, Any]:
        """The inverse of :meth:`state_to_tree`: ``mv`` keyed by parameter
        name, or by tree path where ``by_path``."""
        if by_path:
            mv: Dict[Any, Dict[str, Any]] = {}
            for path, t in tree_leaves(tree["mv"]):
                mv.setdefault(path[:-1], {})[path[-1]] = t
            return {"step": tree["step"], "mv": mv}
        mv = {}
        for name, t in self.from_tree(tree["mv"]).items():
            param, _, stat = name.rpartition(".")
            mv.setdefault(param, {})[stat] = t
        return {"step": tree["step"], "mv": mv}


def keyed_by_path(state: Dict[str, Any]) -> bool:
    """Whether an optimizer state's ``mv`` is keyed by tree path (a tuple,
    :func:`repro_torch.optim.adafactor`'s given a layout) and not by
    parameter name."""
    return any(isinstance(k, tuple) for k in state["mv"])


class _LMLayout(TreeLayout):
    """``layers.{i}.*`` → ``unit[i % period]`` stacked at ``i // period``
    for the layers of whole units, ``tail[...]`` for the rest."""

    def __init__(self, cfg: cm.ModelConfig):
        self.period = lm.unit_period(cfg)
        self.n_units = cfg.n_layers // self.period
        self.n_layers = cfg.n_layers

    def _skeleton(self) -> dict:
        return {"unit": [{} for _ in range(self.period if self.n_units else 0)],
                "tail": [{} for _ in range(self.n_layers
                                           - self.n_units * self.period)]}

    def _split(self, name):
        head, _, rest = name.partition(".")
        if head != "layers":
            return super()._split(name)
        idx, _, rest = rest.partition(".")
        i, tail = int(idx), tuple(rest.split("."))
        if not 0 <= i < self.n_layers:
            raise ValueError(f"{name}: layer {i} of {self.n_layers}")
        if i < self.n_units * self.period:
            return ("unit", i % self.period) + tail, i // self.period
        return ("tail", i - self.n_units * self.period) + tail, None

    def _join(self, path, leaf):
        rest = ".".join(str(p) for p in path[2:])
        if path[0] == "unit":
            if leaf.shape[0] != self.n_units:
                raise ValueError(f"{'/'.join(map(str, path))}: {leaf.shape[0]} "
                                 f"repeats, the config has {self.n_units}")
            for r in range(self.n_units):
                yield f"layers.{r * self.period + path[1]}.{rest}", leaf[r]
        elif path[0] == "tail":
            yield f"layers.{self.n_units * self.period + path[1]}.{rest}", leaf
        else:
            yield from super()._join(path, leaf)


def lm_layout(cfg: cm.ModelConfig) -> TreeLayout:
    """The layout of ``repro``'s ``lm.init_params(cfg, key)`` tree (lm and
    vlm)."""
    return _LMLayout(cfg)


class _StackedLayout(TreeLayout):
    """``<part>.{i}.*`` → ``<part>`` stacked at ``i``, for each part of
    ``stacks`` (its name → its number of layers); other names one segment
    per level."""

    def __init__(self, stacks: Dict[str, int]):
        self.stacks = stacks

    def _split(self, name):
        head, _, rest = name.partition(".")
        if head not in self.stacks:
            return super()._split(name)
        idx, _, rest = rest.partition(".")
        i = int(idx)
        if not 0 <= i < self.stacks[head]:
            raise ValueError(f"{name}: layer {i} of {self.stacks[head]}")
        return (head,) + tuple(rest.split(".")), i

    def _join(self, path, leaf):
        head = path[0]
        if head not in self.stacks:
            yield from super()._join(path, leaf)
            return
        if leaf.shape[0] != self.stacks[head]:
            raise ValueError(f"{'/'.join(map(str, path))}: {leaf.shape[0]} "
                             f"layers, the config has {self.stacks[head]}")
        rest = ".".join(str(p) for p in path[1:])
        for r in range(self.stacks[head]):
            yield f"{head}.{r}.{rest}", leaf[r]


def encdec_layout(cfg: cm.ModelConfig) -> TreeLayout:
    """The layout of ``repro``'s ``encdec.init_params(cfg, key)`` tree:
    ``enc`` and ``dec`` stacked over layers."""
    return _StackedLayout({"enc": cfg.n_encoder_layers or cfg.n_layers,
                           "dec": cfg.n_layers})


class _ListLayout(TreeLayout):
    """``<part>.{i}.*`` → ``<part>[i]`` of a Python list, for each part of
    ``lists`` (its name → its length); other names one segment per level."""

    def __init__(self, lists: Dict[str, int]):
        self.lists = lists

    def _skeleton(self) -> dict:
        return {head: [{} for _ in range(n)] for head, n in self.lists.items()}

    def _split(self, name):
        head, _, rest = name.partition(".")
        if head not in self.lists:
            return super()._split(name)
        idx, _, rest = rest.partition(".")
        i = int(idx)
        if not 0 <= i < self.lists[head]:
            raise ValueError(f"{name}: layer {i} of {self.lists[head]}")
        return (head, i) + tuple(rest.split(".")), None


def xlstm_layout(cfg: cm.ModelConfig) -> TreeLayout:
    """The layout of ``repro``'s ``xlstm.init_params(cfg, key)`` tree: a
    list of ``layers``."""
    return _ListLayout({"layers": cfg.n_layers})


def zamba_layout(cfg: cm.ModelConfig) -> TreeLayout:
    """The layout of ``repro``'s ``zamba.init_params(cfg, key)`` tree: a
    list of ``mamba`` layers and the ``shared`` block's dicts."""
    return _ListLayout({"mamba": cfg.n_layers})


def named_leaves(params) -> Dict[str, torch.Tensor]:
    """A module's parameters by name (``named_parameters``), or a flat dict
    of tensors as it is: the leaves an optimizer updates."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@torch.no_grad()
def assign_(params, flat: Dict[str, Any]) -> None:
    """Copy ``flat`` into ``params``' leaves in place, name by name; every
    leaf must be there with its shape and dtype."""
    own = named_leaves(params)
    if set(own) != set(flat):
        raise KeyError(f"leaves differ: missing {sorted(set(own) - set(flat))}, "
                       f"unknown {sorted(set(flat) - set(own))}")
    for name, t in own.items():
        src = flat[name]
        if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
            raise ValueError(f"{name}: {tuple(src.shape)} {src.dtype} does not "
                             f"fit {tuple(t.shape)} {t.dtype}")
        t.copy_(src)


def _numpy(t) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's own dtypes have no bfloat16

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def lm_params_to_jax(cfg: cm.ModelConfig, params: lm.LM) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_jax`: ``params`` as ``repro``'s
    ``lm.init_params(cfg, key)`` tree of numpy arrays."""
    return tree_map(lm_layout(cfg).to_tree(named_leaves(params)), _numpy)


def encdec_params_to_jax(cfg: cm.ModelConfig,
                         params: encdec.EncDec) -> Dict[str, Any]:
    """The inverse of :func:`encdec_params_from_jax`."""
    return tree_map(encdec_layout(cfg).to_tree(named_leaves(params)), _numpy)


def xlstm_params_to_jax(cfg: cm.ModelConfig,
                        params: xlstm.XLSTM) -> Dict[str, Any]:
    """The inverse of :func:`xlstm_params_from_jax`."""
    return tree_map(xlstm_layout(cfg).to_tree(named_leaves(params)), _numpy)


def zamba_params_to_jax(cfg: cm.ModelConfig,
                        params: zamba.Zamba) -> Dict[str, Any]:
    """The inverse of :func:`zamba_params_from_jax`."""
    return tree_map(zamba_layout(cfg).to_tree(named_leaves(params)), _numpy)


def state_to_jax(layout: TreeLayout, state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's optimizer state of a model with ``layout`` (AdamW's keyed
    by parameter name, Adafactor's by ``repro``'s leaf) as ``repro``'s
    ``{"step", "mv"}`` tree of numpy arrays."""
    return tree_map(layout.state_to_tree(state), _numpy)


def adamw_state_to_jax(cfg: cm.ModelConfig, state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's AdamW state of an LM (``repro_torch.optim.adamw``) as
    ``repro``'s ``{"step", "mv": tree of {"m", "v"}}`` of numpy arrays."""
    return state_to_jax(lm_layout(cfg), state)


def adamw_state_from_jax(cfg: cm.ModelConfig, tree: Dict[str, Any],
                         device="cpu") -> Dict[str, Any]:
    """``repro``'s AdamW state of an LM (numpy arrays) → the port's, on
    ``device``, keyed by the LM's parameter names."""
    return tree_map(lm_layout(cfg).state_from_tree(tree),
                lambda a: _tensor(a, device))
