"""Carry the reference's weights and train state across to the port, and
back.

The reference's ``transformer.init_params`` tree (the dense, moe, vlm and
audio families, plain or gemma3's grouped stack, the mamba1 stack, or the
hybrid stack's ``mamba_groups`` [G, k, ...] and its one ``shared_attn``
layer), already turned into numpy arrays by the caller, maps onto the
port's parameter dict so that both packages compute the same function.  Both keep each
stack's layers on leading axes (``layers`` [L, ...]; ``local_layers`` [G,
P, ...] and ``global_layers`` [G, ...]), the ``x @ W`` layout of the
attention (and its ``bq``/``bk``/``bv`` biases), SwiGLU, expert and
mamba1 matrices, norm weights ``w`` under the ``(1 + w)`` convention, a
tied head read as ``embed.T`` (an untied one as ``lm_head``) and the
frontends' ``patch_proj`` and ``frame_proj``; only the nesting differs (the reference
groups ``attn``/``mlp``/``moe``/``mamba`` sub-dicts per layer).  mamba1's
``A_log`` and ``D``, mamba2's ``A_log``, ``D`` and ``dt_bias`` and the moe
``router`` stay fp32 whatever the param dtype, as in the reference.

:func:`reference_tree` gives the port's params (or gradients) the
reference's nesting, whose flatten order (sorted keys) decides the
gradient buckets and so the int8 blocks of the compressed sync.

A train state crosses in either direction (:func:`train_state_from_reference`,
:func:`train_state_to_reference`) for every grad-sync layout: the ZeRO-1
rows (``mrd_paper``, ``mrd_zero1``, ``compressed``), ``mrd_leaf``'s
replicated tree-shaped optimizer and ``local_sgd``'s ``[dp, ...]`` stacked
params and optimizer; the checkpointer writes the reference's layout.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models import moe, ssm
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import STACKS


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype, copy=True)
    # through fp32: numpy has no bfloat16, and bf16 -> fp32 -> bf16 is exact
    return torch.from_numpy(np.array(x, np.float32)).to(device=device, dtype=dtype)


# the port's layer key -> its path under the reference's per-layer dict
ATTN_PATHS = {
    **{k: ("attn", k) for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")},
    "ln1": ("ln1",), "ln2": ("ln2",),
}
LAYER_PATHS = {**ATTN_PATHS, **{k: ("mlp", k) for k in ("w1", "w3", "w2")}}
MOE_LAYER_PATHS = {**ATTN_PATHS, **{k: ("moe", k) for k in moe.LEAVES}}
SSM_LAYER_PATHS = {"ln": ("ln",), **{k: ("mamba", k) for k in (
    "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D", "out_proj")}}
MAMBA2_LAYER_PATHS = {"ln": ("ln",), **{k: ("mamba", k) for k in (
    "in_z", "in_x", "in_bc", "in_dt", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w",
    "out_proj")}}
# parameter trees with per-layer nesting: the stacks and the hybrid stack's
# one shared layer
LAYER_TREES = (*STACKS, "shared_attn")
# leaves kept in fp32, by tree (the plain ``layers`` stack: mamba1's and moe's)
FP32_LEAVES = {"mamba_groups": ssm.MAMBA2_FP32_LEAVES}
PLAIN_FP32_LEAVES = ssm.FP32_LEAVES + moe.FP32_LEAVES


def _paths(tree: str, keys) -> dict[str, tuple]:
    """The path table of a parameter tree, by its name; the plain
    ``layers`` stack holds the mamba1, moe or attention family, which its
    leaves tell apart (mamba1's ``in_proj`` and moe's ``router`` belong to
    no other family of that stack)."""
    if tree == "mamba_groups":
        return MAMBA2_LAYER_PATHS
    if tree != "layers":  # the grouped stack's and the shared attention layer
        return LAYER_PATHS
    return (SSM_LAYER_PATHS if "in_proj" in keys
            else MOE_LAYER_PATHS if "router" in keys else LAYER_PATHS)


def _nest(tree: str, flat: Mapping[str, Any]) -> dict[str, Any]:
    paths = _paths(tree, flat)
    nested: dict[str, Any] = {}
    for k, path in paths.items():
        if k not in flat:  # the qkv biases exist only with qkv_bias
            continue
        node = nested
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = flat[k]
    return nested


def _unnest(tree: str, nested: Mapping[str, Any]) -> dict[str, Any]:
    def get(path):
        node = nested
        for part in path:
            if part not in node:
                return None
            node = node[part]
        return node

    keys = {*nested.get("mamba", ()), *nested.get("moe", ())}
    out = {k: get(path) for k, path in _paths(tree, keys).items()}
    return {k: v for k, v in out.items() if v is not None}


def reference_tree(params: Mapping[str, Any]) -> dict[str, Any]:
    """The port's params (or any tree of the same keys) nested as the
    reference nests them; the leaves are the same objects."""
    return {k: _nest(k, v) if k in LAYER_TREES else v for k, v in params.items()}


def port_tree(tree: Mapping[str, Any]) -> dict[str, Any]:
    """Inverse of :func:`reference_tree`."""
    return {k: _unnest(k, v) if k in LAYER_TREES else v for k, v in tree.items()}


def params_from_reference(np_params: Mapping[str, Any], cfg: ModelConfig,
                          device="cuda") -> dict[str, Any]:
    """Reference params (numpy leaves) -> the port's params on ``device``."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    if cfg.family == "hybrid":
        leads = {"mamba_groups": (cfg.n_groups, cfg.attn_every), "shared_attn": ()}
    elif cfg.pattern_local:
        leads = {"local_layers": (cfg.n_groups, cfg.pattern_local),
                 "global_layers": (cfg.n_groups,)}
    else:
        leads = {"layers": (cfg.n_layers,)}
    src = port_tree(np_params)
    out = {
        "embed": _tensor(np_params["embed"], dtype, device),
        "final_norm": _tensor(np_params["final_norm"], dtype, device),
    }
    for stack, lead in leads.items():
        for name, leaf in src[stack].items():
            if tuple(np.shape(leaf)[:len(lead)]) != lead:
                raise ValueError(f"{stack} leaf {name}: leading axes {np.shape(leaf)} "
                                 f"do not start with {lead}")
        fp32 = FP32_LEAVES.get(stack, PLAIN_FP32_LEAVES)
        out[stack] = {k: _tensor(v, torch.float32 if k in fp32 else dtype, device)
                      for k, v in src[stack].items()}
    for name in ("lm_head", "patch_proj", "frame_proj"):  # untied head, frontends
        if name in np_params:
            out[name] = _tensor(np_params[name], dtype, device)
    return out


def _numpy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stacked_params(np_params: Mapping[str, Any], cfg: ModelConfig, dp: int, device):
    """A ``[dp, ...]`` stacked reference param tree -> the port's, each
    leaf stacked ``[dp, ...]`` (``local_sgd``'s replicas)."""
    ranks = [params_from_reference(_map(lambda t, r=r: t[r], np_params), cfg, device)
             for r in range(dp)]
    return _map(lambda *leaves: torch.stack(leaves), *ranks)


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(trees[0], Mapping):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def sync_layout(state: Mapping[str, Any]) -> str:
    """The grad-sync layout of a train state (the port's or the
    reference's): ``"zero1"`` (``opt`` rows [dp, m]), ``"leaf"`` (a
    replicated tree-shaped ``opt``) or ``"local"`` (``[dp, ...]`` stacked
    params and ``opt``)."""
    if not isinstance(state["opt"]["master"], Mapping):
        return "zero1"
    embed = state["opt"]["master"]["embed"]
    return "local" if np.ndim(embed) == 3 else "leaf"


def train_state_from_reference(state: Mapping[str, Any], cfg: ModelConfig,
                               device="cuda") -> dict[str, Any]:
    """A reference train state (numpy leaves, or CPU tensors for leaves
    numpy cannot hold, bf16) -> the port's: params, ``opt``, ``step`` and
    the ``monitor`` rows.  ``opt`` is ``master``/``mu``/``nu`` [dp, m] rows
    (and ``ef`` under the compressed sync) for the ZeRO-1 modes, fp32
    trees in the params' layout for ``mrd_leaf``, and both params and
    ``opt`` trees stacked ``[dp, ...]`` for ``local_sgd``.  Both sides then
    start the same step from the same state."""
    device = resolve_device(device)

    def f32(x):
        return _tensor(x, torch.float32, device)

    layout = sync_layout(state)
    if layout == "local":
        dp = np.shape(state["opt"]["master"]["embed"])[0]
        out = {
            "params": _stacked_params(state["params"], cfg, dp, device),
            "opt": {k: _map(f32, port_tree(v)) for k, v in state["opt"].items()},
        }
    else:
        out = {"params": params_from_reference(state["params"], cfg, device),
               "opt": {k: f32(v) if layout == "zero1" else _map(f32, port_tree(v))
                       for k, v in state["opt"].items()}}
    out["step"] = int(_numpy(state["step"]))
    if state.get("monitor") is not None:
        out["monitor"] = monitor_from_reference(state["monitor"], device)
    return out


def monitor_from_reference(mon: Mapping[str, Any], device="cuda") -> dict[str, Any]:
    """A reference monitor state (its ``[dp]`` rows) -> the port's."""
    device = resolve_device(device)
    nb = mon["nb"]

    def f32(x):
        return _tensor(x, torch.float32, device)

    return {
        # the reference keeps the counters per rank; they agree
        "nb": {"stage": int(_numpy(nb["stage"])[0]), "buf": f32(nb["buf"]),
               "result": f32(nb["result"]), "flag": bool(_numpy(nb["flag"])[0]),
               "cycles": int(_numpy(nb["cycles"])[0])},
        "m": {k: f32(v) for k, v in mon.get("m", {}).items()},
        "value": f32(mon["value"]),
        "done": torch.as_tensor(_numpy(mon["done"]), dtype=torch.bool).to(device),
    }


def train_state_to_reference(state: Mapping[str, Any]) -> dict[str, Any]:
    """The inverse of :func:`train_state_from_reference`: the port's train
    state as the reference nests it, leaves still the port's tensors on
    their device (the step a 0-d int32 tensor, the monitor's counters
    ``[dp]`` rows, as the reference keeps them), so that a checkpoint of
    it has the reference's keys, shapes and types."""
    out = {"params": reference_tree(state["params"]),
           "opt": {k: reference_tree(v) if isinstance(v, Mapping) else v
                   for k, v in state["opt"].items()},
           "step": torch.tensor(state["step"], dtype=torch.int32)}
    mon = state.get("monitor")
    if mon is not None:
        nb = mon["nb"]
        dp, dev = mon["done"].shape[0], mon["done"].device

        def rows(v, dtype):
            return torch.full((dp,), v, dtype=dtype, device=dev)

        out["monitor"] = {
            "nb": {"stage": rows(nb["stage"], torch.int32), "buf": nb["buf"],
                   "result": nb["result"], "flag": rows(nb["flag"], torch.bool),
                   "cycles": rows(nb["cycles"], torch.int32)},
            **({"m": dict(mon["m"])} if mon.get("m") else {}),
            "value": mon["value"], "done": mon["done"],
        }
    return out


def rank_state_to_reference(state: Mapping[str, Any], *,
                            replica: bool = False) -> tuple[dict[str, Any], tuple[str, ...]]:
    """A world rank's train state (one process a rank) as the reference
    nests it, and the top-level parts whose leaves are this rank's rows of
    the reference's ``[dp, ...]`` leaves: the optimizer rows and the
    monitor's (the ZeRO-1 modes), the monitor's (``mrd_leaf``, whose
    optimizer trees are replicated), or the replica's params and optimizer
    trees (``local_sgd``: ``replica``).  The other parts are the same on
    every rank.  Stacking the rows of every rank gives
    :func:`train_state_to_reference` of the stacked-rows state."""
    out = {"params": reference_tree(state["params"]),
           "opt": {k: reference_tree(v) if isinstance(v, Mapping) else v
                   for k, v in state["opt"].items()},
           "step": torch.tensor(state["step"], dtype=torch.int32)}
    mon = state.get("monitor")
    if mon is not None:
        nb, dev = mon["nb"], mon["done"].device
        out["monitor"] = {
            "nb": {"stage": torch.tensor(nb["stage"], dtype=torch.int32, device=dev),
                   "buf": nb["buf"], "result": nb["result"],
                   "flag": torch.tensor(bool(nb["flag"]), device=dev),
                   "cycles": torch.tensor(nb["cycles"], dtype=torch.int32, device=dev)},
            **({"m": dict(mon["m"])} if mon.get("m") else {}),
            "value": mon["value"], "done": mon["done"],
        }
    if replica:
        rows = ("params", "opt")
    elif isinstance(state["opt"]["master"], Mapping):
        rows = ("monitor",)
    else:
        rows = ("opt", "monitor")
    return out, rows


def rank_state_from_reference(state: Mapping[str, Any], cfg: ModelConfig,
                              device="cuda") -> dict[str, Any]:
    """The inverse of :func:`rank_state_to_reference`: a rank's part of a
    reference train state (its rows unstacked) -> the world rank's state."""
    device = resolve_device(device)

    def f32(x):
        return _tensor(x, torch.float32, device)

    zero1 = not isinstance(state["opt"]["master"], Mapping)
    out = {"params": params_from_reference(state["params"], cfg, device),
           "opt": {k: f32(v) if zero1 else _map(f32, port_tree(v))
                   for k, v in state["opt"].items()},
           "step": int(_numpy(state["step"]))}
    mon = state.get("monitor")
    if mon is not None:
        nb = mon["nb"]
        out["monitor"] = {
            "nb": {"stage": int(_numpy(nb["stage"])), "buf": f32(nb["buf"]),
                   "result": f32(nb["result"]), "flag": bool(_numpy(nb["flag"])),
                   "cycles": int(_numpy(nb["cycles"]))},
            "m": {k: f32(v) for k, v in mon.get("m", {}).items()},
            "value": f32(mon["value"]),
            "done": torch.as_tensor(_numpy(mon["done"]), dtype=torch.bool).to(device),
        }
    return out
