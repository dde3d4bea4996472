"""Bridge between ``repro``'s parameter pytree and the port's parameters,
both ways (``params_from_numpy``, ``params_to_numpy``; an AdamW state's
moments too).

The JAX package stacks a repeated group's layer params on a leading
``reps`` axis, and an encoder-decoder's encoder blocks
(``encoder["blocks"]``) on a leading layer axis; the port keeps one dict
per layer in both.  A ``shared_attn``
block's weights live once at ``stack["shared_attn"]`` (its group slot is
empty).  Leaves arrive as numpy arrays (a caller converts them with
``np.asarray``; bf16 leaves cross as float32, which holds every bf16 value
exactly) and are cast to the config's dtype on ``device``, except the
leaves the JAX package keeps in float32 whatever the config's dtype
(``F32_LEAVES``: the SSM parameters and the MoE router), which stay
float32.  Going back, the group's layers are stacked again and bf16
leaves leave as float32, so a round trip is bitwise.  This module imports
no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import torch_dtype

# parameters kept in float32 in every config: the SSM's
# (``repro.models.ssm``) and the MoE router (``repro.models.layers``)
F32_LEAVES = ("A_log", "D", "dt_bias", "router")


def tree_items(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of a nested dict/list tree, depth first; a path
    is the tuple of dict keys and list indices down to the leaf (a tuple
    is a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn, tree, with_path: bool = False, path: Tuple = ()):
    """``fn(leaf)`` (or ``fn(leaf, path)``) over a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, with_path, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, with_path, path + (i,))
                for i, v in enumerate(tree)]
    return fn(tree, path) if with_path else fn(tree)


def _stack(fn, trees):
    """``fn([leaf of each tree])`` over trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack(fn, [t[k] for t in trees]) for k in first}
    return fn(trees)


def reference_layout(params: Dict[str, Any], leaf, stack,
                     reps: Optional[int] = None) -> Dict[str, Any]:
    """The port's params in ``repro``'s layout: ``leaf(tensor)`` on every
    leaf, the group's per-layer leaves joined by ``stack(list)``, a
    shared block's empty group slot an empty dict."""
    out = {k: tree_map(leaf, v) for k, v in params.items()
           if k not in ("stack", "encoder")}
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "blocks": _stack(stack, [tree_map(leaf, b)
                                     for b in enc["blocks"]]),
            "norm": tree_map(leaf, enc["norm"])}
    st = params["stack"]
    group = {}
    for name, layers in st["group"].items():
        if reps is not None and layers and len(layers) != reps:
            raise ValueError(f"group slot {name} holds {len(layers)} layers, "
                             f"the config repeats the group {reps} times")
        group[name] = (_stack(stack, [tree_map(leaf, l) for l in layers])
                       if layers else {})
    out["stack"] = {"head": [tree_map(leaf, b) for b in st["head"]],
                    "tail": [tree_map(leaf, b) for b in st["tail"]],
                    "group": group}
    if "shared_attn" in st:
        out["stack"]["shared_attn"] = tree_map(leaf, st["shared_attn"])
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.to(torch.float32)         # exact; numpy has no bfloat16
    return t.numpy()


def params_to_numpy(params: Dict[str, Any],
                    cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """The port's params -> ``repro``'s params as numpy leaves: the group's
    layers stacked on a leading ``reps`` axis (checked against ``cfg``'s
    when given), ``shared_attn`` once at ``stack["shared_attn"]``."""
    reps = cfg.layer_program[1] if cfg is not None else None
    return reference_layout(params, _to_numpy, np.stack, reps)


def state_to_numpy(state: Dict[str, Any],
                   cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """An AdamW state (``m``, ``v``, ``step``) -> ``repro``'s layout."""
    return {"m": params_to_numpy(state["m"], cfg),
            "v": params_to_numpy(state["v"], cfg),
            "step": np.asarray(state["step"].detach().cpu().numpy(),
                               np.int32)}


def state_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device="cuda",
                     state_dtype: str = "float32") -> Dict[str, Any]:
    """``repro``'s AdamW state -> the port's, moments in ``state_dtype``."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[state_dtype]
    dev = resolve_device(device)
    return {"m": params_from_numpy(tree["m"], cfg, dev, dtype=dt),
            "v": params_from_numpy(tree["v"], cfg, dev, dtype=dt),
            "step": torch.as_tensor(np.asarray(tree["step"], np.int32),
                                    device=dev)}


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda", dtype=None) -> Dict[str, Any]:
    """``repro`` params (numpy leaves) -> the port's params on ``device``
    (the card by default; without one it raises unless given
    ``device="cpu"``), in the config's dtypes or, given ``dtype``, all in
    that one."""
    dev = resolve_device(device)

    def to_t(a, path):
        # a leaf's kind is the innermost dict key above it
        want = dtype if dtype is not None else (
            torch.float32 if path[-1] in F32_LEAVES else torch_dtype(cfg))
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=want)

    def conv(t, path=()):
        return tree_map(to_t, t, with_path=True, path=path)

    def unstack(g, n):
        return [tree_map(lambda a, path, r=r: to_t(np.asarray(a)[r], path),
                         g, with_path=True) for r in range(n)]

    out = {k: conv(v, (k,)) for k, v in tree.items()
           if k not in ("stack", "encoder")}
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"blocks": unstack(enc["blocks"],
                                            cfg.n_encoder_layers),
                          "norm": conv(enc["norm"], ("encoder", "norm"))}
    stack = tree["stack"]
    _, reps, _, _ = cfg.layer_program
    out["stack"] = {
        "head": conv(list(stack["head"])),
        "tail": conv(list(stack["tail"])),
        # an empty slot (a shared block's) stays an empty list
        "group": {name: (unstack(g, reps) if g else [])
                  for name, g in stack["group"].items()},
    }
    if "shared_attn" in stack:
        out["stack"]["shared_attn"] = conv(stack["shared_attn"])
    return out
