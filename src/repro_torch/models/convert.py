"""Bridge from ``repro``'s parameter pytree to the port's parameters.

The JAX package stacks a repeated group's layer params on a leading
``reps`` axis; the port keeps one dict per layer.  A ``shared_attn``
block's weights live once at ``stack["shared_attn"]`` (its group slot is
empty).  Leaves arrive as numpy arrays (a caller converts them with
``np.asarray``; bf16 leaves cross as float32, which holds every bf16 value
exactly) and are cast to the config's dtype on ``device``, except the
leaves the JAX package keeps in float32 whatever the config's dtype
(``F32_LEAVES``: the SSM parameters and the MoE router), which stay
float32.  This module imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import torch_dtype

# parameters kept in float32 in every config: the SSM's
# (``repro.models.ssm``) and the MoE router (``repro.models.layers``)
F32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _leaves(tree, fn, name=""):
    """Map ``fn(leaf, key)`` over a nested dict/list tree; ``key`` is the
    innermost dict key above the leaf."""
    if isinstance(tree, dict):
        return {k: _leaves(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaves(v, fn, name) for v in tree]
    return fn(tree, name)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda") -> Dict[str, Any]:
    """``repro`` params (numpy leaves) -> the port's params on ``device``
    (the card by default; without one it raises unless given
    ``device="cpu"``)."""
    dt = torch_dtype(cfg)
    dev = resolve_device(device)

    def to_t(a, name):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=torch.float32 if name in F32_LEAVES else dt)

    out = {k: _leaves(v, to_t) for k, v in tree.items() if k != "stack"}
    stack = tree["stack"]
    _, reps, _, _ = cfg.layer_program
    out["stack"] = {
        "head": _leaves(list(stack["head"]), to_t),
        "tail": _leaves(list(stack["tail"]), to_t),
        # an empty slot (a shared block's) stays an empty list
        "group": {name: ([_leaves(g, lambda a, k, r=r: to_t(
                              np.asarray(a)[r], k)) for r in range(reps)]
                         if g else [])
                  for name, g in stack["group"].items()},
    }
    if "shared_attn" in stack:
        out["stack"]["shared_attn"] = _leaves(stack["shared_attn"], to_t)
    return out
