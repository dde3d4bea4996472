"""Bridge from ``repro``'s parameter pytree to the port's parameters.

The JAX package stacks a repeated group's layer params on a leading
``reps`` axis; the port keeps one dict per layer.  Leaves arrive as numpy
arrays (a caller converts them with ``np.asarray``; bf16 leaves cross as
float32, which holds every bf16 value exactly) and are cast to the
config's dtype on ``device``.  This module imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype


def _leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaves(v, fn) for v in tree]
    return fn(tree)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cpu") -> Dict[str, Any]:
    """``repro`` params (numpy leaves) -> the port's params on ``device``."""
    dt = torch_dtype(cfg)
    dev = torch.device(device)

    def to_t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dt)

    out = {k: _leaves(v, to_t) for k, v in tree.items() if k != "stack"}
    stack = tree["stack"]
    _, reps, _, _ = cfg.layer_program
    out["stack"] = {
        "head": _leaves(list(stack["head"]), to_t),
        "tail": _leaves(list(stack["tail"]), to_t),
        "group": {name: [_leaves(g, lambda a, r=r: to_t(np.asarray(a)[r]))
                         for r in range(reps)]
                  for name, g in stack["group"].items()},
    }
    return out
