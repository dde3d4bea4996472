"""AdamW and its learning-rate schedules over the port's parameter trees,
mirroring ``repro.training.optimizer``: the constant, cosine and WSD
(warmup-stable-decay) schedules, global-norm clipping, bias correction at
the step, decoupled weight decay on matrices only, moments kept in
``state_dtype`` and the update made in float32.

The state is ``{"m": tree, "v": tree, "step": int32 scalar}`` with the
params' structure.  Weight decay follows the JAX package's layout: there a
repeated group's layer params are stacked on a leading ``reps`` axis, so a
leaf under ``stack/group`` is decayed when it has one dimension or more.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import torch

from repro_torch.models.convert import tree_items, tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"          # constant | cosine | wsd
    warmup_steps: int = 100
    total_steps: int = 1000
    # WSD: stable until decay_start, then linear decay to lr_min
    decay_start_frac: float = 0.8
    lr_min_frac: float = 0.1
    # moment dtype: 'float32' (default) or 'bfloat16'
    state_dtype: str = "float32"


def schedule_fn(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an integer tensor) -> learning rate, float32, on its device."""
    def fn(step):
        step = torch.as_tensor(step).to(F32)
        one = torch.ones((), dtype=F32, device=step.device)
        warm = torch.minimum(one, (step + 1) / max(1, cfg.warmup_steps))
        if cfg.schedule == "constant":
            main = one
        elif cfg.schedule == "cosine":
            frac = torch.clamp((step - cfg.warmup_steps)
                               / max(1, cfg.total_steps - cfg.warmup_steps),
                               0.0, 1.0)
            main = 0.5 * (1 + torch.cos(math.pi * frac)) \
                * (1 - cfg.lr_min_frac) + cfg.lr_min_frac
        elif cfg.schedule == "wsd":
            decay_start = cfg.decay_start_frac * cfg.total_steps
            frac = torch.clamp((step - decay_start)
                               / max(1.0, cfg.total_steps - decay_start),
                               0.0, 1.0)
            main = (1 - frac) * 1.0 + frac * cfg.lr_min_frac
        else:
            raise ValueError(cfg.schedule)
        return cfg.lr * warm * main
    return fn


def init_state(params, cfg: AdamWConfig = None) -> Dict[str, Any]:
    dt = DTYPES[cfg.state_dtype] if cfg is not None else F32
    # zeros_like keeps a DTensor's mesh and placements: moments shard
    # like their params
    zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=dt), params)
    first = next(v for _, v in tree_items(params))
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def _decayed(path, p: torch.Tensor) -> bool:
    """A matrix in the JAX package's layout, where ``stack/group`` leaves
    carry a leading ``reps`` axis and ``encoder/blocks`` leaves a layer
    axis."""
    stacked = tuple(path[:2]) in (("stack", "group"), ("encoder", "blocks"))
    return p.dim() + stacked >= 2


def _placed_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` with ``like``'s DTensor placements: an update of a shard (whose
    gradient arrives as a partial sum, or the moments' elementwise ops)
    may come out placed otherwise, and the next step must find every
    param and moment sharded by its spec again.  Plain tensors pass."""
    if getattr(like, "placements", None) is None \
            or tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step -> (new params, new state, metrics {"lr",
    "grad_norm"}).  ``grads`` has the params' structure; nothing is updated
    in place."""
    step = state["step"] + 1
    lr = schedule_fn(cfg)(step)
    stepf = step.to(F32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=stepf.device),
                        stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=stepf.device),
                        stepf)

    # global-norm clip
    gnorm = torch.sqrt(sum(torch.sum(g.to(F32) ** 2)
                           for _, g in tree_items(grads)))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    sdt = DTYPES[cfg.state_dtype]
    new_p, new_m, new_v = {}, {}, {}
    flat_g = dict(tree_items(grads))
    flat_m = dict(tree_items(state["m"]))
    flat_v = dict(tree_items(state["v"]))
    for path, p in tree_items(params):
        g = flat_g[path].to(F32) * scale
        m = cfg.b1 * flat_m[path].to(F32) + (1 - cfg.b1) * g
        v = cfg.b2 * flat_v[path].to(F32) + (1 - cfg.b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if _decayed(path, p):  # matrices only (norms/bias exempt)
            delta = delta + cfg.weight_decay * p.to(F32)
        new_p[path] = _placed_like((p.to(F32) - lr * delta).to(p.dtype), p)
        new_m[path] = _placed_like(m.to(sdt), flat_m[path])
        new_v[path] = _placed_like(v.to(sdt), flat_v[path])
    rebuild = lambda flat: tree_map(lambda _, path: flat[path], params,
                                    with_path=True)
    return rebuild(new_p), {"m": rebuild(new_m), "v": rebuild(new_v),
                            "step": step}, {"lr": lr, "grad_norm": gnorm}
