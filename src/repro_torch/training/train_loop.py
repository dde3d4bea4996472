"""Single-device training loop of the port, mirroring
``repro.training.train_loop``: a step takes the loss's gradient of every
parameter by autograd and applies AdamW.

Params are leaf tensors that require grad while a step runs; the new params
a step returns require grad again, and ``train`` hands back detached ones,
so that serving never records an autograd graph (the kernels refuse
operands that require grad, and the fused loop's CUDA graph holds none).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models.convert import tree_items, tree_map
from repro_torch.models.model import Model, cross_entropy
from repro_torch.training import optimizer as opt


def requiring_grad(params):
    """``params`` as leaf tensors that require grad (detached copies of no
    memory: views of the same storage)."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def detached(params):
    return tree_map(lambda p: p.detach(), params)


def make_loss_fn(model: Model):
    """loss_fn(params, batch) -> (loss, metrics).  A batch with ``labels``
    (prompt-masked task rows) scores ``labels`` against the logits of
    ``tokens[:, :-1]``; otherwise ``model.loss``."""
    def loss_fn(params, batch):
        if "labels" in batch:
            inputs = {k: v for k, v in batch.items() if k != "labels"}
            inputs["tokens"] = batch["tokens"][:, :-1]
            logits, aux = model.train_logits(params, inputs)
            labels = batch["labels"]
            if logits.shape[1] != labels.shape[1]:
                logits = logits[:, -labels.shape[1]:]
            nll = cross_entropy(logits, labels)
            return nll + aux, {"nll": nll, "aux": aux}
        return model.loss(params, batch)

    return loss_fn


def loss_and_grads(loss_fn, params, batch):
    """(params as leaves that require grad, loss, metrics, grads with the
    params' structure; a parameter the loss does not reach gets zeros)."""
    params = requiring_grad(params)
    loss, metrics = loss_fn(params, batch)
    paths, leaves = zip(*tree_items(params))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    flat = {path: torch.zeros_like(p) if g is None else g
            for path, p, g in zip(paths, leaves, grads)}
    return params, loss, metrics, tree_map(lambda _, path: flat[path],
                                           params, with_path=True)


def make_train_step(model: Model, ocfg: opt.AdamWConfig):
    """step(params, state, batch) -> (new params, new state, metrics);
    ``batch`` maps names to tensors on the params' device (see
    :func:`make_loss_fn`)."""
    loss_fn = make_loss_fn(model)

    def step(params, state, batch):
        # DTensor params (a mesh's shards) meet plain tensors made inside
        # the model (positions, masks, constants): those count as
        # replicated on every rank; plain params are unaffected
        with implicit_replication():
            params, loss, metrics, grads = loss_and_grads(loss_fn, params,
                                                          batch)
            new_params, new_state, om = opt.apply_updates(params, grads,
                                                          state, ocfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return requiring_grad(new_params), new_state, {
            "loss": loss.detach(), **metrics, **om}

    return step


def full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective every rank must join), a plain
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def train(model: Model, params, data_iter: Iterator[Dict], steps: int,
          ocfg: Optional[opt.AdamWConfig] = None, log_every: int = 20,
          log_fn: Callable[[str], None] = print):
    """``steps`` AdamW steps over numpy batches from ``data_iter`` on the
    params' device -> (detached params, state, history of logged metrics)."""
    ocfg = ocfg or opt.AdamWConfig()
    state = opt.init_state(params)
    step_fn = make_train_step(model, ocfg)
    device = next(p for _, p in tree_items(params)).device
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = to_device(next(data_iter), device)
        params, state, metrics = step_fn(params, state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            log_fn(f"step {i:5d} loss={m['loss']:.4f} nll={m['nll']:.4f} "
                   f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f} "
                   f"({time.perf_counter()-t0:.1f}s)")
    return detached(params), state, history
