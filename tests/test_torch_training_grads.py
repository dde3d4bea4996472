"""The port's ``loss`` and every parameter gradient against
``jax.grad`` of the JAX package's ``model.loss``, for each family the port
serves, on the CPU: the SMOKE configs of stablelm-1.6b (dense),
falcon-mamba-7b (Mamba1), zamba2-1.2b (Mamba2 with a shared attention
block) and deepseek-v3-671b (MLA + MoE), plus dense MLA and a GQA MoE with
a dense residual; float32, ``use_pallas_kernels`` off, the JAX init
bridged with ``params_from_numpy``.  And ``train_logits`` against
prefill + decode.

Tolerances: loss and metrics atol = rtol = 1e-5, every gradient atol
1e-5, rtol 1e-3 (the two frameworks sum matmuls in other orders), logits
atol = rtol = 1e-4 (those of ``tests/test_torch_model.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_get_config
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_to_numpy, tree_items, tree_map
from test_torch_training import FAMILIES, assert_trees_close, pair, tokens


# -- loss and gradients of every family --------------------------------------


def _port_grads(tm, tparams, batch):
    leaves = [p.requires_grad_(True) for _, p in tree_items(tparams)]
    loss, metrics = tm.loss(tparams, batch)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    return loss, metrics, tree_map(lambda _: next(grads), tparams)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_grad_match(family):
    m, params, tm, tparams = pair(family)
    toks = tokens(m.cfg.vocab_size)
    (jloss, jmet), jgrads = jax.value_and_grad(m.loss, has_aux=True)(
        params, {"tokens": jnp.asarray(toks)})
    loss, met, grads = _port_grads(tm, tparams,
                                   {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5,
                               rtol=1e-5)
    for k in ("nll", "aux", "ppl"):
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   atol=1e-5, rtol=1e-5)
    if family in ("moe", "mla+moe"):
        assert float(met["aux"].detach()) > 0
    assert all(g is not None for _, g in tree_items(grads))
    assert_trees_close(jax.tree.map(np.asarray, jgrads),
                       params_to_numpy(grads, tm.cfg), atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_logits_match_prefill_and_decode(family):
    """As ``tests/test_models.py::test_decode_matches_train``: the causal
    train-mode logits equal a prefill of 8 tokens then one decode step a
    token, and the JAX package's train logits."""
    m, params, tm, tparams = pair(family)
    toks = tokens(m.cfg.vocab_size, s=16, seed=2)
    with torch.no_grad():
        logits, aux = tm.train_logits(tparams,
                                      {"tokens": torch.from_numpy(toks)})
        jl, _ = m.train_logits(params, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        assert float(aux) >= 0.0
        cache = tm.init_cache(2, 24, device="cpu")
        lp, cache = tm.prefill(tparams, {"tokens": torch.from_numpy(
            toks[:, :8])}, cache)
        np.testing.assert_allclose(lp[:, 0].numpy(), logits[:, 7].numpy(),
                                   atol=1e-4, rtol=1e-4)
        for i in range(8, 16):
            ld, cache = tm.decode_step(tparams, cache,
                                       torch.from_numpy(toks[:, i:i + 1]))
            np.testing.assert_allclose(ld[:, 0].numpy(), logits[:, i].numpy(),
                                       atol=1e-4, rtol=1e-4)


def test_ssm_training_refuses_the_kernels():
    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        tcfg = dataclasses.replace(t_get_config(arch, smoke=True),
                                   use_pallas_kernels=True)
        tm = t_build_model(tcfg)
        tparams = tm.init(device="cpu")
        toks = torch.from_numpy(tokens(tcfg.vocab_size))
        with pytest.raises(RuntimeError, match="no backward"):
            tm.loss(tparams, {"tokens": toks})
        with torch.no_grad():       # serving still takes the kernel route
            cache = tm.init_cache(2, 24, device="cpu")
            tm.prefill(tparams, {"tokens": toks[:, :5]}, cache)
