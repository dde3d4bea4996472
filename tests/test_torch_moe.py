"""The port's MoE FFN against ``repro``'s on the same weights and inputs:
``moe_apply`` (its output and router aux loss) at decode with forced
capacity drops, at 4096 tokens (two dispatch groups), with deepseek's
shared expert and with arctic's dense residual; the tie order of the
top-k; the GQA + MoE model config of ``tests/test_models.py`` through
prefill and decode; and two bridge
repairs: the float32 router survives a bfloat16 config, and ``moe_init``
draws the expert stacks one expert at a time.  float32; atol = rtol = 1e-4
for floats."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig, MoEConfig
from repro.models import build_model
from repro.models import layers as jl
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.models import build_model as t_build_model
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab_size=128, dtype="float32", max_seq_len=64)


def _cfgs(**moe):
    kw = dict(BASE, arch_id="tmoe", family="moe", group=("moe",))
    return (ModelConfig(moe=MoEConfig(**moe), **kw),
            TModelConfig(moe=TMoEConfig(**moe), **kw))


def _moe_pair(**moe):
    """(JAX cfg, JAX layer-0 MoE params, port cfg, port params)."""
    cfg, tcfg = _cfgs(**moe)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    jp = jax.tree.map(lambda a: a[0], params["stack"]["group"]["b0"]["moe"])
    return cfg, jp, tcfg, tparams["stack"]["group"]["b0"][0]["moe"]


def _x(b, s, seed, d=32):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _drops(cfg, router, x):
    """How many (token, slot) pairs the reference's capacity drops."""
    mo = cfg.moe
    n = x.shape[0] * x.shape[1]
    g = n // jl.MOE_GROUP_TOKENS if n % jl.MOE_GROUP_TOKENS == 0 else 1
    ng = n // g
    cap = min(ng, max(1, int(np.ceil(ng * mo.top_k / mo.n_experts
                                     * mo.capacity_factor))))
    logits = x.reshape(g, ng, -1) @ np.asarray(router)
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :mo.top_k]
    counts = np.stack([np.bincount(t.ravel(), minlength=mo.n_experts)
                       for t in top])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("moe,b,s", [
    # decode, B=4: cap = ceil(4*2/8*1.0) = 1, so colliding rows drop
    (dict(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=1.0), 4, 1),
    # deepseek-like: a shared expert, a few tokens of prefill
    (dict(n_experts=4, top_k=2, d_ff_expert=16, n_shared_experts=1,
          capacity_factor=0.5), 2, 5),
    # arctic-like: a dense residual FFN
    (dict(n_experts=4, top_k=2, d_ff_expert=16, dense_residual_d_ff=24,
          capacity_factor=0.5), 1, 7),
])
def test_moe_apply_matches_with_drops(moe, b, s):
    cfg, jp, tcfg, tp = _moe_pair(**moe)
    x = _x(b, s, seed=b * 10 + s)
    want, want_aux = jl.moe_apply(jp, cfg, jnp.asarray(x))
    got, aux = tl.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert _drops(cfg, jp["router"], x) > 0, \
        "the case must drop some (token, slot) pairs"


def test_moe_apply_matches_at_4096_tokens():
    """4096 tokens split into two dispatch groups of 2048 (g = 2)."""
    cfg, jp, tcfg, tp = _moe_pair(n_experts=4, top_k=2, d_ff_expert=16,
                                  n_shared_experts=1, capacity_factor=1.0)
    x = _x(2, 2048, seed=7, d=32)
    assert (x.shape[0] * x.shape[1]) // jl.MOE_GROUP_TOKENS == 2
    want, want_aux = jl.moe_apply(jp, cfg, jnp.asarray(x))
    got, aux = tl.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_top_k_breaks_ties_by_lowest_index():
    probs = np.array([[[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]],
                      [[0.25, 0.25, 0.25, 0.25, 0.0, 0.0]]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tl._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("ragged", [False, True])
def test_gqa_moe_model_matches(ragged):
    """``tests/test_models.py``'s "moe" config: GQA attention, a shared
    expert and a dense residual, through prefill and decode."""
    moe = dict(n_experts=4, top_k=2, d_ff_expert=64, n_shared_experts=1,
               dense_residual_d_ff=32, capacity_factor=2.0)
    cfg, tcfg = _cfgs(**moe)
    m, tm = build_model(cfg), t_build_model(tcfg)
    params = m.init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    toks = np.random.default_rng(2).integers(0, 128, (2, 12)).astype(
        np.int32)
    c1, c2 = m.init_cache(2, 32), tm.init_cache(2, 32, device="cpu")
    l1, c1 = m.prefill(params, {"tokens": jnp.asarray(toks[:, :6])}, c1)
    l2, c2 = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :6])},
                        c2)
    np.testing.assert_allclose(l2.numpy(), np.asarray(l1), **TOL)
    if ragged:
        c1["len"] = jnp.asarray([6, 3], jnp.int32)
        c2["len"] = torch.tensor([6, 3], dtype=torch.int32)
    for i in range(6, 9):
        d1, c1 = m.decode_step(params, c1, jnp.asarray(toks[:, i:i + 1]))
        d2, c2 = tm.decode_step(tparams, c2, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(d2.numpy(), np.asarray(d1), **TOL)


def test_router_stays_float32_under_bfloat16():
    moe = dict(n_experts=4, top_k=2, d_ff_expert=16)
    cfg, tcfg = _cfgs(**moe)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tcfg_bf = dataclasses.replace(tcfg, dtype="bfloat16")
    tp = params_from_numpy(jax.tree.map(np.asarray, params), tcfg_bf,
                           device="cpu")
    layer = tp["stack"]["group"]["b0"][0]["moe"]
    assert layer["router"].dtype == torch.float32
    assert layer["w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        layer["router"].numpy(),
        np.asarray(params["stack"]["group"]["b0"]["moe"]["router"][0]))


def test_moe_init_draws_one_expert_at_a_time(monkeypatch):
    """No draw the size of a whole (E, d, f) stack: each expert's slice is
    drawn, scaled in place and cast on its own; the stacks have the
    reference's shapes, dtypes and scale (1/sqrt(E))."""
    e, d, f = 16, 32, 24
    sizes = []
    randn = torch.randn

    def spy(*args, **kw):
        out = randn(*args, **kw)
        sizes.append(out.numel())
        return out
    monkeypatch.setattr(torch, "randn", spy)
    _, tcfg = _cfgs(n_experts=e, top_k=2, d_ff_expert=f, n_shared_experts=1)
    gen = torch.Generator()
    gen.manual_seed(0)
    p = tl.moe_init(gen, tcfg, "cpu")
    assert max(sizes) < e * d * f
    assert max(sizes) == max(d * f, d * e)
    for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                        ("w_down", (e, f, d))):
        assert tuple(p[name].shape) == shape
        assert p[name].dtype == torch.float32
        assert abs(p[name].std().item() - 1 / np.sqrt(e)) < 0.02
    assert p["router"].dtype == torch.float32
