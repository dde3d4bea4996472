"""The port's training path (the flash backward, ``cross_entropy``,
``repro_torch.training``: AdamW, the train step, the data streams,
checkpoints, the trainer CLI) against the JAX package's on the CPU: the
same numpy inputs from a seed, the JAX side's init bridged with
``params_from_numpy``, float32 and ``use_pallas_kernels`` off.  The
per-family loss and gradients are in ``test_torch_training_grads.py``.

Tolerances: schedules rtol 1e-6 (float32 on both sides); cross-entropy
atol = rtol = 1e-6; flash grads atol 2e-4, rtol 1e-3 (the reference's own
custom-VJP test); AdamW on shared grads rtol 1e-5, atol 1e-7 for params
and float32 moments, and with bfloat16 moments rtol 8e-3 on them (one
bf16 ulp, where a last-bit difference before the cast rounds the other
way) and atol 1e-4 on the params of the step that reads them (lr 1e-2
times that ulp); 3-step losses atol = rtol = 1e-4.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro.models import build_model
from repro.models.flash import blocked_attention as j_blocked
from repro.models.model import cross_entropy as j_cross_entropy
from repro.training import checkpoint as j_checkpoint
from repro.training import optimizer as j_opt
from repro.training.data import GrammarLMDataset as JGrammarLM
from repro.training.data import TaskDataset as JTask
from repro.training.train_loop import make_train_step as j_make_step
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import MLAConfig as TMLAConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.core import grammars as t_grammars
from repro_torch.core.sampling import GrammarSampler as TSampler
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        state_from_numpy, state_to_numpy,
                                        tree_items)
from repro_torch.models.flash import blocked_attention, naive_attention
from repro_torch.models.model import cross_entropy
from repro_torch.tokenizer import train_bpe as t_train_bpe
from repro_torch.training import checkpoint, optimizer as opt
from repro_torch.training.data import GrammarLMDataset, TaskDataset
from repro_torch.training.train_loop import make_train_step, to_device

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=300, dtype="float32", max_seq_len=64)
MLA = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16)
MOE = dict(n_experts=4, top_k=2, d_ff_expert=64, n_shared_experts=1,
           dense_residual_d_ff=32, capacity_factor=2.0)
# family -> (the JAX config, the port's): the SMOKE configs of the four
# served architectures, plus dense MLA and a GQA MoE with a dense residual
FAMILIES = {
    "dense": ("stablelm-1.6b", None),
    "mamba1": ("falcon-mamba-7b", None),
    "mamba2+shared_attn": ("zamba2-1.2b", None),
    "mla+moe": ("deepseek-v3-671b", None),
    "mla": (None, dict(family="dense", group=("mla",))),
    "moe": (None, dict(family="moe", group=("moe",))),
}


def configs(family):
    arch, extra = FAMILIES[family]
    if arch is not None:
        return get_config(arch, smoke=True), t_get_config(arch, smoke=True)
    cfg = ModelConfig(arch_id=f"t-{family}", **SMALL, **extra,
                      mla=MLAConfig(**MLA) if "mla" in extra["group"]
                      else None,
                      moe=MoEConfig(**MOE) if "moe" in extra["group"]
                      else None)
    tcfg = TModelConfig(arch_id=f"t-{family}", **SMALL, **extra,
                        mla=TMLAConfig(**MLA) if "mla" in extra["group"]
                        else None,
                        moe=TMoEConfig(**MOE) if "moe" in extra["group"]
                        else None)
    return cfg, tcfg


def pair(family):
    cfg, tcfg = configs(family)
    m, tm = build_model(cfg), t_build_model(tcfg)
    params = m.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return m, params, tm, tparams


def tokens(vocab, b=2, s=17, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def assert_trees_close(want, got, **tol):
    flat = dict(tree_items(got))
    paths = [p for p, _ in tree_items(want)]
    assert sorted(map(str, paths)) == sorted(map(str, flat))
    for path, w in tree_items(want):
        np.testing.assert_allclose(np.asarray(w, np.float32),
                                   np.asarray(flat[path], np.float32),
                                   err_msg=str(path), **tol)


# -- schedules, cross-entropy ------------------------------------------------


@pytest.mark.parametrize("sched", ["constant", "cosine", "wsd"])
def test_schedules_match(sched):
    kw = dict(lr=3e-3, schedule=sched, warmup_steps=7, total_steps=40,
              lr_min_frac=0.1)
    f, tf = j_opt.schedule_fn(j_opt.AdamWConfig(**kw)), \
        opt.schedule_fn(opt.AdamWConfig(**kw))
    want = [float(f(jnp.asarray(s, jnp.int32))) for s in range(45)]
    got = [float(tf(torch.tensor(s, dtype=torch.int32))) for s in range(45)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cross_entropy_matches_with_masked_labels():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 11, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 11)).astype(np.int32)
    labels[0, :4] = -1
    labels[2] = -1
    want = float(j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    all_masked = cross_entropy(torch.from_numpy(logits),
                               torch.full((3, 11), -1, dtype=torch.int32))
    assert float(all_masked) == 0.0


# -- the flash backward -------------------------------------------------------


@pytest.mark.parametrize("window", [None, 16])
def test_blocked_attention_grads_match_custom_vjp(window):
    rng = np.random.default_rng(3)
    b, s, g, qh, d = 2, 64, 2, 2, 16
    q = rng.normal(size=(b, s, g, qh, d)).astype(np.float32)
    k = rng.normal(size=(b, s, g, d)).astype(np.float32)
    v = rng.normal(size=(b, s, g, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jpos = jnp.asarray(pos)
    f = lambda q, k, v: (j_blocked(q, k, v, jpos, jpos, window, None, 16,
                                   32) ** 2).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tpos = torch.from_numpy(pos.copy())
    out = blocked_attention(tq, tk, tv, tpos, tpos, window, None, 16, 32)
    got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for w, gt in zip(want, got):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3)
    # and the port's own naive autograd, with a ragged validity mask
    valid = torch.from_numpy(rng.random((b, s)) > 0.2)
    valid[:, 0] = True
    got = torch.autograd.grad((blocked_attention(
        tq, tk, tv, tpos, tpos, window, valid, 16, 32) ** 2).sum(),
        (tq, tk, tv))
    ref = torch.autograd.grad((naive_attention(
        tq, tk, tv, tpos, tpos, window, valid) ** 2).sum(), (tq, tk, tv))
    for a, bb in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), bb.numpy(), atol=2e-4,
                                   rtol=1e-3)


# -- AdamW on shared grads ----------------------------------------------------


@pytest.mark.parametrize("clip", [1e-2, 1e6])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_on_shared_grads(clip, state_dtype):
    """zamba2's SMOKE params (group leaves stacked on the JAX side, so its
    norm scales are decayed there: the port must decay them too), two steps
    on the same numpy grads."""
    m, params, tm, tparams = pair("mamba2+shared_attn")
    kw = dict(lr=1e-2, schedule="wsd", warmup_steps=2, total_steps=10,
              grad_clip=clip, state_dtype=state_dtype)
    jcfg, tcfg = j_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    j_apply = jax.jit(j_opt.apply_updates, static_argnums=3)
    jstate = j_opt.init_state(params, jcfg)
    tstate = opt.init_state(tparams, tcfg)
    rng = np.random.default_rng(5)
    for _ in range(2):
        grads = jax.tree.map(
            lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.1,
            params)
        params, jstate, jm = j_apply(
            params, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        tparams, tstate, tmet = opt.apply_updates(
            tparams, params_from_numpy(grads, tm.cfg, device="cpu"), tstate,
            tcfg)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        ptol, mtol = (dict(rtol=1e-5, atol=1e-7), dict(rtol=1e-5, atol=1e-7))
        if state_dtype == "bfloat16":
            ptol, mtol = dict(rtol=1e-5, atol=1e-4), dict(rtol=8e-3, atol=1e-7)
        assert_trees_close(jax.tree.map(np.asarray, params),
                            params_to_numpy(tparams, tm.cfg), **ptol)
        for k in ("m", "v"):
            assert_trees_close(
                jax.tree.map(lambda a: np.asarray(a, np.float32), jstate[k]),
                params_to_numpy(tstate[k], tm.cfg), **mtol)
        assert int(tstate["step"]) == int(jstate["step"])
    assert tstate["m"]["embed"].dtype == opt.DTYPES[state_dtype]


# -- the train step -----------------------------------------------------------


@pytest.fixture(scope="module")
def toks():
    """The JAX package's tokenizer and the port's, trained on the same
    corpus (the copied modules give the same vocabulary)."""
    from repro.core import grammars
    from repro.core.sampling import GrammarSampler
    from repro.tokenizer import train_bpe
    corpus = GrammarSampler(grammars.load("json"), seed=0).corpus(60)
    tcorpus = TSampler(t_grammars.load("json"), seed=0).corpus(60)
    assert corpus == tcorpus
    jt, tt = train_bpe(corpus, vocab_size=300), t_train_bpe(tcorpus, 300)
    assert list(jt.vocab) == list(tt.vocab)
    return jt, tt


@pytest.mark.parametrize("branch", ["lm", "labels"])
def test_three_step_losses_match(toks, branch):
    """Losses only: at step 1 AdamW moves every element by about +-lr
    whatever its gradient's size, so a near-zero gradient whose sign
    differs between the frameworks moves it by 2 lr; params are compared
    through the shared-grads test above instead."""
    jt, tt = toks
    cfg, tcfg = configs("dense")
    cfg = dataclasses.replace(cfg, vocab_size=jt.vocab_size)
    tcfg = dataclasses.replace(tcfg, vocab_size=tt.vocab_size)
    m, tm = build_model(cfg), t_build_model(tcfg)
    params = m.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    if branch == "lm":
        jd = JGrammarLM(jt, "json", seq_len=32).batches(4)
        td = GrammarLMDataset(tt, "json", seq_len=32).batches(4)
    else:
        jd = JTask(jt, seq_len=48, few_shot=1, mask_prompt=True).batches(4)
        td = TaskDataset(tt, seq_len=48, few_shot=1,
                         mask_prompt=True).batches(4)
    kw = dict(lr=3e-3, schedule="wsd", warmup_steps=1, total_steps=3)
    jstep = j_make_step(m, j_opt.AdamWConfig(**kw))
    tstep = make_train_step(tm, opt.AdamWConfig(**kw))
    jstate, tstate = j_opt.init_state(params), opt.init_state(tparams)
    want, got = [], []
    for _ in range(3):
        jb, tb = next(jd), next(td)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        params, jstate, jm = jstep(params, jstate,
                                   {k: jnp.asarray(v) for k, v in jb.items()})
        tparams, tstate, tmet = tstep(tparams, tstate, to_device(tb, "cpu"))
        want.append(float(jm["loss"]))
        got.append(float(tmet["loss"]))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert all(p.requires_grad for _, p in tree_items(tparams))


# -- checkpoints across the packages -----------------------------------------


def _assert_bitwise(want, got):
    flat = dict(tree_items(got))
    assert len(flat) == len(list(tree_items(want)))
    for path, a in tree_items(want):
        b = flat[path]
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_params_round_trip_bitwise():
    for family in ("mamba2+shared_attn", "mla+moe"):
        _, _, tm, tparams = pair(family)
        _assert_bitwise(tparams, params_from_numpy(
            params_to_numpy(tparams, tm.cfg), tm.cfg, device="cpu"))
    tcfg = dataclasses.replace(t_get_config("zamba2-1.2b", smoke=True),
                               dtype="bfloat16")
    tm = t_build_model(tcfg)
    tparams = tm.init(device="cpu")
    _assert_bitwise(tparams, params_from_numpy(
        params_to_numpy(tparams, tcfg), tcfg, device="cpu"))
    state = opt.init_state(tparams, opt.AdamWConfig(state_dtype="bfloat16"))
    state["step"] += 3
    sback = state_from_numpy(state_to_numpy(state, tcfg), tcfg, "cpu",
                             "bfloat16")
    assert int(sback["step"]) == 3
    assert sback["m"]["stack"]["group"]["b0"][0]["mamba"]["D"].dtype \
        == torch.bfloat16


def test_checkpoint_reference_to_port(tmp_path):
    m, params, tm, _ = pair("mamba2+shared_attn")
    state = j_opt.init_state(params)
    state = dict(state, step=jnp.asarray(4, jnp.int32),
                 m=jax.tree.map(lambda p: p * 0.5, params))
    j_checkpoint.save(tmp_path, params, state, meta={"arch": "x"})
    got, gstate, meta = checkpoint.load(tmp_path, tm, "cpu", with_opt=True)
    assert meta == {"arch": "x"}
    assert_trees_close(jax.tree.map(np.asarray, params),
                        params_to_numpy(got, tm.cfg), rtol=0, atol=0)
    assert_trees_close(jax.tree.map(np.asarray, state["m"]),
                        params_to_numpy(gstate["m"], tm.cfg), rtol=0, atol=0)
    assert int(gstate["step"]) == 4


def test_checkpoint_port_to_reference(tmp_path):
    m, _, tm, tparams = pair("mla+moe")
    tstate = opt.init_state(tparams)
    tstate["v"] = {k: v for k, v in tstate["v"].items()}
    tstate["step"] += 2
    checkpoint.save(tmp_path, tparams, tstate, meta={"arch": "y"})
    tmpl = m.init(jax.random.PRNGKey(1))
    got, gstate, meta = j_checkpoint.load(tmp_path, tmpl,
                                          j_opt.init_state(tmpl))
    assert meta == {"arch": "y"}
    assert_trees_close(got, params_to_numpy(tparams, tm.cfg), rtol=0,
                        atol=0)
    assert int(gstate["step"]) == 2
    assert json.loads((tmp_path / "meta.json").read_text())["arch"] == "y"


def test_checkpoint_vocab_padding_load(tmp_path):
    """A checkpoint of a 200-token vocab (padded to 256) loads into a
    300-token model (padded to 512) zero-padded, in both packages."""
    base = dict(SMALL, n_layers=1)
    small = TModelConfig(arch_id="v", family="dense", **dict(base,
                                                             vocab_size=200))
    big = dataclasses.replace(small, vocab_size=300)
    tparams = t_build_model(small).init(device="cpu")
    checkpoint.save(tmp_path, tparams)
    got, _, _ = checkpoint.load(tmp_path, t_build_model(big), "cpu")
    assert got["embed"].shape == (512, 64) and got["lm_head"].shape == (64,
                                                                         512)
    assert torch.equal(got["embed"][:256], tparams["embed"])
    assert torch.all(got["embed"][256:] == 0)
    assert torch.all(got["lm_head"][:, 256:] == 0)
    jbig = build_model(ModelConfig(arch_id="v", family="dense",
                                   **dict(base, vocab_size=300)))
    jgot, _, _ = j_checkpoint.load(tmp_path, jbig.init(jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(np.asarray(jgot["embed"]),
                                  got["embed"].numpy())


# -- the trainer CLI ----------------------------------------------------------


def test_launch_train_runs_three_steps_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--smoke", "--steps", "3",
                      "--batch", "2", "--seq", "32", "--save",
                      str(tmp_path)])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert not any(p.requires_grad for _, p in tree_items(out["params"]))
    printed = capsys.readouterr().out
    assert "step    0 loss=" in printed and "step    2 loss=" in printed
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["arch"] == "stablelm-1.6b-smoke"
    assert (tmp_path / "tokenizer.json").exists()
    assert train.parse_args(["--mesh", "2x4"]).mesh == "2x4"
    with pytest.raises(SystemExit):
        train.parse_args(["--mesh", "2by4"])
