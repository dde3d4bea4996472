"""The port's sliding-window, encoder-decoder, VLM-prefix and int8-KV paths
(``repro_torch.models``) against ``repro``'s on the same weights (``repro``'s
init bridged with ``params_from_numpy``) and the same numpy-seeded inputs.

Models: the SMOKE configs of gemma3-27b (``swa`` + ``attn`` groups),
llava-next-mistral-7b (``swa`` with a patch prefix) and whisper-tiny
(``xattn`` over encoder frames), and the ``whisper`` and ``vlm`` cases of
``tests/test_models.py``.  Each runs ``train_logits``, a prefill and three
decode steps, an S = 3 verify window, a rollback, ragged (B,) lengths and
decode steps until the ring has wrapped, with ``use_pallas_kernels`` off
and on in both packages (the JAX kernel in interpret mode, the port's
plain version on the CPU); every cache leaf (rings, ``pos`` maps, encoder
K/V) is compared at the end.  The int8 KV cache's values and bfloat16
scales must equal the reference's bit for bit on dense, ring and paged
layouts.  And whisper's ``loss`` and every gradient, the encoder's
included, against ``jax.grad``.

Tolerances: logits and float cache leaves atol = rtol = 1e-4 (those of
``tests/test_torch_model.py``); gradients atol 1e-5, rtol 1e-3 (those of
``tests/test_torch_training_grads.py``); int8 leaves, scales and ``pos``
maps exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ModelConfig
from repro.models import build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from test_torch_training import assert_trees_close
from test_torch_training_grads import _port_grads

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", max_seq_len=64)
# tests/test_models.py's whisper and vlm cases
MODELS_CASES = {
    "whisper": dict(arch_id="t-wh", family="audio", group=("xattn",),
                    is_encoder_decoder=True, n_encoder_layers=2,
                    encoder_seq_len=12, **BASE),
    "vlm": dict(arch_id="t-vlm", family="vlm", group=("swa",),
                sliding_window=8, n_prefix_tokens=4, **BASE),
}
CASES = ("gemma3-27b", "llava-next-mistral-7b", "whisper-tiny", "whisper",
         "vlm")


def _configs(case, kernels=False):
    if case in MODELS_CASES:
        cfg = ModelConfig(**MODELS_CASES[case])
        tcfg = TModelConfig(**MODELS_CASES[case])
    else:
        cfg, tcfg = get_config(case, smoke=True), t_get_config(case,
                                                               smoke=True)
    return (dataclasses.replace(cfg, use_pallas_kernels=kernels),
            dataclasses.replace(tcfg, use_pallas_kernels=kernels))


def _pair(cfg, tcfg, seed=0):
    m, tm = build_model(cfg), t_build_model(tcfg)
    params = m.init(jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return m, params, tm, tparams


def _inputs(cfg, b, s, seed=1):
    """numpy tokens (B, S) and the config's extra inputs, a VLM's
    ``prefix`` (B, P, D) or an encoder-decoder's ``frames``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["prefix"] = rng.normal(
            size=(b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.normal(
            size=(b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def _j(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _t(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                               **(tol or TOL))


def _leaf(x):
    """A cache leaf as numpy, bfloat16 widened to float32 (exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _same_caches(c1, c2, exact_float=False):
    """Every block leaf of the reference cache ``c1`` against the port's:
    integer leaves (int8 values, ``pos`` maps) and bfloat16 scales
    exactly, other floats at the logits' tolerance (or exactly)."""
    pairs = (list(zip(c1["head"], c2["head"]))
             + list(zip(c1["tail"], c2["tail"]))
             + [(c1["group"][k], c2["group"][k]) for k in c1["group"]])
    assert pairs
    for b1, b2 in pairs:
        assert sorted(b1) == sorted(b2)
        for name in b1:
            a, b = _leaf(b1[name]), _leaf(b2[name])
            assert a.shape == b.shape, name
            exact = (exact_float or not np.issubdtype(a.dtype, np.floating)
                     or b1[name].dtype == jnp.bfloat16)
            if exact:
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    np.testing.assert_array_equal(np.asarray(c1["len"]), c2["len"].numpy())


def _decode(m, params, tm, tparams, c1, c2, toks):
    d1, c1 = m.decode_step(params, c1, jnp.asarray(toks))
    d2, c2 = tm.decode_step(tparams, c2, torch.from_numpy(toks))
    _close(d1, d2)
    return c1, c2


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_prefill_decode_verify_rollback_ragged_and_wrap_match(case,
                                                              kernels):
    cfg, tcfg = _configs(case, kernels)
    m, params, tm, tparams = _pair(cfg, tcfg)
    b, s, n_pre = 2, 40, 8
    inp = _inputs(cfg, b, s)
    with torch.no_grad():
        l1, _ = m.train_logits(params, _j(inp))
        l2, _ = tm.train_logits(tparams, _t(inp))
        _close(l1, l2)
        max_len = 56 + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
        c1, c2 = m.init_cache(b, max_len), tm.init_cache(b, max_len,
                                                          device="cpu")
        pre = dict(inp, tokens=inp["tokens"][:, :n_pre])
        p1, c1 = m.prefill(params, _j(pre), c1)
        p2, c2 = tm.prefill(tparams, _t(pre), c2)
        _close(p1, p2)
        toks = inp["tokens"]
        i = n_pre
        for _ in range(3):                       # three decode steps
            c1, c2 = _decode(m, params, tm, tparams, c1, c2,
                             toks[:, i:i + 1])
            i += 1
        # an S = 3 verify window, then a rollback of two of its tokens
        c1, c2 = _decode(m, params, tm, tparams, c1, c2, toks[:, i:i + 3])
        c1, c2 = m.rollback(c1, 2), tm.rollback(c2, 2)
        i += 1
        # ragged rows, as the batching scheduler produces: row 1 two
        # positions behind row 0
        ln = np.asarray(c1["len"])
        c1["len"] = jnp.asarray([ln, ln - 2], jnp.int32)
        c2["len"] = torch.tensor([int(ln), int(ln) - 2], dtype=torch.int32)
        for width in (1, 3, 1, 1):
            c1, c2 = _decode(m, params, tm, tparams, c1, c2,
                             toks[:, i:i + width])
            i += width
        # on until every row's positions outgrow the window: the ring wraps
        w = cfg.sliding_window
        while w is not None and int(np.asarray(c1["len"]).min()) <= w + 4:
            c1, c2 = _decode(m, params, tm, tparams, c1, c2,
                             toks[:, i:i + 1])
            i += 1
        assert i <= s
        _same_caches(c1, c2)
        if w is not None:
            # every slot of the ring holds a live position
            blk = next(b for b in c2["head"] + c2["tail"]
                       + list(c2["group"].values()) if "pos" in b)
            assert int(blk["pos"].min()) >= 0


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("layout", ["dense", "ring", "paged"])
def test_int8_cache_matches_bitwise(layout, kernels):
    """``tests/test_quantized_cache.py``'s int8 cases: a prefill (a
    multi-token decode into a shuffled block table when paged) and single
    decodes; int8 values and bfloat16 scales equal the reference's
    exactly, logits at the usual tolerance, and the cache holds int8
    leaves with (reps, B, T, n_kv) scales."""
    group, window = (("swa",), 8) if layout == "ring" else (("attn",), None)
    kw = dict(BASE, n_layers=2, arch_id="q", family="dense", group=group,
              sliding_window=window, kv_cache_dtype="int8",
              use_pallas_kernels=kernels)
    m, params, tm, tparams = _pair(ModelConfig(**kw), TModelConfig(**kw))
    toks = np.random.default_rng(1).integers(0, 128, (2, 16)).astype(
        np.int32)
    with torch.no_grad():
        if layout == "paged":
            tbl = np.array([[3, 1, 5, -1], [2, 8, 4, 0]], np.int32)
            c1 = m.init_cache(2, 32, page_size=8, n_pages=9)
            c2 = tm.init_cache(2, 32, page_size=8, n_pages=9, device="cpu")
            c1["pages"], c2["pages"] = jnp.asarray(tbl), torch.from_numpy(tbl)
            c1["len"] = jnp.asarray([0, 0], jnp.int32)
            c2["len"] = torch.tensor([0, 0], dtype=torch.int32)
            c1, c2 = _decode(m, params, tm, tparams, c1, c2, toks[:, :8])
        else:
            c1, c2 = m.init_cache(2, 20), tm.init_cache(2, 20, device="cpu")
            p1, c1 = m.prefill(params, {"tokens": jnp.asarray(toks[:, :8])},
                               c1)
            p2, c2 = tm.prefill(tparams,
                                {"tokens": torch.from_numpy(toks[:, :8])},
                                c2)
            _close(p1, p2)
        for i in range(8, 14):
            c1, c2 = _decode(m, params, tm, tparams, c1, c2,
                             toks[:, i:i + 1])
        blk = c2["group"]["b0"]
        assert blk["k"].dtype == blk["v"].dtype == torch.int8
        assert blk["k_scale"].dtype == torch.bfloat16
        lead = (2, 2) if layout != "paged" else (2, 9)
        assert tuple(blk["k_scale"].shape[:2]) == lead
        assert blk["k_scale"].shape[-1] == 2
        _same_caches(c1, c2, exact_float=True)


def test_whisper_loss_and_every_grad_match():
    """whisper-tiny's SMOKE ``loss`` and the gradient of every parameter,
    the encoder's stacked blocks and norm included, against
    ``jax.grad``."""
    cfg, tcfg = _configs("whisper-tiny")
    m, params, tm, tparams = _pair(cfg, tcfg)
    batch = _inputs(cfg, 2, 17, seed=3)
    (jloss, jmet), jgrads = jax.value_and_grad(m.loss, has_aux=True)(
        params, _j(batch))
    loss, met, grads = _port_grads(tm, tparams, _t(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["nll"].detach()), float(jmet["nll"]),
                               atol=1e-5, rtol=1e-5)
    enc = grads["encoder"]
    assert len(enc["blocks"]) == cfg.n_encoder_layers
    assert float(enc["blocks"][0]["attn"]["wq"].abs().sum()) > 0
    assert_trees_close(jax.tree.map(np.asarray, jgrads),
                       params_to_numpy(grads, tcfg), atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("case", ["gemma3-27b", "whisper-tiny"])
def test_params_round_trip_bitwise(case):
    """``params_to_numpy(params_from_numpy(x))`` gives ``x`` back: the
    group's layers and whisper's encoder blocks restacked."""
    cfg, tcfg = _configs(case)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    want = jax.tree.map(np.asarray, params)
    back = params_to_numpy(params_from_numpy(want, tcfg, device="cpu"), tcfg)
    assert_trees_close(want, back, atol=0, rtol=0)


def test_example_batch_has_the_reference_shapes():
    for case in CASES:
        cfg, tcfg = _configs(case)
        want = build_model(cfg).example_batch(2, 16)
        got = t_build_model(tcfg).example_batch(2, 16, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (case, k)
