"""The constraint modes besides DOMINO, and token healing, through the port's
``generate`` and ``generate_batch`` against ``repro``'s on the same weights,
tokenizer, grammar and prompts: the ``naive`` and ``online`` checkers,
opportunistic DOMINO, healed prompts (paper section 3.5) alone and with
speculation, and a batch mixing them.  Token ids, statuses, forwards and
interventions must be equal.  2 layers, d_model 64, float32 on the CPU."""
import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig
from repro.core import grammars
from repro.core.domino import DominoDecoder
from repro.models import build_model
from repro.serving import (ConstraintSpec, DecodeParams, EngineConfig,
                           Request, ServingEngine)
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ConstraintSpec as TConstraintSpec
from repro_torch.serving import DecodeParams as TDecodeParams
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TServingEngine

BASE = dict(arch_id="tm-attn", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, dtype="float32",
            max_seq_len=512)
PROMPTS = ['data: {"', "a: ", "Results: ["]
MODES = {
    "naive": dict(mode="naive"),
    "online": dict(mode="online"),
    "opportunistic": dict(mode="domino", opportunistic=True),
    "heal": dict(mode="domino", heal=2),
    "heal-speculative": dict(mode="domino", heal=1, speculative=True,
                             spec_s=4, spec_threshold=0.4),
}


@pytest.fixture(scope="module")
def pair(small_tokenizer, json_grammar):
    """``pair(grammar, **engine_config)`` -> fresh (JAX, port) engines on
    one set of weights."""
    tok = small_tokenizer
    m = build_model(ModelConfig(vocab_size=tok.vocab_size, **BASE))
    params = m.init(jax.random.PRNGKey(0))
    tcfg = TModelConfig(vocab_size=tok.vocab_size, **BASE)
    tm = t_build_model(tcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    steps = {}

    def make(grammar=json_grammar, **ec):
        ec = dict(dict(max_tokens=12), **ec)
        eng = ServingEngine(m, params, tok, grammar, EngineConfig(**ec),
                            max_len=256)
        eng._prefill, eng._decode = steps.setdefault(
            0, (eng._prefill, eng._decode))
        teng = TServingEngine(tm, tparams, tok, grammar, TEngineConfig(**ec),
                              max_len=256, device="cpu")
        return eng, teng
    return make


def _same(ref, got):
    assert [(g.status, g.token_ids, g.n_forward_passes, g.n_interventions,
             g.n_spec_proposed, g.n_spec_accepted, g.text) for g in got] == \
        [(r.status, r.token_ids, r.n_forward_passes, r.n_interventions,
          r.n_spec_proposed, r.n_spec_accepted, r.text) for r in ref]


@pytest.mark.parametrize("name", sorted(MODES))
def test_generate_and_batch_match(pair, name, small_tokenizer):
    ec = MODES[name]
    g = grammars.load("json_gsm8k") if ec.get("speculative") else None
    eng, teng = pair(**({"grammar": g} if g else {}), **ec)
    if ec.get("speculative"):         # warm both count models alike
        eng.generate(PROMPTS[1])
        teng.generate(PROMPTS[1])
    _same([eng.generate(p) for p in PROMPTS],
          [teng.generate(p) for p in PROMPTS])
    _same(eng.generate_batch(PROMPTS, max_batch=2),
          teng.generate_batch(PROMPTS, max_batch=2))
    if ec.get("heal") and not g:
        out = teng.generate(PROMPTS[0])
        d = DominoDecoder(eng.grammar, list(small_tokenizer.vocab),
                          small_tokenizer.eos_id)
        assert out.text.lstrip().startswith("{")
        assert all(d.advance(t) for t in out.token_ids)


def test_mixed_modes_in_one_batch(pair):
    """One batch whose rows take naive, online, healed and DOMINO
    constraints and an unconstrained row, each under its own spec."""
    eng, teng = pair()
    rows = [(PROMPTS[0], dict(mode="domino", heal=2)),
            (PROMPTS[1], dict(mode="naive")),
            (PROMPTS[2], dict(mode="online")),
            ("x", dict(mode="domino", opportunistic=True)),
            ("free: ", None)]
    out = []
    for req, spec, dec, e in ((Request, ConstraintSpec, DecodeParams, eng),
                              (TRequest, TConstraintSpec, TDecodeParams,
                               teng)):
        reqs = [req(p, spec() if kw is None
                    else spec(grammar="default", **kw), dec(max_tokens=10))
                for p, kw in rows]
        out.append(e.generate_batch(reqs, max_batch=3))
    _same(*out)
