"""The port's twin of ``tests/test_system.py``: the same ~1M-parameter
config trained by the port for 60 steps on the CPU on the arithmetic-JSON
task, then served constrained through the port's engine, with the same
three bars: (a) the loss falls below 0.7 of its first value, (b) the
DOMINO output stays valid under ``json_gsm8k``, (c) speculative decoding
gives the same ids with no more forwards.  Imports no JAX."""
import pytest

from repro_torch.configs.base import ModelConfig
from repro_torch.core import grammars
from repro_torch.core.domino import DominoDecoder
from repro_torch.core.sampling import GrammarSampler
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.tokenizer import train_bpe
from repro_torch.training import optimizer as opt
from repro_torch.training.data import TaskDataset
from repro_torch.training.train_loop import train


@pytest.fixture(scope="module")
def trained():
    # the tokenizer of tests/conftest.py's ``small_tokenizer``
    corpus = GrammarSampler(grammars.load("json"), seed=7).corpus(150)
    corpus += GrammarSampler(grammars.load("c"), seed=3).corpus(60)
    tok = train_bpe(corpus, vocab_size=420)
    cfg = ModelConfig(arch_id="sys", family="dense", n_layers=2, d_model=96,
                      n_heads=4, n_kv_heads=4, d_ff=192,
                      vocab_size=tok.vocab_size, dtype="float32",
                      max_seq_len=512)
    m = build_model(cfg)
    params = m.init(device="cpu")
    data = TaskDataset(tok, seq_len=160, few_shot=1).batches(8)
    params, _, history = train(
        m, params, data, 60,
        opt.AdamWConfig(lr=3e-3, schedule="wsd", warmup_steps=5,
                        total_steps=60),
        log_every=1, log_fn=lambda _: None)
    return m, params, tok, [h["loss"] for h in history]


def test_training_reduces_loss(trained):
    _, _, _, losses = trained
    assert len(losses) == 60
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_constrained_output_valid(trained):
    m, params, tok, _ = trained
    g = grammars.load("json_gsm8k")
    eng = ServingEngine(m, params, tok, g,
                        EngineConfig(mode="domino", max_tokens=48),
                        max_len=512, device="cpu")
    r = eng.generate('Q: compute 3 + 4\nA: ')
    d = DominoDecoder(g, list(tok.vocab), tok.eos_id)
    for t in r.token_ids:
        assert d.advance(t)
    if r.finished:
        assert d.eos_legal()


def test_speculation_output_identical_fewer_forwards(trained):
    m, params, tok, _ = trained
    g = grammars.load("json_gsm8k")
    plain = ServingEngine(m, params, tok, g,
                          EngineConfig(mode="domino", max_tokens=40),
                          max_len=512, device="cpu")
    r0 = plain.generate('Q: compute 5 + 2\nA: ')
    spec = ServingEngine(m, params, tok, g,
                         EngineConfig(mode="domino", speculative=True,
                                      spec_s=8, spec_threshold=0.4,
                                      max_tokens=40), max_len=512,
                         device="cpu")
    spec.generate('Q: compute 5 + 2\nA: ')     # prior formation
    r1 = spec.generate('Q: compute 5 + 2\nA: ')
    assert r1.token_ids == r0.token_ids
    assert r1.n_forward_passes <= r0.n_forward_passes


def test_engine_refuses_params_that_require_grad(trained):
    m, params, tok, _ = trained
    from repro_torch.training.train_loop import requiring_grad
    with pytest.raises(ValueError, match="detach"):
        ServingEngine(m, requiring_grad(params), tok, device="cpu")
