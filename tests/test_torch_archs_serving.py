"""The port's serving stack on the three architectures of the sliding-window,
encoder-decoder and VLM-prefix paths -- the SMOKE configs of gemma3-27b
(groups of ``swa`` + ``attn``), llava-next-mistral-7b (all ``swa``, a patch
prefix) and whisper-tiny (``xattn`` over encoder frames) -- against
``repro``'s on the same weights, tokenizer, DOMINO JSON grammar, prompts
and per-request ``extra_inputs`` (a seeded ``prefix`` or ``frames``).

Ids, statuses, interventions, forward counts and the scheduler's counters
must be equal on the single-request path, through the continuous-batching
scheduler (rows reusing slots, each row's extra inputs scattered with it),
under speculative decoding (gemma3 and llava refeed their rings from the
pre-verify snapshot, whisper rolls back), on whisper's device loop (the
same path choice and host syncs as the reference) and through a journal
restore in which the ``extra_inputs`` row is reported non-recoverable.
float32 on the CPU; the port's kernel wrappers take their plain versions
here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_config
from repro.core import grammars
from repro.core.sampling import GrammarSampler
from repro.models import build_model
from repro.tokenizer import train_bpe
from repro_torch import serving as tserving
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_from_numpy

ARCHS = ("gemma3-27b", "llava-next-mistral-7b", "whisper-tiny")
PROMPTS = ["a: ", "some much longer json prompt here: ", "x", "record -> "]
SPEC = dict(speculative=True, spec_s=4, spec_threshold=0.4)
STATS = ("n_fwd", "n_host_syncs", "premask_hits",
         "mask_cache_hits", "n_preempt", "n_replayed_tokens",
         "n_device_tokens")


def _extra(cfg, seed):
    """One request's extra inputs as numpy: a VLM's patch prefix or an
    encoder-decoder's frames, (1, n, d_model) float32 from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        n = cfg.n_prefix_tokens
    elif cfg.is_encoder_decoder:
        n = cfg.encoder_seq_len
    else:
        return None
    x = rng.normal(size=(1, n, cfg.d_model)).astype(np.float32)
    return {"prefix" if cfg.family == "vlm" else "frames": x}


class _Pair:
    """Lazily built (JAX, port) models and weights of one SMOKE config,
    and engines on them."""

    def __init__(self, arch, tok, grammar):
        self.cfg = get_config(arch, smoke=True)
        self.tcfg = t_get_config(arch, smoke=True)
        self.tok, self.grammar = tok, grammar
        self.m = build_model(self.cfg)
        self.params = self.m.init(jax.random.PRNGKey(0))
        self.tparams = params_from_numpy(
            jax.tree.map(np.asarray, self.params), self.tcfg, device="cpu")
        self.tm = t_build_model(self.tcfg)
        self.steps = None

    def engines(self, grammar=None, **ec):
        ec = dict(dict(mode="domino", max_tokens=12), **ec)
        g = self.grammar if grammar is None else grammar
        eng = jserving.ServingEngine(self.m, self.params, self.tok, g,
                                     jserving.EngineConfig(**ec),
                                     max_len=256)
        # one model's jitted steps serve all its engines: compiled once
        if self.steps is None:
            self.steps = (eng._prefill, eng._decode)
        eng._prefill, eng._decode = self.steps
        teng = tserving.ServingEngine(self.tm, self.tparams, self.tok, g,
                                      tserving.EngineConfig(**ec),
                                      max_len=256, device="cpu")
        return eng, teng

    def requests(self, prompts, seed=0, **dp):
        """(JAX requests, port requests) with per-request extra inputs."""
        out = ([], [])
        for i, p in enumerate(prompts):
            ex = _extra(self.cfg, seed + i)
            for fw, conv, reqs in (
                    (jserving, jnp.asarray, out[0]),
                    (tserving, torch.from_numpy, out[1])):
                reqs.append(fw.Request(
                    p, fw.ConstraintSpec(grammar="default", mode="domino"),
                    fw.DecodeParams(**dict(dict(max_tokens=12), **dp)),
                    extra_inputs=(None if ex is None else
                                  {k: conv(v) for k, v in ex.items()})))
        return out


@pytest.fixture(scope="module")
def pairs(small_tokenizer, json_grammar):
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _Pair(arch, small_tokenizer, json_grammar)
        return cache[arch]
    return get


def _same(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert (g.token_ids, g.status, g.error) == \
            (r.token_ids, r.status, r.error)
        assert g.n_interventions == r.n_interventions
        assert g.n_forward_passes == r.n_forward_passes
        assert g.n_spec_proposed == r.n_spec_proposed
        assert g.n_spec_accepted == r.n_spec_accepted
        assert g.n_preemptions == r.n_preemptions
        assert g.text == r.text


def _batch(eng, reqs, capacity=2, **kw):
    fw = tserving if isinstance(eng, tserving.ServingEngine) else jserving
    s = fw.ContinuousBatchingScheduler(eng, capacity=capacity, **kw)
    sessions = [s.submit(r) for r in reqs]
    s.run()
    return ([x.result for x in sessions], {k: getattr(s, k) for k in STATS},
            s, sessions)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches(pairs, arch):
    """The single-request path, extra inputs in the prefill."""
    p = pairs(arch)
    eng, teng = p.engines()
    reqs, treqs = p.requests(PROMPTS[:2])
    _same([eng.generate(r) for r in reqs], [teng.generate(r) for r in treqs])


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_matches_with_per_request_extra_inputs(pairs, arch):
    """Four requests, each with its own prefix or frames, through two
    dense slots: ids, statuses and counters equal the reference's, and
    each row equals its own single-request run (its ring, ``pos`` map or
    encoder K/V scattered into the slot it took)."""
    p = pairs(arch)
    eng, teng = p.engines()
    reqs, treqs = p.requests(PROMPTS, seed=10)
    ref, st, *_ = _batch(eng, reqs)
    got, tst, sched, sessions = _batch(teng, treqs)
    assert not sched.paged
    _same(ref, got)
    assert tst == st
    assert [teng.generate(r).token_ids for r in treqs] == \
        [g.token_ids for g in got]
    if arch != "whisper-tiny":
        # a ring wrapped: a row's positions (prefix, prompt, output)
        # outgrew the window
        n_pos = max(len(x.prompt_ids) + len(x.out_ids) for x in sessions)
        n_pre = p.cfg.n_prefix_tokens if p.cfg.family == "vlm" else 0
        assert n_pre + n_pos > p.cfg.sliding_window


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_batch_matches(pairs, arch):
    """``json_gsm8k`` with ``spec_s`` 4, on the single-request path and
    through the scheduler: the window's rejections refeed a ring from the
    pre-verify snapshot (gemma3, llava) or roll back whisper's stripe;
    counts equal the reference's and the ids equal the non-speculative
    run's."""
    p = pairs(arch)
    gsm8k = grammars.load("json_gsm8k")
    eng, teng = p.engines(grammar=gsm8k, **SPEC)
    assert teng._needs_refeed == (arch != "whisper-tiny")
    reqs, treqs = p.requests(PROMPTS, seed=20, **SPEC)
    # the single-request path (a B=1 dense cache, snapshot and restore),
    # which also warms both count models alike
    _same([eng.generate(reqs[0])], [teng.generate(treqs[0])])
    ref, st, *_ = _batch(eng, reqs, capacity=3)
    got, tst, *_ = _batch(teng, treqs, capacity=3)
    _same(ref, got)
    assert tst == st
    prop = sum(g.n_spec_proposed for g in got)
    acc = sum(g.n_spec_accepted for g in got)
    assert 0 < acc < prop              # accepted, and rejected
    _, plain = p.engines(grammar=gsm8k)
    _, ptreqs = p.requests(PROMPTS, seed=20)
    assert [plain.generate(r).token_ids for r in ptreqs] == \
        [g.token_ids for g in got]


@pytest.fixture(scope="module")
def whisper_loop(json_grammar):
    """Whisper's SMOKE model on the 257-token byte-level BPE on which the
    JSON grammar certifies clean, engines with device tables built."""
    corpus = GrammarSampler(json_grammar, seed=7).corpus(80)
    tok = train_bpe(corpus, vocab_size=257)
    p = _Pair("whisper-tiny", tok, json_grammar)
    out = []
    for fw, kw in ((jserving, {}), (tserving, {"device": "cpu"})):
        m, params = (p.m, p.params) if fw is jserving else (p.tm, p.tparams)
        eng = fw.ServingEngine(m, params, tok, json_grammar,
                               fw.EngineConfig(mode="domino", max_tokens=16),
                               max_len=256, device_tables=True, **kw)
        eng.precompute()
        out.append(eng)
    return p, out


def test_whisper_device_loop_matches(whisper_loop):
    """Whisper is not a refeed architecture, so the device loop takes its
    certified rows exactly as the reference's ``_device_ready`` does:
    equal ids, device tokens and host syncs, at most 1/8 + 0.1 a token."""
    p, (eng, teng) = whisper_loop
    reqs, treqs = p.requests(PROMPTS, seed=30, max_tokens=16)
    ref, st, *_ = _batch(eng, reqs, device_loop=True, sync_n=8)
    got, tst, *_ = _batch(teng, treqs, device_loop=True, sync_n=8)
    _same(ref, got)
    assert tst == st
    assert tst["n_device_tokens"] > 0
    n_tok = sum(len(g.token_ids) for g in got)
    assert tst["n_host_syncs"] / n_tok <= 1 / 8 + 0.1
    host, *_ = _batch(teng, treqs)
    assert [h.token_ids for h in host] == [g.token_ids for g in got]


class Boom(Exception):
    """Raised by the journal's crash hook in place of a SIGKILL."""


def _boom():
    raise Boom()


def test_restore_reports_extra_inputs_row_non_recoverable(pairs, tmp_path):
    """A journaled run killed mid-flight: the row without a prefix
    restores to the uninterrupted run's ids, the row with one is reported
    ``internal_error`` as unrecoverable, in both packages alike."""
    p = pairs("llava-next-mistral-7b")
    out = []
    for i, (fw, eng) in enumerate(zip((jserving, tserving), p.engines())):
        reqs = p.requests(PROMPTS[:2], seed=40)[i]
        plain = dataclasses.replace(reqs[0], extra_inputs=None)
        baseline = eng.generate_batch([plain], max_batch=1)
        path = str(tmp_path / f"j{i}")
        j = fw.TokenJournal(path, crash_after_syncs=3, crash_hook=_boom)
        sched = fw.ContinuousBatchingScheduler(eng, capacity=2, journal=j)
        for r in (plain, reqs[1]):
            sched.submit(r)
        with pytest.raises(Boom):
            sched.run()
        j.dead = True
        entries = fw.replay_journal(path)
        assert entries[0].recoverable and not entries[1].recoverable
        res = eng.restore(path).run()
        assert res[0].token_ids == baseline[0].token_ids
        assert res[1].status == "internal_error"
        assert "extra_inputs" in res[1].error
        out.append([(r.status, r.token_ids, r.error) for r in res])
    assert out[1] == out[0]
