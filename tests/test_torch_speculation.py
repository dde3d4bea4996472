"""Speculative decoding (paper section 3.6) through the port's engine and
scheduler against ``repro``'s, on the same weights, tokenizer and
schema-heavy ``json_gsm8k`` grammar, each engine's count model warmed by
the same call.  Token ids, statuses, forward counts, proposals,
acceptances, interventions and preemptions must be equal, and so must the
scheduler's ``n_fwd``, ``n_host_syncs``, ``premask_hits``,
``mask_cache_hits`` and ``n_preempt``.  Cases: the single-request path on a
dense model (kernel route off, and on for both frameworks: the JAX kernel
interpreted, the port's plain version); the batch over a paged pool small
enough to preempt, whose rollbacks return pages mid-flight; the batch over
dense rows; a mixed batch in which only the speculative row proposes; the
recurrent families, refed from the pre-verify snapshot (each shows a
rejected proposal); and MLA + MoE over a paged latent pool.  Also the rest
of the engine API that needs no card (``generate_template``,
``analyze_grammar``, ``unregister_grammar``, the copied analysis report)
and the serve CLI's ``--speculative``.  float32 on the CPU."""
import re

import jax
import numpy as np
import pytest

from repro.analysis import bytes_vocab, run_batch
from repro.configs import base as jbase
from repro.core import grammars
from repro.core.baselines import Fixed, Gen
from repro.models import build_model
from repro.serving import (ConstraintSpec, DecodeParams, EngineConfig,
                           Request, ServingEngine)
from repro.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.analysis import bytes_vocab as t_bytes_vocab
from repro_torch.analysis import run_batch as t_run_batch
from repro_torch.configs import base as tbase
from repro_torch.core.baselines import Fixed as TFixed
from repro_torch.core.baselines import Gen as TGen
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ConstraintSpec as TConstraintSpec
from repro_torch.serving import DecodeParams as TDecodeParams
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TServingEngine
from repro_torch.serving import scheduler as tsched

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            dtype="float32", max_seq_len=512)
SPEC = dict(speculative=True, spec_s=4, spec_threshold=0.4)
PROMPTS = ["A: ", "Q: compute 1 + 2\nA: ", "Q: what is 3 * 4?\nA: ",
           "x: "]
MLA = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16)
# tests/test_torch_serving.py's dense, RECURRENT and LATENT["mla-moe"]
ARCHS = {
    "attn": dict(family="dense"),
    "mamba1": dict(family="ssm", group=("mamba1",),
                   ssm=dict(d_state=8, version=1)),
    "hybrid": dict(family="hybrid",
                   group=("mamba2", "mamba2", "shared_attn"),
                   ssm=dict(d_state=8, version=2, head_dim=16)),
    "mla-moe": dict(family="moe", group=("moe",), mla=MLA,
                    moe=dict(n_experts=4, top_k=2, d_ff_expert=64,
                             capacity_factor=2.0)),
}
STATS = ("n_fwd", "n_host_syncs", "premask_hits", "mask_cache_hits",
         "n_preempt")


def _cfg(mod, arch, tok, kernels):
    a = ARCHS[arch]
    sub = {}
    if "ssm" in a:
        sub["ssm"] = mod.SSMConfig(**a["ssm"])
    if "mla" in a:
        sub["mla"] = mod.MLAConfig(**a["mla"])
    if "moe" in a:
        sub["moe"] = mod.MoEConfig(**a["moe"])
    extra = {"group": a["group"]} if "group" in a else {}
    return mod.ModelConfig(arch_id=f"tsp-{arch}", family=a["family"],
                           vocab_size=tok.vocab_size,
                           use_pallas_kernels=kernels, **BASE, **extra,
                           **sub)


@pytest.fixture(scope="module")
def pair(small_tokenizer):
    """``pair(arch, kernels, jax_kernels, grammar, **engine_config)`` ->
    a fresh (JAX engine, port engine) on one set of weights an arch, so
    each test starts from empty count models."""
    tok = small_tokenizer
    gsm8k = grammars.load("json_gsm8k")
    params, models, steps = {}, {}, {}

    def make(arch, kernels=False, jax_kernels=False, grammar=gsm8k,
             **ec):
        if (arch, jax_kernels) not in models:
            models[arch, jax_kernels] = build_model(
                _cfg(jbase, arch, tok, jax_kernels))
        m = models[arch, jax_kernels]
        if arch not in params:
            params[arch] = m.init(jax.random.PRNGKey(3))
        tcfg = _cfg(tbase, arch, tok, kernels)
        tparams = params_from_numpy(jax.tree.map(np.asarray, params[arch]),
                                    tcfg, device="cpu")
        ec = dict(dict(mode="domino", max_tokens=16), **ec)
        eng = ServingEngine(m, params[arch], tok, grammar,
                            EngineConfig(**ec), max_len=256)
        # one model's jitted steps serve all its engines: compiled once
        eng._prefill, eng._decode = steps.setdefault(
            (arch, jax_kernels), (eng._prefill, eng._decode))
        teng = TServingEngine(t_build_model(tcfg), tparams, tok, grammar,
                              TEngineConfig(**ec), max_len=256,
                              device="cpu")
        return eng, teng
    return make


def _warm(*engines):
    for e in engines:
        e.generate(PROMPTS[0])


def _same(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.token_ids == r.token_ids
        assert g.status == r.status
        assert g.n_forward_passes == r.n_forward_passes
        assert g.n_spec_proposed == r.n_spec_proposed
        assert g.n_spec_accepted == r.n_spec_accepted
        assert g.n_interventions == r.n_interventions
        assert g.n_preemptions == r.n_preemptions
        assert g.text == r.text


def _jax_batch(eng, reqs, max_batch, **kw):
    sched = ContinuousBatchingScheduler(
        eng, capacity=min(len(reqs), max_batch), **kw)
    sessions = [sched.submit(r) for r in reqs]
    sched.run()
    return [s.result for s in sessions], {k: getattr(sched, k)
                                          for k in STATS}


def _same_batch(eng, teng, reqs, **kw):
    ref, st = _jax_batch(eng, reqs, **kw)
    got = teng.generate_batch(reqs, **kw)
    _same(ref, got)
    tst = teng.last_batch_stats
    assert {k: tst[k] for k in STATS} == st
    return got


@pytest.mark.parametrize("kernels", [False, True])
def test_generate_matches(pair, kernels):
    """The single-request path: rollback of a dense B=1 cache after each
    verify window; ids equal the plain engine's too."""
    eng, teng = pair("attn", kernels, jax_kernels=kernels, **SPEC)
    _warm(eng, teng)
    got = [teng.generate(p) for p in PROMPTS[:2]]
    _same([eng.generate(p) for p in PROMPTS[:2]], got)
    assert sum(g.n_spec_accepted for g in got) > 0
    _, plain = pair("attn", kernels)
    assert [plain.generate(p).token_ids for p in PROMPTS[:2]] == \
        [g.token_ids for g in got]
    # a second engine on the same count model starts from its counts
    again = [type(e)(e.model, e.params, e.tok, e.grammar, e.cfg,
                     count_model=e.count_model, max_len=256, **kw)
             for e, kw in ((eng, {}), (teng, {"device": "cpu"}))]
    assert again[1].count_model is teng.count_model
    _same([again[0].generate(PROMPTS[2])], [again[1].generate(PROMPTS[2])])


def test_generate_batch_paged_preempts_and_returns_pages(pair,
                                                         monkeypatch):
    """A 7-page pool of 8-token pages cannot hold two rows' verify
    windows: the scheduler recompute-preempts, and per-row rollback hands
    pages wholly beyond a rewound frontier back mid-flight."""
    freed = []
    orig = tsched.ContinuousBatchingScheduler._shrink_pages

    def spy(self):
        before = self._n_pages_row.copy()
        orig(self)
        live = [i for i, s in enumerate(self.slots) if s is not None]
        freed.append(int((before[live] - self._n_pages_row[live]).sum()))

    monkeypatch.setattr(tsched.ContinuousBatchingScheduler, "_shrink_pages",
                        spy)
    eng, teng = pair("attn", **SPEC)
    _warm(eng, teng)
    got = _same_batch(eng, teng, PROMPTS, max_batch=2, page_size=8,
                      n_pages=7)
    assert teng.last_batch_stats["paged"]
    assert teng.last_batch_stats["n_preempt"] > 0
    assert sum(freed) > 0
    assert sum(g.n_spec_accepted for g in got) > 0


def test_generate_batch_contiguous(pair):
    eng, teng = pair("attn", **SPEC)
    _warm(eng, teng)
    got = _same_batch(eng, teng, PROMPTS, max_batch=3, paged=False)
    assert not teng.last_batch_stats["paged"]
    assert [teng.generate(p).token_ids for p in PROMPTS] == \
        [g.token_ids for g in got]


def test_mixed_batch_only_the_speculative_row_proposes(pair):
    """A speculative row, a plain row, an unconstrained row and a sampled
    row (speculative asked, but sampled rows decode plain) in one batch."""
    eng, teng = pair("attn")
    out = []
    for cs, dp in ((ConstraintSpec, DecodeParams),
                   (TConstraintSpec, TDecodeParams)):
        gs = cs(grammar="default", mode="domino")
        out.append([
            (PROMPTS[0], gs, dp(max_tokens=12, **SPEC)),
            (PROMPTS[1], gs, dp(max_tokens=12)),
            ("free: ", cs(), dp(max_tokens=6)),
            (PROMPTS[2], gs, dp(max_tokens=8, temperature=0.8, seed=5,
                                **SPEC))])
    reqs = [Request(*r) for r in out[0]]
    treqs = [TRequest(*r) for r in out[1]]
    eng.generate(reqs[0])
    teng.generate(treqs[0])
    ref, st = _jax_batch(eng, reqs, max_batch=4)
    got = teng.generate_batch(treqs, max_batch=4)
    _same(ref, got)
    assert {k: teng.last_batch_stats[k] for k in STATS} == st
    assert got[0].n_spec_proposed > 0
    assert [g.n_spec_proposed for g in got[1:]] == [0, 0, 0]


@pytest.mark.parametrize("arch", ["mamba1", "hybrid"])
def test_recurrent_generate_refeeds_from_the_snapshot(pair, arch):
    eng, teng = pair(arch, kernels=True, **SPEC)
    assert teng._needs_refeed
    _warm(eng, teng)
    got = [teng.generate(p) for p in PROMPTS[:2]]
    _same([eng.generate(p) for p in PROMPTS[:2]], got)
    prop = sum(g.n_spec_proposed for g in got)
    acc = sum(g.n_spec_accepted for g in got)
    assert 0 < acc < prop            # accepted, and rejected: refed
    _, plain = pair(arch, kernels=True)
    assert [plain.generate(p).token_ids for p in PROMPTS[:2]] == \
        [g.token_ids for g in got]


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("arch", ["mamba1", "hybrid"])
def test_recurrent_generate_batch_refeeds_by_group(pair, arch, kernels):
    """Dense rows, each partially accepted row refed from the snapshot in
    one B=K forward a group of equal accepted length."""
    eng, teng = pair(arch, kernels, **SPEC)
    _warm(eng, teng)
    got = _same_batch(eng, teng, PROMPTS, max_batch=3)
    prop = sum(g.n_spec_proposed for g in got)
    acc = sum(g.n_spec_accepted for g in got)
    assert 0 < acc < prop
    assert [teng.generate(p).token_ids for p in PROMPTS] == \
        [g.token_ids for g in got]


def test_mla_moe_generate_batch_paged(pair):
    """Absorbed MLA + MoE over a paged latent pool of 16-token pages,
    through the split-score kernel route of the port."""
    eng, teng = pair("mla-moe", kernels=True, **SPEC)
    _warm(eng, teng)
    got = _same_batch(eng, teng, PROMPTS, max_batch=2, page_size=16)
    assert teng.last_batch_stats["paged"]
    assert sum(g.n_spec_accepted for g in got) > 0


def test_generate_template_matches(pair):
    """The template baseline forces each fixed part as one multi-token
    forward (decode attention at S > 1)."""
    eng, teng = pair("attn", grammar=None, mode="unconstrained",
                     max_tokens=40)
    out = []
    for e, fx, gn in ((eng, Fixed, Gen), (teng, TFixed, TGen)):
        parts = [fx('{"id": '), gn(r"[1-9][0-9]*", max_tokens=3),
                 fx(', "name": "'), gn(r"[a-z]+", max_tokens=4), fx('"}')]
        out.append(e.generate_template("obj: ", parts))
    ref, got = out
    assert got.text.startswith('{"id": ') and got.text.endswith('"}')
    assert got.n_interventions > 0
    assert got.token_ids == ref.token_ids
    assert got.n_forward_passes == ref.n_forward_passes
    assert got.n_interventions == ref.n_interventions


def test_analysis_reports_and_registry_match(pair):
    eng, teng = pair("attn")
    reports = []
    for e in (eng, teng):
        g = grammars.load("arith")
        e.register_grammar("arith", g)
        assert e.register_grammar("arith", g) is e.registry["arith"][1]
        reports.append(e.analyze_grammar("arith").to_dict())
        assert e.unregister_grammar("arith") is False
        assert e.unregister_grammar("arith") is True
        assert "arith" not in e.registry and "arith" not in \
            e.analysis_reports
        with pytest.raises(KeyError):
            e.unregister_grammar("arith")
    for r in reports:
        r.pop("analysis_time_s")
    assert reports[0] == reports[1]
    ref = run_batch(["arith"], *bytes_vocab(), clamp=8, max_states=2048)
    got = t_run_batch(["arith"], *t_bytes_vocab(), clamp=8, max_states=2048)
    assert got["arith"].ok() == ref["arith"].ok()
    d_ref, d_got = ref["arith"].to_dict(), got["arith"].to_dict()
    for d in (d_ref, d_got):
        d.pop("analysis_time_s")
    assert d_got == d_ref


def test_serve_cli_speculative_on_a_recurrent_arch(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "zamba2-1.2b", "--smoke", "--kernels", "--prompts",
                "2", "--max-tokens", "12", "--device", "cpu", "--grammar",
                "json_gsm8k", "--speculative", "--spec-s", "4"])
    out = capsys.readouterr().out
    assert "2 slots, contiguous KV]" in out
    assert len(re.findall(r"spec \d+/\d+\]", out)) == 2
