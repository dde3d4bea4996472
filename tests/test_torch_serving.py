"""Greedy serving through the port (``repro_torch.serving``) against
``repro``'s on the same weights, tokenizer, grammar and prompts: token ids,
statuses, interventions and forward counts must be equal, for the
single-request path and for the continuous-batching scheduler (paged with a
pool small enough to force recompute preemption, and contiguous), with
DOMINO and unconstrained rows in one batch.  The recurrent families (a
Mamba1 stack, a Mamba2 + shared-attention hybrid) serve on the dense
layout with exact-length admission, and must match too.  MLA (dense
family) and MLA + MoE serve over paged latent pools, kernel route on and
off.  float32 on the CPU; the port's kernel wrappers take their plain
versions here."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from repro.models import build_model
from repro.serving import (ConstraintSpec, DecodeParams, EngineConfig,
                           Request, ServingEngine)
from repro_torch.configs.base import MLAConfig as TMLAConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import SSMConfig as TSSMConfig
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ConstraintSpec as TConstraintSpec
from repro_torch.serving import DecodeParams as TDecodeParams
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TServingEngine

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            dtype="float32", max_seq_len=512)
PROMPTS = ["a: ", "some much longer json prompt here: ", "x", "record -> ",
           "data: "]


@pytest.fixture(scope="module")
def engines(small_tokenizer, json_grammar):
    """(JAX engine, port engine) pairs keyed by kernel route."""
    tok = small_tokenizer
    out = {}
    for kernels in (False, True):
        cfg = ModelConfig(arch_id="ts", family="dense",
                          vocab_size=tok.vocab_size, **BASE,
                          use_pallas_kernels=kernels)
        tcfg = TModelConfig(arch_id="ts", family="dense",
                            vocab_size=tok.vocab_size, **BASE,
                            use_pallas_kernels=kernels)
        m = build_model(cfg)
        params = m.init(jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
        eng = ServingEngine(m, params, tok, json_grammar,
                            EngineConfig(mode="domino", max_tokens=12),
                            max_len=256)
        teng = TServingEngine(t_build_model(tcfg), tparams, tok,
                              json_grammar,
                              TEngineConfig(mode="domino", max_tokens=12),
                              max_len=256, device="cpu")
        for e in (eng, teng):
            e.register_grammar("json", json_grammar)
        out[kernels] = (eng, teng)
    return out


def _same(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.token_ids == r.token_ids
        assert g.status == r.status
        assert g.n_interventions == r.n_interventions
        assert g.n_forward_passes == r.n_forward_passes
        assert g.n_preemptions == r.n_preemptions
        assert g.text == r.text


@pytest.mark.parametrize("prompt", PROMPTS[:3])
def test_generate_matches(engines, prompt):
    eng, teng = engines[False]
    _same([eng.generate(prompt)], [teng.generate(prompt)])


@pytest.mark.parametrize("paged", [True, False])
def test_generate_batch_matches_with_slot_reuse(engines, paged):
    """Five requests through two slots: slots are reused as rows
    finish."""
    eng, teng = engines[False]
    kw = dict(max_batch=2, paged=paged)
    _same(eng.generate_batch(PROMPTS, **kw),
          teng.generate_batch(PROMPTS, **kw))


def test_generate_batch_preempts_and_matches_through_kernel_route(engines):
    """A 6-page pool cannot hold two growing rows: the scheduler
    recompute-preempts, and outputs still match the reference (kernel
    route on: the JAX kernel interpreted, the port's plain version)."""
    eng, teng = engines[True]
    kw = dict(max_batch=2, page_size=8, n_pages=7)
    got = teng.generate_batch(PROMPTS, **kw)
    assert teng.last_batch_stats["n_preempt"] > 0
    _same(eng.generate_batch(PROMPTS, **kw), got)
    singles = [teng.generate(p) for p in PROMPTS]
    assert [s.token_ids for s in singles] == [g.token_ids for g in got]


def test_mixed_domino_and_unconstrained_rows_match(engines):
    eng, teng = engines[False]
    reqs, treqs = [], []
    for i, p in enumerate(PROMPTS):
        mode = "domino" if i % 2 == 0 else "unconstrained"
        grammar = "json" if mode == "domino" else None
        reqs.append(Request(p, ConstraintSpec(grammar=grammar, mode=mode),
                            DecodeParams(max_tokens=10)))
        treqs.append(TRequest(p, TConstraintSpec(grammar=grammar,
                                                 mode=mode),
                              TDecodeParams(max_tokens=10)))
    _same(eng.generate_batch(reqs, max_batch=3),
          teng.generate_batch(treqs, max_batch=3))


def test_opportunistic_rows_refuse_a_choice_past_the_tokenizer(
        small_tokenizer, json_grammar):
    """A head wider than the tokenizer (the serve CLI's ``--no-smoke``
    keeps a published head): the scheduler's raw argmax, which an
    opportunistic row proposes, may land on a column that is no token; the
    row then takes the masked pick, so it picks what a masked row picks.
    The extra columns are made to win every raw argmax."""
    tok = small_tokenizer
    v = tok.vocab_size
    tcfg = TModelConfig(arch_id="wide", family="dense", vocab_size=2 * v,
                        **BASE)
    model = t_build_model(tcfg)
    params = model.init(device="cpu")
    with torch.no_grad():
        params["lm_head"][:, v:] = 10 * params["lm_head"][:, :v].abs().max()
    eng = TServingEngine(model, params, tok, max_len=256, device="cpu")
    eng.register_grammar("json", json_grammar)
    runs = [eng.generate_batch(
        [TRequest(p, TConstraintSpec(grammar="json", mode="domino", k=2,
                                     opportunistic=opp),
                  TDecodeParams(max_tokens=10)) for p in PROMPTS[:3]],
        max_batch=3) for opp in (True, False)]
    assert all(r.status == "ok" and r.n_tokens for r in runs[0])
    assert [r.token_ids for r in runs[0]] == [r.token_ids for r in runs[1]]
    assert all(t < v for r in runs[0] for t in r.token_ids)


def test_speculative_requests_are_served(engines):
    """The speculative request is served on both paths, equal to the JAX
    engine's result, proposals and acceptances included."""
    eng, teng = engines[False]
    req = Request("a: ", ConstraintSpec(grammar="json", mode="domino"),
                  DecodeParams(speculative=True))
    treq = TRequest("a: ", TConstraintSpec(grammar="json", mode="domino"),
                    TDecodeParams(speculative=True))
    for ref, got in (([eng.generate(req)], [teng.generate(treq)]),
                     (eng.generate_batch([req]),
                      teng.generate_batch([treq]))):
        _same(ref, got)
        assert [(g.n_spec_proposed, g.n_spec_accepted) for g in got] == \
            [(r.n_spec_proposed, r.n_spec_accepted) for r in ref]


def test_engine_defaults_to_the_card(engines, small_tokenizer):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    _, teng = engines[False]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TServingEngine(teng.model, teng.params, small_tokenizer)


RECURRENT = {
    "mamba1": dict(family="ssm", group=("mamba1",),
                   ssm=dict(d_state=8, version=1)),
    "hybrid": dict(family="hybrid",
                   group=("mamba2", "mamba2", "shared_attn"),
                   ssm=dict(d_state=8, version=2, head_dim=16)),
}


@pytest.fixture(scope="module")
def recurrent_engines(small_tokenizer, json_grammar):
    """family -> (JAX engine, {kernels: port engine}) on one set of
    weights; the JAX side takes its plain route."""
    tok = small_tokenizer
    out = {}
    for family, f in RECURRENT.items():
        kw = dict(BASE, arch_id=f"ts-{family}", family=f["family"],
                  group=f["group"], vocab_size=tok.vocab_size)
        cfg = ModelConfig(ssm=SSMConfig(**f["ssm"]), **kw)
        m = build_model(cfg)
        params = m.init(jax.random.PRNGKey(1))
        eng = ServingEngine(m, params, tok, json_grammar,
                            EngineConfig(mode="domino", max_tokens=10),
                            max_len=256)
        ports = {}
        for kernels in (False, True):
            tcfg = TModelConfig(ssm=TSSMConfig(**f["ssm"]),
                                use_pallas_kernels=kernels, **kw)
            tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
            ports[kernels] = TServingEngine(
                t_build_model(tcfg), tparams, tok, json_grammar,
                TEngineConfig(mode="domino", max_tokens=10), max_len=256,
                device="cpu")
        out[family] = (eng, ports)
    return out


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("family", list(RECURRENT))
def test_recurrent_generate_matches(recurrent_engines, family, kernels):
    eng, ports = recurrent_engines[family]
    _same([eng.generate(p) for p in PROMPTS[:2]],
          [ports[kernels].generate(p) for p in PROMPTS[:2]])


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("family", list(RECURRENT))
def test_recurrent_generate_batch_matches_with_slot_reuse(
        recurrent_engines, family, kernels):
    """Five requests through two dense slots (exact-length admission, the
    recurrent state scattered into the reused slot) equal the JAX
    scheduler's results and the port's own single-request results."""
    eng, ports = recurrent_engines[family]
    teng = ports[kernels]
    got = teng.generate_batch(PROMPTS, max_batch=2)
    assert sum(g.n_tokens for g in got) > len(PROMPTS)
    _same(eng.generate_batch(PROMPTS, max_batch=2), got)
    assert [teng.generate(p).token_ids for p in PROMPTS] == \
        [g.token_ids for g in got]


def test_recurrent_arch_serves_dense_and_refuses_paging(recurrent_engines):
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    _, ports = recurrent_engines["hybrid"]
    assert ContinuousBatchingScheduler(ports[True], capacity=2).paged \
        is False
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingScheduler(ports[True], capacity=2, paged=True)


MLA = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16)
# tests/test_paged_kv.py's "p-mla" and tests/test_batch_serving.py's "b-mla"
LATENT = {
    "mla": dict(family="dense", group=("mla",), moe=None),
    "mla-moe": dict(family="moe", group=("moe",),
                    moe=dict(n_experts=4, top_k=2, d_ff_expert=64,
                             capacity_factor=2.0)),
}


@pytest.fixture(scope="module")
def latent_engines(small_tokenizer, json_grammar):
    """arch -> {kernels: (JAX engine, port engine)} on one set of
    weights."""
    tok = small_tokenizer
    out = {}
    for arch, a in LATENT.items():
        kw = dict(BASE, arch_id=f"ts-{arch}", family=a["family"],
                  group=a["group"], vocab_size=tok.vocab_size)
        pairs, params = {}, None
        for kernels in (False, True):
            cfg = ModelConfig(mla=MLAConfig(**MLA),
                              moe=a["moe"] and MoEConfig(**a["moe"]),
                              use_pallas_kernels=kernels, **kw)
            tcfg = TModelConfig(mla=TMLAConfig(**MLA),
                                moe=a["moe"] and TMoEConfig(**a["moe"]),
                                use_pallas_kernels=kernels, **kw)
            m = build_model(cfg)
            if params is None:
                params = m.init(jax.random.PRNGKey(2))
            tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
            eng = ServingEngine(m, params, tok, json_grammar,
                                EngineConfig(mode="domino", max_tokens=10),
                                max_len=256)
            teng = TServingEngine(t_build_model(tcfg), tparams, tok,
                                  json_grammar,
                                  TEngineConfig(mode="domino", max_tokens=10),
                                  max_len=256, device="cpu")
            pairs[kernels] = (eng, teng)
        out[arch] = pairs
    return out


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("arch", list(LATENT))
def test_latent_generate_batch_matches_paged(latent_engines, arch, kernels):
    """Five requests through two slots over a paged latent pool of 16-token
    pages: ids, statuses, interventions and forwards equal the JAX
    scheduler's, and the port's own single-request results."""
    eng, teng = latent_engines[arch][kernels]
    kw = dict(max_batch=2, page_size=16)
    got = teng.generate_batch(PROMPTS, **kw)
    assert teng.last_batch_stats["paged"]
    _same(eng.generate_batch(PROMPTS, **kw), got)
    if arch == "mla":     # no MoE: batch padding cannot move the routing
        assert [teng.generate(p).token_ids for p in PROMPTS] == \
            [g.token_ids for g in got]


@pytest.mark.parametrize("arch", list(LATENT))
def test_latent_generate_matches(latent_engines, arch):
    eng, teng = latent_engines[arch][True]
    _same([eng.generate(p) for p in PROMPTS[:2]],
          [teng.generate(p) for p in PROMPTS[:2]])


@pytest.mark.parametrize("arch,layout", [("zamba2-1.2b", "contiguous KV"),
                                         ("stablelm-1.6b", "paged KV"),
                                         ("deepseek-v3-671b", "paged KV")])
def test_serve_cli_prints_the_layout_the_scheduler_chose(capsys, arch,
                                                         layout):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--kernels", "--prompts", "2",
                "--max-tokens", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"2 slots, {layout}]" in out
    assert out.count("out[status=") == 2
