"""Failure semantics through the port's scheduler against ``repro``'s, on the
same weights, tokenizer, grammar and prompts, with the same seeded
``FaultInjector`` on both sides: the fired-fault logs (site, tick, rid),
statuses, token ids, ``status_counts``, preemptions, engine resets,
capacity shrinks and the degradation ladder's counters and final level
must be equal.  Cases: cancellation of a waiting and a resident request;
deadlines in the queue, mid-flight (by a shifted submit time, and by an
injected mask-build delay) and by default; the queue limit and the
queue-wait timeout; prompts rejected for the pool and for ``max_len``; the
chaos storm of ``tests/test_faults.py`` for two seeds; a targeted fault at
each host site; ``advance_error`` inside speculative verification on
attention and recurrent rows; the ``alloc_fail`` capacity shrink; a
``device_error`` storm that resets the engine down to the dense level and
climbs back; and ``check_invariants``, clean and then catching a
corrupted pool.  2 layers, d_model 64, float32 on the CPU."""
import types

import jax
import numpy as np
import pytest

from repro import serving as jserving
from repro.configs import base as jbase
from repro.core import grammars
from repro.models import build_model
from repro_torch import serving as tserving
from repro_torch.configs import base as tbase
from repro_torch.serving import scheduler as tscheduler
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_from_numpy

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            dtype="float32", max_seq_len=512)
PROMPTS = ["a: ", "some much longer json prompt here: ", "x",
           "record -> ", "{", "data: "]
SPEC_PROMPTS = ["A: ", "Q: compute 1 + 2\nA: "]
ARCHS = {
    "attn": dict(family="dense"),
    "hybrid": dict(family="hybrid",
                   group=("mamba2", "mamba2", "shared_attn"),
                   ssm=dict(d_state=8, version=2, head_dim=16)),
}
STORM = {"mask_error": 0.08, "decode_nan": 0.08, "advance_error": 0.08,
         "prefill_nan": 0.05, "page_exhaustion": 0.25}
ROW_SITES = ("mask_error", "decode_nan", "advance_error", "prefill_nan")
# one namespace a framework, so a case is written once for both
J = types.SimpleNamespace(**{n: getattr(jserving, n)
                             for n in jserving.__all__})
T = types.SimpleNamespace(**{n: getattr(tserving, n)
                             for n in tserving.__all__})


def _cfg(mod, arch, tok):
    a = ARCHS[arch]
    sub = {"ssm": mod.SSMConfig(**a["ssm"])} if "ssm" in a else {}
    extra = {"group": a["group"]} if "group" in a else {}
    return mod.ModelConfig(arch_id=f"tf-{arch}", family=a["family"],
                           vocab_size=tok.vocab_size, **BASE, **extra,
                           **sub)


@pytest.fixture(scope="module")
def pair(small_tokenizer, json_grammar):
    """``pair(arch, grammar, max_len, **engine_config)`` -> a fresh (JAX
    engine, port engine) on one set of weights an arch."""
    tok = small_tokenizer
    built = {}

    def make(arch="attn", grammar=json_grammar, max_len=256, **ec):
        if arch not in built:
            m = build_model(_cfg(jbase, arch, tok))
            params = m.init(jax.random.PRNGKey(0))
            tcfg = _cfg(tbase, arch, tok)
            tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                        tcfg, device="cpu")
            built[arch] = (m, params, t_build_model(tcfg), tparams, {})
        m, params, tm, tparams, steps = built[arch]
        ec = dict(dict(mode="domino", max_tokens=10), **ec)
        eng = J.ServingEngine(m, params, tok, grammar,
                              jserving.EngineConfig(**ec), max_len=max_len)
        # one model's jitted steps serve all its engines: compiled once
        eng._prefill, eng._decode = steps.setdefault(
            max_len, (eng._prefill, eng._decode))
        teng = T.ServingEngine(tm, tparams, tok, grammar,
                               tserving.EngineConfig(**ec), max_len=max_len,
                               device="cpu")
        return eng, teng
    return make


def _drive(ns, eng, reqs, inj=None, sup=None, **kw):
    """Submit ``reqs(ns)`` to a scheduler of framework ``ns`` and run it.
    ``inj``/``sup`` are keyword dicts of a fresh FaultInjector and
    DegradationSupervisor.  Returns (sessions, scheduler, injector)."""
    injector = None if inj is None else ns.FaultInjector(**inj)
    sched = ns.ContinuousBatchingScheduler(
        eng, fault_injector=injector,
        supervisor=None if sup is None else ns.DegradationSupervisor(**sup),
        **kw)
    sessions = [sched.submit(r) for r in reqs(ns)]
    sched.run()
    return sessions, sched, injector


def _log(inj):
    return [(r.site, r.tick, r.rid) for r in inj.log]


def _same_run(ref, got):
    (rs, rsched, rinj), (gs, gsched, ginj) = ref, got
    assert [s.result.status for s in gs] == [s.result.status for s in rs]
    assert [s.result.token_ids for s in gs] == \
        [s.result.token_ids for s in rs]
    assert [s.result.error is None for s in gs] == \
        [s.result.error is None for s in rs]
    if rinj is not None:
        assert _log(ginj) == _log(rinj)
    assert gsched.status_counts == rsched.status_counts
    for k in ("n_preempt", "n_engine_resets", "n_capacity_shrinks",
              "n_replayed_tokens", "_cap_eff"):
        assert getattr(gsched, k) == getattr(rsched, k), k
    for k in ("n_degrades", "n_recovers", "n_retries", "level"):
        assert getattr(gsched.sup, k) == getattr(rsched.sup, k), k
    assert [r for r, _ in gsched._fail_log] == \
        [r for r, _ in rsched._fail_log]


def _both(eng, teng, reqs, **kw):
    ref = _drive(J, eng, reqs, **kw)
    got = _drive(T, teng, reqs, **kw)
    _same_run(ref, got)
    return ref, got


def _prompts(ps):
    return lambda ns: list(ps)


def _requests(*rows):
    """Requests of framework ``ns``: rows of (prompt, DecodeParams
    keywords) under the engine-default DOMINO grammar."""
    def make(ns):
        return [ns.Request(p, ns.ConstraintSpec(grammar="default",
                                                mode="domino"),
                           ns.DecodeParams(**dp)) for p, dp in rows]
    return make


def _pool_drained(sched):
    assert all(s is None for s in sched.slots) and not sched.waiting
    if sched.paged:
        assert sched.pool.available == sched.n_pages - 1
        assert not sched._page_tbl.any()


# -- lifecycle: cancel, deadlines, queue bounds ----------------------------


def test_cancel_waiting_and_resident(pair):
    eng, teng = pair(max_tokens=50)
    out = []
    for ns, e in ((J, eng), (T, teng)):
        sched = ns.ContinuousBatchingScheduler(e, capacity=1,
                                               debug_invariants=True)
        s0, s1 = sched.submit("a: "), sched.submit("x")
        sched.step()                   # s0 resident, s1 waiting
        assert s0.slot >= 0 and s1.slot == -1
        assert sched.cancel(s0.rid) and sched.cancel(s1.rid)
        assert not sched.cancel(999)
        sched.step()                   # honoured at the tick boundary
        assert sched.cancel(s0.rid) is False
        res = sched.run()
        _pool_drained(sched)
        out.append([(r.status, r.error, r.token_ids) for r in res])
    assert out[1] == out[0]
    assert [s for s, _, _ in out[1]] == ["cancelled", "cancelled"]
    assert "decoding" in out[1][0][1] and "waiting" in out[1][1][1]


def test_deadline_in_queue_mid_flight_and_by_default(pair):
    eng, teng = pair(max_tokens=50)
    out = []
    for ns, e in ((J, eng), (T, teng)):
        spec = ns.ConstraintSpec(grammar="default", mode="domino")
        sched = ns.ContinuousBatchingScheduler(e, capacity=1,
                                               debug_invariants=True)
        s0 = sched.submit(ns.Request("a: ", spec, ns.DecodeParams(
            max_tokens=50, deadline_s=0.0)))
        sched.step()                   # expired in the queue: never runs
        s1 = sched.submit(ns.Request("a: ", spec, ns.DecodeParams(
            max_tokens=50, deadline_s=1e9)))
        sched.step()
        sched.step()
        assert s1.slot >= 0 and s1.result is None
        s1.t_submit -= 2e9             # its wall time runs out mid-flight
        sched.step()
        _pool_drained(sched)
        dflt = ns.ContinuousBatchingScheduler(e, capacity=1,
                                              default_deadline_s=0.0)
        s2 = dflt.submit("a: ")
        dflt.step()
        out.append([(s.result.status, s.result.token_ids)
                     for s in (s0, s1, s2)])
    assert out[1] == out[0]
    assert [s for s, _ in out[1]] == ["deadline_exceeded"] * 3
    assert out[1][0][1] == [] and len(out[1][1][1]) == 2


def test_deadline_expires_in_an_injected_mask_delay(pair):
    """A targeted ``mask_delay`` sleeps past the row's deadline inside its
    first mask build: the row commits that tick's token and ends
    ``deadline_exceeded`` at the next boundary; its batch-mates finish as
    without the fault."""
    eng, teng = pair(max_tokens=12)
    plain = _requests(("a: ", {}), ("x", {}), ("record -> ", {}))
    base = _both(eng, teng, plain, capacity=3)         # also warms both
    reqs = _requests(("a: ", {}), ("x", dict(deadline_s=1.0)),
                     ("record -> ", {}))
    ref, got = _both(eng, teng, reqs, capacity=3, debug_invariants=True,
                     inj=dict(seed=0, rates={"mask_delay": 1.0},
                              targets={1}, max_faults=1, delay_s=1.3))
    res = [s.result for s in got[0]]
    assert res[1].status == "deadline_exceeded"
    assert res[1].token_ids == base[1][0][1].result.token_ids[:1]
    for i in (0, 2):
        assert res[i].token_ids == base[1][0][i].result.token_ids


def test_queue_limit_and_queue_timeout(pair):
    eng, teng = pair()
    ref, got = _both(eng, teng, _prompts(PROMPTS[:5]), capacity=1,
                     queue_limit=2)
    st = [s.result.status for s in got[0]]
    assert st.count("rejected") == 3 and st.count("ok") == 2
    assert all("queue_limit" in s.result.error for s in got[0]
               if s.result.status == "rejected")
    ref, got = _both(eng, teng, _prompts(PROMPTS[:2]), capacity=1,
                     queue_timeout_s=0.0)
    assert [s.result.status for s in got[0]] == ["rejected"] * 2
    assert "timeout" in got[0][0].result.error


@pytest.mark.parametrize("paged", [True, False])
def test_oversized_prompt_rejected(pair, paged):
    """A prompt the pool (paged) or ``max_len`` (dense) can never hold is
    rejected instead of blocking the queue; the request behind it
    completes."""
    big = "{\"k\": [" + ", ".join(str(i) for i in range(80)) + "]} "
    eng, teng = pair(max_len=256 if paged else 32)
    kw = (dict(paged=True, page_size=16, n_pages=4) if paged
          else dict(paged=False))
    ref, got = _both(eng, teng, _prompts([big, "a: "]), capacity=2,
                     debug_invariants=True, **kw)
    r = [s.result for s in got[0]]
    assert r[0].status == "rejected" and r[1].status == "ok"
    assert ("pool" if paged else "max_len") in r[0].error
    _pool_drained(got[1])


# -- seeded faults ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_storm_matches_reference(pair, seed):
    """The acceptance storm of ``tests/test_faults.py``: the same faults
    fire at the same ticks on the same rows in both frameworks, no page or
    slot leaks (audited every tick), unaffected rows bitwise equal to the
    fault-free run, affected rows non-ok with a valid prefix or equal."""
    eng, teng = pair()
    kw = dict(capacity=2, paged=True, page_size=16, n_pages=12)
    base = _both(eng, teng, _prompts(PROMPTS), **kw)[1][0]
    ref, got = _both(eng, teng, _prompts(PROMPTS), debug_invariants=True,
                     inj=dict(seed=seed, rates=STORM, max_faults=25), **kw)
    sess, sched, inj = got
    assert len({r.site for r in inj.log}) >= 3, inj.log
    _pool_drained(sched)
    affected = inj.faulted_rids(*ROW_SITES)
    for s, b in zip(sess, base):
        r, b = s.result, b.result
        if s.rid in affected:
            assert (r.status != "ok" and r.error) \
                or r.token_ids == b.token_ids
            assert r.token_ids == b.token_ids[:r.n_tokens]
        else:
            assert (r.status, r.token_ids) == (b.status, b.token_ids)


@pytest.mark.parametrize("site,frag", [
    ("mask_error", "checker failed"), ("decode_nan", "non-finite"),
    ("prefill_nan", "non-finite"), ("advance_error", "checker failed"),
    ("page_exhaustion", None), ("alloc_fail", None), ("mask_delay", None),
    ("device_error", None)])
def test_targeted_fault_at_each_host_site(pair, site, frag):
    """One fault at one host site, pinned to rid 1 where the site is a
    row's: a row fault fails that row alone (its partial output a prefix
    of the fault-free one), and pressure or device faults change no
    output."""
    eng, teng = pair()
    kw = dict(capacity=3, paged=True, page_size=4, n_pages=40)
    base = _both(eng, teng, _prompts(PROMPTS[:3]), **kw)[1][0]
    ref, got = _both(eng, teng, _prompts(PROMPTS[:3]), debug_invariants=True,
                     inj=dict(seed=0, rates={site: 1.0}, targets={1},
                              max_faults=1), **kw)
    sess, sched, inj = got
    assert inj.n_fired(site) == 1
    for s, b in zip(sess, base):
        r, b = s.result, b.result
        if frag is not None and s.rid == 1:
            assert r.status == "internal_error" and frag in r.error
            assert r.token_ids == b.token_ids[:r.n_tokens]
        else:
            assert (r.status, r.token_ids) == (b.status, b.token_ids)
    _pool_drained(sched)


@pytest.mark.parametrize("arch", ["attn", "hybrid"])
def test_advance_error_during_speculation(pair, arch):
    """A checker failure inside speculative verification fails that row
    only: rolled back on attention rows, refed on recurrent ones."""
    eng, teng = pair(arch, grammar=grammars.load("json_gsm8k"),
                     max_tokens=16, speculative=True, spec_s=4,
                     spec_threshold=0.4)
    for e in (eng, teng):
        e.generate(SPEC_PROMPTS[0])    # warm the count models alike
    base = _both(eng, teng, _prompts(SPEC_PROMPTS), capacity=2)[1][0]
    ref, got = _both(eng, teng, _prompts(SPEC_PROMPTS), capacity=2,
                     debug_invariants=True,
                     inj=dict(seed=0, rates={"advance_error": 1.0},
                              targets={1}, max_faults=1))
    sess, sched, inj = got
    assert sess[1].result.status == "internal_error"
    assert sess[0].result.token_ids == base[0].result.token_ids
    assert sum(s.result.n_spec_proposed for s in sess) > 0
    _pool_drained(sched)


def test_alloc_fail_shrinks_capacity_outputs_invariant(pair):
    eng, teng = pair()
    base = _both(eng, teng, _prompts(PROMPTS), capacity=3)[1][0]
    ref, got = _both(eng, teng, _prompts(PROMPTS), capacity=3, paged=True,
                     page_size=4, n_pages=40, debug_invariants=True,
                     inj=dict(seed=5, rates={"alloc_fail": 1.0},
                              max_faults=2))
    sess, sched, inj = got
    assert inj.n_fired("alloc_fail") > 0 and sched.n_capacity_shrinks > 0
    assert sched.stats()["n_capacity_shrinks"] == sched.n_capacity_shrinks
    assert [s.result.token_ids for s in sess] == \
        [b.result.token_ids for b in base]
    assert 1 <= sched._cap_eff <= sched.capacity
    _pool_drained(sched)


@pytest.mark.parametrize("arch", ["attn", "hybrid"])
def test_device_error_resets_down_to_dense_and_back(pair, arch,
                                                    monkeypatch):
    """Four injected readback errors against one retry a guard: two engine
    resets, the ladder down to level 2 and back to 0 after clean ticks;
    every output equals the fault-free run's.  The port's dense level goes
    on selecting through the masked-argmax wrapper (the kernel, on the
    card), on the scratch the reset has just dropped.  On dense recurrent rows the reference's reset raises (its
    ``_preempt`` frees pages the rows do not have), so there the port is
    held to the fault-free runs of both frameworks."""
    eng, teng = pair(arch, max_tokens=12)
    base = _both(eng, teng, _prompts(PROMPTS[:4]), capacity=2)[1][0]
    sups, levels = [], []

    class Supervisor(T.DegradationSupervisor):
        def __init__(self, **kw):
            super().__init__(**kw)
            sups.append(self)

    def masked_argmax(logits, mask):
        levels.append(sups[-1].level)
        return wrapper(logits, mask)

    wrapper = tscheduler.masked_argmax
    monkeypatch.setattr(T, "DegradationSupervisor", Supervisor)
    monkeypatch.setattr(tscheduler, "masked_argmax", masked_argmax)
    kw = dict(capacity=2, debug_invariants=True,
              inj=dict(seed=2, rates={"device_error": 1.0}, max_faults=4),
              sup=dict(max_retries=1, backoff_s=0.0, recover_after=2))
    if arch == "attn":
        ref, got = _both(eng, teng, _prompts(PROMPTS[:4]), **kw)
        assert [(e.kind, e.level) for e in got[1].sup.events] == \
            [(e.kind, e.level) for e in ref[1].sup.events]
    else:
        got = _drive(T, teng, _prompts(PROMPTS[:4]), **kw)
    sess, sched, inj = got
    assert inj.n_fired("device_error") == 4
    assert sched.n_engine_resets == 2
    assert [(e.kind, e.level) for e in sched.sup.events
            if e.kind != "retry"] == [("degrade", 1), ("degrade", 2),
                                      ("recover", 1), ("recover", 0)]
    assert 2 in levels
    assert [(s.result.status, s.result.token_ids) for s in sess] == \
        [(b.result.status, b.result.token_ids) for b in base]
    assert sched.stats()["level"] == 0
    _pool_drained(sched)


def test_check_invariants_clean_then_catches_corruption(pair):
    eng, teng = pair(max_tokens=30)
    for ns, e in ((J, eng), (T, teng)):
        sched = ns.ContinuousBatchingScheduler(e, capacity=2, paged=True,
                                               page_size=16, n_pages=12)
        for p in PROMPTS[:2]:
            sched.submit(p)
        sched.step()
        sched.step()
        assert ns.check_invariants(sched) == []
        leaked = sched.pool._free.pop()
        assert any("leak" in p for p in ns.check_invariants(sched))
        sched.pool._free.append(leaked)
        resident = next(s for s in sched.slots if s is not None)
        resident.slot += 7
        assert any("slot" in p for p in ns.check_invariants(sched))
        resident.slot -= 7
        assert ns.check_invariants(sched) == []
        sched.debug_invariants = True
        sched.pool._free.pop()
        with pytest.raises(ns.InvariantViolation):
            sched.step()


def test_single_request_deadline(pair):
    eng, teng = pair(max_tokens=200)
    got = teng.generate(T.Request("a: ", T.ConstraintSpec(
        grammar="default", mode="domino"), T.DecodeParams(
            max_tokens=200, deadline_s=0.0)))
    assert got.status == "deadline_exceeded" and got.error


def test_device_loop_and_prefix_cache_arguments_are_taken(pair):
    """The prefix cache and the fused loop's arguments are taken:
    ``prefix_cache=True`` gives the cold run's output (a repeated prompt
    hits the cache), and an engine without device tables keeps every row
    on the host path with ``device_loop``/``sync_n``, so the output is the
    host path's."""
    _, teng = pair()
    plain = teng.generate_batch(["a: ", "a: "])
    warm = teng.generate_batch(["a: ", "a: "], page_size=2,
                               prefix_cache=True)
    assert [r.token_ids for r in warm] == [r.token_ids for r in plain]
    assert teng.last_batch_stats["n_prefix_hits"] > 0
    sched = T.ContinuousBatchingScheduler(teng, prefix_cache=True)
    assert sched.prefix_cache is not None
    for kw in (dict(device_loop=True), dict(sync_n=4)):
        got = teng.generate_batch(["a: "], **kw)
        assert got[0].token_ids == plain[0].token_ids
        assert got[0].n_device_tokens == 0
