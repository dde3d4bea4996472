"""The radix prefix cache through the port's scheduler and engine against
``repro``'s, on the same weights, tokenizer, grammars and requests: every
case of ``tests/test_prefix_cache.py`` runs in both packages and must give
equal token ids, statuses, ``n_cached_prefix_tokens``, cache counters
(``n_prefix_hits``, ``n_prefix_tokens``, ``n_checker_clones`` and the
``prefix_*`` stats), preemptions, journal ``admit`` records and fault logs;
every run with the cache on leaves the pool leak-free after
``prefix_cache.reset()``, and warm ids equal cold ids in each package.

Cases: the pool's refcounts on one sequence of operations; the radix
tree's page-granular lookup, graft, LRU eviction and transitive
``evictable``; checker snapshots keyed on the prompt split; warm against
cold over prompts forking a shared preamble (greedy, sampled and
speculative rows); speculative rollback crossing the fork page; a tiny
pool's evictions and preemptions; a pinned prompt; the cache refused
without paging; the device loop warm against cold (byte-level tokenizer,
device tables); a crash restored with checker clones, and restored
without the cache; the serving bench's Zipf-preamble trace; a seeded
fault storm under the invariant audit; a ``device_error`` engine reset
that drops the cache.  2 layers, d_model 64, float32 on the CPU."""
import os
import types

import jax
import numpy as np
import pytest

from repro import serving as jserving
from repro.configs import base as jbase
from repro.core import grammars
from repro.core.domino import DominoDecoder as JDomino
from repro.core.sampling import GrammarSampler
from repro.models import build_model
from repro.serving.scheduler import PagePool as JPagePool
from repro.tokenizer import train_bpe
from repro_torch import serving as tserving
from repro_torch.configs import base as tbase
from repro_torch.core.domino import DominoDecoder as TDomino
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.scheduler import PagePool as TPagePool

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            dtype="float32", max_seq_len=512)
PRE = "shared system preamble with many common tokens in front: "


class _Framework(types.SimpleNamespace):
    __hash__ = object.__hash__      # a key of the engines fixtures


# one namespace a framework, so a case is written once for both
J = _Framework(**{n: getattr(jserving, n) for n in jserving.__all__},
               PagePool=JPagePool, Domino=JDomino)
T = _Framework(**{n: getattr(tserving, n) for n in tserving.__all__},
               PagePool=TPagePool, Domino=TDomino)
COUNTERS = ("n_prefix_hits", "n_prefix_tokens", "n_checker_clones",
            "n_preempt", "n_engine_resets")
RESULT_FIELDS = ("token_ids", "status", "finished", "dead_end",
                 "n_cached_prefix_tokens", "n_spec_proposed",
                 "n_spec_accepted")


def _models(tok, arch_id):
    """(JAX model, params, port model, port params) of one config."""
    cfg = dict(arch_id=arch_id, family="dense", vocab_size=tok.vocab_size,
               **BASE)
    m = build_model(jbase.ModelConfig(**cfg))
    params = m.init(jax.random.PRNGKey(0))
    tcfg = tbase.ModelConfig(**cfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return m, params, t_build_model(tcfg), tparams


@pytest.fixture(scope="module")
def engines(small_tokenizer, json_grammar):
    """{J: JAX engine, T: port engine}, "json" and "c" registered."""
    tok = small_tokenizer
    m, params, tm, tparams = _models(tok, "pfx")
    out = {J: J.ServingEngine(m, params, tok, max_len=256),
           T: T.ServingEngine(tm, tparams, tok, max_len=256, device="cpu")}
    for eng in out.values():
        eng.register_grammar("json", json_grammar)
        eng.register_grammar("c", grammars.load("c"))
        eng.precompute()
    return out


@pytest.fixture(scope="module")
def byte_engines(json_grammar):
    """The byte-level tokenizer on which the JSON grammar certifies clean,
    so both engines build device tables (the device-loop idiom)."""
    corpus = GrammarSampler(json_grammar, seed=7).corpus(80)
    tok = train_bpe(corpus, vocab_size=257)
    m, params, tm, tparams = _models(tok, "pfx-dev")
    out = {J: J.ServingEngine(m, params, tok, max_len=256,
                              device_tables=True),
           T: T.ServingEngine(tm, tparams, tok, max_len=256,
                              device_tables=True, device="cpu")}
    for eng in out.values():
        eng.register_grammar("json", json_grammar)
        eng.precompute()
        assert "json" in eng.device_tables
    return out


def _fork_requests(ns, seed=11):
    """Mixed-grammar requests forking a shared preamble at random token
    offsets: greedy, sampled and speculative rows."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(10):
        cut = int(rng.integers(10, len(PRE)))
        prompt = (PRE[:cut] if i % 3 else PRE) + f"req {i}: "
        if i % 4 == 3:
            spec = ns.ConstraintSpec()                   # unconstrained
        elif i % 2:
            spec = ns.ConstraintSpec(grammar="c", mode="domino")
        else:
            spec = ns.ConstraintSpec(grammar="json", mode="domino")
        dec = ns.DecodeParams(max_tokens=8,
                              temperature=(0.8 if i % 5 == 4 else 0.0),
                              seed=100 + i, speculative=(i % 6 == 2),
                              spec_s=4, spec_threshold=0.0)
        reqs.append(ns.Request(prompt, spec, dec))
    return reqs


def _drive(ns, eng, reqs, prefix_cache, n_pages=220, capacity=3, inj=None,
           **kw):
    sched = ns.ContinuousBatchingScheduler(
        eng, capacity=capacity, paged=True, page_size=8, n_pages=n_pages,
        prefix_cache=prefix_cache, debug_invariants=True,
        fault_injector=None if inj is None else ns.FaultInjector(**inj),
        **kw)
    sessions = [sched.submit(r) for r in reqs]
    sched.run()
    return sched, [s.result for s in sessions]


def _outcome(sched, results):
    """What must be equal across the two packages."""
    st = sched.stats()
    rows = [tuple(getattr(r, f) for f in RESULT_FIELDS) for r in results]
    counters = {k: getattr(sched, k) for k in COUNTERS}
    counters.update({k: v for k, v in st.items() if k.startswith("prefix_")})
    counters["status_counts"] = dict(sched.status_counts)
    return rows, counters


def _leak_free(ns, sched):
    """Leak-free drain: every page back once the cache lets go."""
    assert ns.check_invariants(sched) == []
    held = sched.prefix_cache.n_pages
    assert sched.pool.available == sched.n_pages - 1 - held
    sched.prefix_cache.reset()
    assert sched.pool.available == sched.n_pages - 1


def _both(fn):
    """``fn(ns)`` for each package; the port's outcome equals ``repro``'s.
    Returns the port's."""
    want, got = fn(J), fn(T)
    assert got == want
    return got


# -- PagePool refcounts --------------------------------------------------------


def test_pool_refcounts_alloc_retain_release():
    def trace(ns):
        pool = ns.PagePool(8)
        got = pool.alloc(3)
        out = [got, [pool.refcount(p) for p in got]]
        pool.retain(got[:2])
        out.append([pool.refcount(p) for p in got])
        avail = pool.available
        pool.release(got)              # drops the table references
        out.append(pool.available - avail)      # only got[2] hit zero
        pool.release(got[:2])          # drops the retained references
        out += [pool.available, [pool.refcount(p) for p in got],
                list(pool._free), pool.alloc(2)]
        return out
    out = _both(trace)
    assert out[1] == [1, 1, 1] and out[2] == [2, 2, 1] and out[3] == 1
    assert out[4] == 7 and out[5] == [0, 0, 0]


def test_pool_free_is_release_alias_and_asserts():
    for ns in (J, T):
        pool = ns.PagePool(4)
        assert ns.PagePool.free is ns.PagePool.release
        got = pool.alloc(2)
        pool.free(got)
        assert pool.available == 3
        with pytest.raises(AssertionError):
            pool.release([got[0]])     # double release
        with pytest.raises(AssertionError):
            pool.retain([got[0]])      # retain of a free page


# -- radix tree ----------------------------------------------------------------


def _ids(n, base=0):
    return list(range(base, base + n))


def test_radix_insert_lookup_page_granular():
    def trace(ns):
        pool = ns.PagePool(32)
        pc = ns.PrefixCache(pool, page_size=4)
        pages = pool.alloc(3)
        ids = _ids(12)
        out = [pc.insert(ids, pages)]
        pool.release(pages)            # the nodes keep the pages alive
        out += [pool.available, pc.n_pages]
        got = pc.lookup(ids, max_pages=(len(ids) - 1) // 4)
        out += [got == pages[:2], [pool.refcount(p) for p in got]]
        pool.release(got)
        fork = ids[:6] + [99] * 6      # diverges mid-page
        got = pc.lookup(fork, max_pages=2)
        out.append(got == pages[:1])
        pool.release(got)
        out += [pc.lookup([7] * 12, max_pages=2), pc.stats()]
        return out
    out = _both(trace)
    assert out[:6] == [3, 32 - 1 - 3, 3, True, [2, 2], True]
    assert out[6] == []


def test_radix_graft_keeps_incumbent_page():
    def trace(ns):
        pool = ns.PagePool(32)
        pc = ns.PrefixCache(pool, page_size=4)
        a = pool.alloc(2)
        pc.insert(_ids(8), a)
        b = pool.alloc(2)              # same tokens, other pages
        out = [pc.insert(_ids(8), b)]
        pool.release(b)
        out += [pc.n_pages, pc.owns(a[0]), pc.owns(b[0])]
        got = pc.lookup(_ids(8), max_pages=1)
        out.append(got == [a[0]])
        pool.release(got)
        pool.release(a)
        return out + [pc.stats()]
    assert _both(trace)[:5] == [0, 2, True, False, True]


def test_radix_eviction_lru_leaf_only_respects_refs_and_pins():
    def trace(ns):
        pool = ns.PagePool(32)
        pc = ns.PrefixCache(pool, page_size=2)
        chain = pool.alloc(3)
        pc.insert([1, 2, 3, 4, 5, 6], chain)
        pool.release(chain)
        other = pool.alloc(1)          # a sibling leaf, older access
        pc.insert([9, 9], other)
        pool.release(other)
        pool.release(pc.lookup([1, 2, 3, 4, 5, 6], max_pages=3))
        out = [pc.evict(1), pc.owns(other[0]), pc.owns(chain[0])]
        got = pc.lookup([1, 2, 3, 4, 5, 6], max_pages=3)
        out += [got == chain, pc.evict(10)]   # table-referenced: kept
        pool.release(got)
        pinned = pool.alloc(1)
        pc.insert([7, 7], pinned, pin=True)
        pool.release(pinned)
        out += [pc.evict(10), pc.owns(pinned[0]), pool.available]
        pc.reset()
        return out + [pool.available, pc.n_pages, pc.stats()]
    out = _both(trace)
    assert out[:9] == [1, False, True, True, 0, 3, True, 32 - 2, 32 - 1]


def test_evictable_counts_transitively():
    def trace(ns):
        pool = ns.PagePool(32)
        pc = ns.PrefixCache(pool, page_size=2)
        chain = pool.alloc(3)
        pc.insert([1, 2, 3, 4, 5, 6], chain)
        pool.release(chain)
        out = [pc.evictable()]
        got = pc.lookup([1, 2], max_pages=1)     # a table ref on the top
        out.append(pc.evictable())
        pool.release(got)
        return out + [pc.evictable()]
    assert _both(trace) == [3, 2, 3]


# -- checker snapshots -----------------------------------------------------------


def test_checker_snapshots_keyed_by_prompt_split(json_grammar,
                                                 small_tokenizer):
    tok = small_tokenizer

    def trace(ns):
        pc = ns.PrefixCache(ns.PagePool(4), page_size=4)
        d = ns.Domino(json_grammar, list(tok.vocab), tok.eos_id)
        toks = []
        for _ in range(3):
            legal = np.flatnonzero(d.mask())
            t = int(next(x for x in legal if x != tok.eos_id))
            assert d.advance(t)
            toks.append(t)
        sig = ("json", "domino", None, tok.eos_id)
        prompt = [5, 6, 7]
        pc.put_checker(sig, len(prompt), prompt + toks, d)
        n, clone = pc.get_checker(sig, len(prompt), prompt + toks)
        out = [toks, n, clone.n_mask_memo_hits,
               np.array_equal(clone.mask_bits(), d.mask_bits())]
        n2, _ = pc.get_checker(sig, len(prompt), prompt + toks + [1, 2])
        out += [n2, pc.get_checker(sig, len(prompt) - 1, prompt + toks),
                pc.get_checker(("c",) + sig[1:], len(prompt),
                               prompt + toks), pc.stats()]
        return out
    out = _both(trace)
    assert out[1:7] == [6, 0, True, 6, None, None]


# -- serving: warm against cold ----------------------------------------------------


def _warm_cold(engines, reqs_of, **kw):
    """Cold then warm in each package: warm ids equal cold ids, and the
    warm run's outcome equals ``repro``'s.  Returns the port's warm
    (scheduler, results)."""
    got = {}
    for ns in (J, T):
        _, cold = _drive(ns, engines[ns], reqs_of(ns), False, **kw)
        sched, warm = _drive(ns, engines[ns], reqs_of(ns), True, **kw)
        for c, w in zip(cold, warm):
            assert (w.token_ids, w.status, w.finished, w.dead_end) == \
                (c.token_ids, c.status, c.finished, c.dead_end)
        assert all(c.n_cached_prefix_tokens == 0 for c in cold)
        got[ns] = (sched, warm, _outcome(sched, warm))
    assert got[T][2] == got[J][2]
    for ns in (J, T):
        _leak_free(ns, got[ns][0])
    return got[T][:2]


def test_warm_cache_bitwise_identical_to_cold(engines):
    sched, warm = _warm_cold(engines, _fork_requests)
    assert sched.n_prefix_hits > 0 and sched.n_prefix_tokens > 0
    assert any(w.n_cached_prefix_tokens > 0 for w in warm)
    assert any(w.n_spec_proposed > 0 for w in warm)


def test_speculative_rollback_crossing_fork_page(engines):
    """Speculative rows whose rollback rewinds into the first private page
    after the fork: the shared boundary is never crossed (the frontier
    floor is one past the shared prefix, and ``_shrink_pages`` releases
    one reference a page)."""
    def reqs(ns):
        return [ns.Request(PRE + f"s{i} ",
                           ns.ConstraintSpec(grammar="json", mode="domino"),
                           ns.DecodeParams(max_tokens=10, speculative=True,
                                           spec_s=6, spec_threshold=0.0,
                                           seed=i))
                for i in range(4)]
    sched, warm = _warm_cold(engines, reqs, capacity=4)
    assert sched.n_prefix_hits > 0
    assert any(r.n_spec_proposed > r.n_spec_accepted for r in warm)


def test_tiny_pool_eviction_and_preemption_pressure(engines):
    """An undersized pool forces cache evictions; outputs stay equal to a
    cold cache and the pool drains leak-free."""
    sched, _ = _warm_cold(engines, lambda ns: _fork_requests(ns, seed=23),
                          n_pages=16, capacity=3)
    assert sched.stats()["prefix_n_evicted"] > 0


def test_pinned_prompt_first_request_hits(engines):
    def run(ns):
        eng = engines[ns]
        eng.pin_prompt(PRE)
        try:
            sched = ns.ContinuousBatchingScheduler(
                eng, capacity=2, paged=True, page_size=8, n_pages=220,
                prefix_cache=True, debug_invariants=True)
            sched._pin_prompts()
            pinned = sched.prefix_cache.n_pages
            assert pinned > 0 and sched.slots[0] is None
            assert int(sched.cache["len"][0]) == 0
            sess = sched.submit(ns.Request(
                PRE + "x", ns.ConstraintSpec(grammar="json", mode="domino"),
                ns.DecodeParams(max_tokens=4)))
            sched.run()
            r = sess.result
            sched.prefix_cache.evict(10 ** 6)     # pins survive
            return (pinned, sched.prefix_cache.n_pages >= pinned,
                    _outcome(sched, [r]))
        finally:
            eng.pinned_prompts.clear()
    pinned, kept, (rows, counters) = _both(run)
    assert kept and rows[0][1] == "ok" and rows[0][4] > 0
    assert counters["n_prefix_hits"] >= 1


def test_pinned_prompt_through_generate_batch(engines):
    """``generate_batch(..., prefix_cache=True)`` pins the engine's prompts
    before admission: the very first request hits, with the cold run's
    ids."""
    def run(ns):
        eng = engines[ns]
        req = ns.Request(PRE + "y", ns.ConstraintSpec(grammar="json",
                                                      mode="domino"),
                         ns.DecodeParams(max_tokens=6))
        cold = eng.generate_batch([req], page_size=8)
        eng.pin_prompt(PRE)
        try:
            warm = eng.generate_batch([req], page_size=8, prefix_cache=True)
        finally:
            eng.pinned_prompts.clear()
        assert warm[0].token_ids == cold[0].token_ids
        return warm[0].token_ids, warm[0].n_cached_prefix_tokens
    _, n_cached = _both(run)
    assert n_cached > 0


def test_cache_requires_paged(engines):
    for ns in (J, T):
        with pytest.raises(ValueError, match="prefix_cache"):
            ns.ContinuousBatchingScheduler(engines[ns], capacity=1,
                                           paged=False, prefix_cache=True)


# -- the device loop ------------------------------------------------------------


def test_device_loop_warm_vs_cold(byte_engines):
    """Certified greedy rows admitted through the cache decode in fused
    blocks and stay equal to a cold cache, in both packages."""
    pre = "shared device preamble common to every request: "

    def reqs(ns):
        return [ns.Request(pre + f"d{i} ",
                           ns.ConstraintSpec(grammar="json", mode="domino"),
                           ns.DecodeParams(max_tokens=12))
                for i in range(4)]
    sched, warm = _warm_cold(byte_engines, reqs, capacity=2, n_pages=128,
                             device_loop=True, sync_n=4)
    assert sched.n_prefix_hits > 0
    assert any(w.n_device_tokens > 0 for w in warm)
    assert sched._fused is not None and sched._fused.n_blocks > 0


# -- crash and restore ------------------------------------------------------------


def _crash_run(ns, eng, reqs, path, capacity, n_steps):
    """A journaled warm run stepped ``n_steps`` times, then dropped (a
    crash: no drain, no close)."""
    sched = ns.ContinuousBatchingScheduler(
        eng, capacity=capacity, paged=True, page_size=8, n_pages=220,
        prefix_cache=True, journal=ns.TokenJournal(path),
        debug_invariants=True)
    sessions = [sched.submit(r) for r in reqs]
    for _ in range(n_steps):
        sched.step()
    assert any(s.result is None for s in sessions)


def _admits(path):
    """The journal's admit records, in order."""
    return [r for r in tserving.read_records(path) if r["kind"] == "admit"]


def test_restore_adopts_checker_snapshots_bitwise_identical(engines,
                                                            tmp_path):
    """Crash mid-run and restore with the cache: live entries adopt cloned
    fork-point snapshots (``n_checker_clones > 0``), admissions re-acquire
    pages through the cache and their admit records say so; every restored
    row equals an uninterrupted run."""
    def run(ns):
        eng = engines[ns]
        reqs = [ns.Request(PRE, ns.ConstraintSpec(grammar="json",
                                                  mode="domino"),
                           ns.DecodeParams(max_tokens=12))
                for _ in range(3)]
        _, ref = _drive(ns, eng, reqs, True)
        path = os.fspath(tmp_path / f"crash-{ns is T}.journal")
        _crash_run(ns, eng, reqs, path, 2, 5)
        restored = eng.restore(path, max_batch=2, paged=True, page_size=8,
                               n_pages=220, prefix_cache=True,
                               debug_invariants=True)
        clones = restored.n_checker_clones
        cached = [s.cached_checker for s in
                  list(restored.waiting) + restored.finished]
        restored.run()
        by_rid = {s.rid: s.result for s in restored.finished}
        for rid, want in enumerate(ref):
            assert (by_rid[rid].token_ids, by_rid[rid].status) == \
                (want.token_ids, want.status)
        entries = ns.replay_journal(path)
        _leak_free(ns, restored)
        return (clones, cached, [e.n_cached_pages for e in entries.values()],
                _admits(path),
                _outcome(restored, [by_rid[r] for r in sorted(by_rid)]))
    clones, cached, n_cached, admits, _ = _both(run)
    assert clones > 0 and any(cached) and any(n > 0 for n in n_cached)
    assert any(a["cached_pages"] > 0 for a in admits)


def test_restore_cold_cache_falls_back_to_full_prefill(engines, tmp_path):
    """The same kind of crash journal restores equal without the cache (a
    full re-prefill)."""
    def run(ns):
        eng = engines[ns]
        reqs = [ns.Request("A json value follows: ",
                           ns.ConstraintSpec(grammar="json", mode="domino"),
                           ns.DecodeParams(max_tokens=10))
                for _ in range(2)]
        _, ref = _drive(ns, eng, reqs, True)
        path = os.fspath(tmp_path / f"cold-{ns is T}.journal")
        _crash_run(ns, eng, reqs, path, 1, 4)
        restored = eng.restore(path, max_batch=1, paged=True, page_size=8,
                               n_pages=220, debug_invariants=True)
        restored.run()
        by_rid = {s.rid: s.result for s in restored.finished}
        assert [by_rid[i].token_ids for i in range(len(ref))] == \
            [r.token_ids for r in ref]
        assert restored.n_checker_clones == 0
        return [by_rid[i].token_ids for i in range(len(ref))], \
            _admits(path)
    _both(run)


# -- the serving bench's trace, faults, engine reset ----------------------------------

# the reference serving bench's Zipf-preamble traffic
# (benchmarks/serving_bench.py), with its page size, pool and slots
PFX_PREAMBLES = [
    "You are a strict data formatter; always answer with one value and "
    "nothing else. The schema below is authoritative and versioned. " * 2,
    "System: the following conversation extracts configuration records "
    "from logs; keep keys stable across turns and quote every string. ",
    "Common few-shot preamble: {\"a\": 1} {\"b\": [2, 3]} now continue "
    "in exactly the same style for the next record. ",
]


def _zipf_trace(ns, n=16, max_tokens=4):
    rng = np.random.default_rng(42)
    picks = np.minimum(rng.zipf(1.4, size=n), len(PFX_PREAMBLES)) - 1
    specs = [ns.ConstraintSpec(grammar="json", mode="domino"),
             ns.ConstraintSpec(grammar="c", mode="domino"),
             ns.ConstraintSpec()]
    return [ns.Request(PFX_PREAMBLES[picks[i]] + f"q{i}: ",
                       specs[i % len(specs)],
                       ns.DecodeParams(max_tokens=max_tokens, seed=i))
            for i in range(n)]


def _shareable(sched, page_size):
    """Whole-page tokens each request shares with any earlier one."""
    ids = [s.prompt_ids for s in sorted(sched.finished,
                                        key=lambda s: s.rid)]
    total = 0
    for i in range(1, len(ids)):
        best = max(next((k for k, (a, b) in enumerate(zip(ids[i], ids[j]))
                         if a != b), min(len(ids[i]), len(ids[j])))
                   for j in range(i))
        total += best // page_size * page_size
    return total


def test_bench_zipf_trace(engines):
    """The bench's 16 Zipf-preamble requests (16-token pages, 160 pages, 4
    slots, ``max_tokens`` 4): warm equals cold, at least 90% of the
    shareable prefill tokens skipped, hits, tokens skipped and evictions
    equal to ``repro``'s."""
    def run(ns):
        eng = engines[ns]
        out = []
        for pc in (False, True):
            sched = ns.ContinuousBatchingScheduler(
                eng, capacity=4, page_size=16, n_pages=160,
                prefix_cache=pc, debug_invariants=True)
            sess = [sched.submit(r) for r in _zipf_trace(ns)]
            sched.run()
            out.append((sched, [s.result for s in sess]))
        (_, cold), (sched, warm) = out
        assert [r.token_ids for r in warm] == [r.token_ids for r in cold]
        assert all(r.status == "ok" for r in warm)
        assert sched.n_prefix_tokens >= 0.9 * _shareable(sched, 16)
        o = _outcome(sched, warm)
        _leak_free(ns, sched)
        return o
    _, counters = _both(run)
    assert counters["n_prefix_hits"] > 0


def test_fault_storm_with_cache(engines):
    """A seeded storm of row faults and dry pools with the cache on, under
    the invariant audit: equal fault logs, statuses and ids."""
    storm = {"mask_error": 0.08, "decode_nan": 0.08,
             "advance_error": 0.08, "prefill_nan": 0.05,
             "page_exhaustion": 0.25}

    def run(ns):
        sched, res = _drive(ns, engines[ns], _fork_requests(ns, seed=5),
                            True, n_pages=40,
                            inj=dict(seed=3, rates=storm, max_faults=12))
        log = [(r.site, r.tick, r.rid) for r in sched.injector.log]
        _leak_free(ns, sched)
        return log, _outcome(sched, res), [r for r, _ in sched._fail_log]
    log, (rows, _), _ = _both(run)
    assert len({site for site, _, _ in log}) >= 3
    assert any(r[1] != "ok" for r in rows)


def test_device_error_reset_drops_the_cache(engines):
    """A ``device_error`` at the tick readback resets the engine: the cache
    is emptied before the residents are preempted (they donate nothing),
    and the re-admissions refill it; outputs equal the fault-free run."""
    def run(ns):
        eng = engines[ns]
        reqs = _fork_requests(ns, seed=7)
        _, base = _drive(ns, eng, reqs, True)
        sched = ns.ContinuousBatchingScheduler(
            eng, capacity=3, paged=True, page_size=8, n_pages=220,
            prefix_cache=True, debug_invariants=True,
            fault_injector=ns.FaultInjector(seed=2,
                                            rates={"device_error": 1.0},
                                            max_faults=2),
            supervisor=ns.DegradationSupervisor(max_retries=1,
                                                backoff_s=0.0,
                                                recover_after=4))
        sess = [sched.submit(r) for r in reqs]
        seen = []
        while sched.waiting or any(s is not None for s in sched.slots):
            resets = sched.n_engine_resets
            sched.step()
            if sched.n_engine_resets > resets:
                seen.append(sched.prefix_cache.n_pages)
        res = [s.result for s in sess]
        assert [r.token_ids for r in res] == [r.token_ids for r in base]
        o = _outcome(sched, res)
        _leak_free(ns, sched)
        return seen, o
    seen, (_, counters) = _both(run)
    assert counters["n_engine_resets"] == 1 and seen


def test_journal_admit_records_equal(engines, tmp_path):
    """A journaled warm run's admit records (rid, slot, cached pages,
    cached checker) equal ``repro``'s."""
    def run(ns):
        path = os.fspath(tmp_path / f"admit-{ns is T}.journal")
        engines[ns].generate_batch(
            _fork_requests(ns, seed=13), max_batch=3, page_size=8,
            prefix_cache=True, journal=ns.TokenJournal(path))
        return _admits(path)
    admits = _both(run)
    assert any(a["cached_pages"] > 0 for a in admits)


def test_stats_keys_match_reference(engines):
    def keys(ns):
        sched = ns.ContinuousBatchingScheduler(
            engines[ns], capacity=1, page_size=8, n_pages=32,
            prefix_cache=True)
        return sorted(k for k in sched.stats() if "prefix" in k
                      or k == "n_checker_clones")
    _both(keys)

