"""Device grammar tables and the fused decode loop of the port against
``repro``'s, on the same weights, tokenizer, grammar and prompts: the setup
of ``tests/test_device_loop.py`` (2 layers, d_model 64, the 257-token
byte-level BPE on which the JSON grammar certifies clean, ``max_len`` 256,
float32 on the CPU).

The merged ``DeviceTableSet`` must equal ``repro``'s array for array.  Each
scheduler scenario of the reference file runs in both packages with the
same seeded ``FaultInjector`` and supervisor: the all-certified batch, the
mixed batch, the downgraded certificate, NaN mid-block, a corrupted table
row, the ``table_corrupt`` injection, ``device_error`` mid-block, the
``device_timeout`` storm, cancel at a block boundary and verify rows that
stay packed.  Ids, statuses, errors, interventions, device tokens, the
scheduler's counters, the fault log, the supervisor's events and the
journal's ``demote`` records must be equal.  The deadline clamp reads the
wall clock, so the port passes the reference test's own assertions there.
The device sampler is checked in distribution (fixed seeds, TV distance to
the host ``select_token`` under 0.06 over 4000 draws)."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import base as jbase
from repro.core.analysis import analyze as j_analyze
from repro.core.domino import DominoDecoder as JDomino
from repro.core.sampling import GrammarSampler
from repro.models import build_model
from repro.serving.request import select_token
from repro.tokenizer import train_bpe
from repro_torch import serving as tserving
from repro_torch.configs import base as tbase
from repro_torch.core import bitmask
from repro_torch.core.analysis import OFF_FRONTIER
from repro_torch.core.analysis import analyze as t_analyze
from repro_torch.core.domino import DominoDecoder as TDomino
from repro_torch.kernels.masked_sample.ops import masked_sample_packed
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_from_numpy

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            dtype="float32", max_seq_len=512)
PROMPTS = ["a: ", "some much longer json prompt here: ", "x",
           "record -> "]


class _Framework(types.SimpleNamespace):
    __hash__ = object.__hash__      # a key of the engines fixture


# one namespace a framework, so a scenario is written once for both
J = _Framework(**{n: getattr(jserving, n) for n in jserving.__all__},
               Domino=JDomino, analyze=j_analyze)
T = _Framework(**{n: getattr(tserving, n) for n in tserving.__all__},
               Domino=TDomino, analyze=t_analyze)
ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = ("n_device_tokens", "n_host_syncs", "n_fwd",
            "n_quotient_escapes", "n_table_rejects", "n_deadline_clamps",
            "n_engine_resets", "n_preempt")


@pytest.fixture(scope="module")
def setup(json_grammar):
    """(tokenizer, JAX model and params, port model and params)."""
    corpus = GrammarSampler(json_grammar, seed=7).corpus(80)
    tok = train_bpe(corpus, vocab_size=257)

    def cfg(mod):
        return mod.ModelConfig(arch_id="dev-attn", family="dense",
                               vocab_size=tok.vocab_size, **BASE)
    m = build_model(cfg(jbase))
    params = m.init(jax.random.PRNGKey(0))
    tcfg = cfg(tbase)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return tok, m, params, t_build_model(tcfg), tparams


def _engine(ns, setup, grammar, max_tokens, **kw):
    tok, m, params, tm, tparams = setup
    if ns is J:
        return J.ServingEngine(m, params, tok, grammar,
                               jserving.EngineConfig(mode="domino",
                                                     max_tokens=max_tokens),
                               max_len=256, device_tables=True, **kw)
    return T.ServingEngine(tm, tparams, tok, grammar,
                           tserving.EngineConfig(mode="domino",
                                                 max_tokens=max_tokens),
                           max_len=256, device_tables=True, device="cpu",
                           **kw)


@pytest.fixture(scope="module")
def engines(setup, json_grammar):
    """{J: JAX engine, T: port engine}, each with "default" and "json"
    registered and device tables built."""
    out = {}
    for ns in (J, T):
        eng = _engine(ns, setup, json_grammar, 16)
        eng.register_grammar("json", json_grammar)
        stats = eng.precompute()
        assert stats.get("device_table_seconds", 0) > 0
        assert set(eng.device_tables) == {"default", "json"}
        out[ns] = eng
    # on the CPU ``jnp.asarray`` may alias a numpy array's memory (when the
    # buffer happens to be aligned), so the JAX package's device tables
    # can share memory with their host mirrors, which the corrupted-table
    # scenario flips; give them memory of their own, as the port's have
    jd = out[J].device_table_set
    jd.mask_dev = jax.numpy.asarray(jd.mask_host.copy())
    jd.trans_dev = jax.numpy.asarray(jd.trans_host.copy())
    return out


def test_device_table_set_equals_reference(engines):
    jd, td = engines[J].device_table_set, engines[T].device_table_set
    assert td.offsets == jd.offsets and td.n_states == jd.n_states
    assert td.n_bytes == jd.n_bytes
    np.testing.assert_array_equal(td.mask_host, np.asarray(jd.mask_host))
    np.testing.assert_array_equal(td.trans_host, np.asarray(jd.trans_host))
    np.testing.assert_array_equal(td.mask_dev.numpy().view(np.uint32),
                                  np.asarray(jd.mask_dev))
    np.testing.assert_array_equal(td.trans_dev.numpy(),
                                  np.asarray(jd.trans_dev))
    assert td.mask_dev.dtype == torch.int32
    for name in jd.offsets:
        jt, tt = jd.tables[name], td.tables[name]
        assert (tt.n_states, tt.v, tt.eos_id, tt.clamp) == \
            (jt.n_states, jt.v, jt.eos_id, jt.clamp)
        assert tt.key_to_sid == jt.key_to_sid


# -- scenarios: each returns (sessions, scheduler, injector, drive) ----------


def _sched(ns, eng, inj=None, sup=None, **kw):
    injector = None if inj is None else ns.FaultInjector(**inj)
    sched = ns.ContinuousBatchingScheduler(
        eng, fault_injector=injector,
        supervisor=None if sup is None else ns.DegradationSupervisor(**sup),
        **kw)
    return sched, injector


def _submit_run(ns, eng, prompts, inj=None, sup=None, **kw):
    sched, injector = _sched(ns, eng, inj, sup, **kw)
    sessions = [sched.submit(p) for p in prompts]
    return sessions, sched, injector, sched.run


def sc_all_certified(ns, eng, journal):
    return _submit_run(ns, eng, PROMPTS, capacity=2, device_loop=True,
                       sync_n=8, debug_invariants=True)


def sc_mixed_batch(ns, eng, journal):
    reqs = [
        ns.Request("a json: ", ns.ConstraintSpec(grammar="json",
                                                 mode="domino"),
                   ns.DecodeParams(max_tokens=10)),
        ns.Request("a json: ", ns.ConstraintSpec(grammar="json",
                                                 mode="online"),
                   ns.DecodeParams(max_tokens=8)),
        ns.Request('{"k": 1', ns.ConstraintSpec(grammar="json",
                                                mode="domino", heal=1),
                   ns.DecodeParams(max_tokens=8)),
        ns.Request("free text: ", ns.ConstraintSpec(),
                   ns.DecodeParams(max_tokens=6)),
    ]
    return _submit_run(ns, eng, reqs, capacity=3, device_loop=True)


def sc_nan_mid_block(ns, eng, journal):
    return _submit_run(ns, eng, PROMPTS[:2],
                       inj=dict(seed=0, rates={"decode_nan": 1.0},
                                targets={1}),
                       capacity=2, device_loop=True, sync_n=8,
                       debug_invariants=True)


def sc_corrupted_table_row(ns, eng, journal):
    """Bits flipped in every host-side audit mask row but the entry
    state's: rows enter the fused path (the device tables are untouched)
    and the first block-boundary audit demotes them."""
    sessions, sched, inj, run = _submit_run(
        ns, eng, PROMPTS[:2], capacity=2, device_loop=True, sync_n=4,
        debug_invariants=True, journal=journal)
    dts = sched._dts

    def drive():
        root = dts.sid_for("default", ns.Domino(
            eng.grammar, list(eng.tok.vocab), eng.tok.eos_id))
        assert root >= 0
        save = dts.mask_host.copy()
        dts.mask_host[np.arange(len(dts.mask_host)) != root] ^= \
            np.uint32(1)
        try:
            run()
        finally:
            dts.mask_host[:] = save
    return sessions, sched, inj, drive


def sc_table_corrupt_injection(ns, eng, journal):
    return _submit_run(ns, eng, PROMPTS[:2],
                       inj=dict(seed=0, rates={"table_corrupt": 1.0},
                                max_faults=2),
                       capacity=2, device_loop=True, sync_n=4,
                       debug_invariants=True, journal=journal)


def sc_device_error_mid_block(ns, eng, journal):
    return _submit_run(ns, eng, PROMPTS[:2],
                       inj=dict(seed=0, rates={"device_error": 1.0},
                                max_faults=1),
                       capacity=2, device_loop=True, sync_n=8,
                       debug_invariants=True)


def sc_device_timeout_storm(ns, eng, journal):
    return _submit_run(ns, eng, PROMPTS,
                       inj=dict(seed=1, rates={"device_timeout": 1.0},
                                max_faults=6),
                       sup=dict(max_retries=1, backoff_s=0.0,
                                recover_after=2),
                       capacity=2, device_loop=True, sync_n=4,
                       debug_invariants=True)


def sc_cancel_at_block_boundary(ns, eng, journal):
    """A cancel that lands while a block is in flight commits none of the
    block's tokens and ends the row at the next boundary."""
    sched, _ = _sched(ns, eng, capacity=1, device_loop=True, sync_n=4,
                      debug_invariants=True)
    s = sched.submit(ns.Request(
        PROMPTS[1], ns.ConstraintSpec(grammar="default", mode="domino"),
        ns.DecodeParams(max_tokens=64)))

    def drive():
        for _ in range(8):
            if s.n_device_tokens > 0 or s.result is not None:
                break
            sched.step()
        assert s.result is None and s.n_device_tokens > 0
        n_before = len(s.out_ids)
        s.cancel_requested = True
        sched._device_step()
        assert len(s.out_ids) == n_before and s.result is None
        sched.step()
        assert s.result.status == "cancelled"
        assert s.result.n_tokens == n_before
    return [s], sched, None, drive


def sc_verify_rows_stay_packed(ns, eng, journal):
    req = ns.Request("a: ", ns.ConstraintSpec(grammar="json",
                                              mode="domino"),
                     ns.DecodeParams(max_tokens=10, speculative=True,
                                     spec_s=3, spec_threshold=0.0))
    return _submit_run(ns, eng, [req], capacity=1, device_loop=True)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_all_certified, sc_mixed_batch, sc_nan_mid_block,
    sc_corrupted_table_row, sc_table_corrupt_injection,
    sc_device_error_mid_block, sc_device_timeout_storm,
    sc_cancel_at_block_boundary, sc_verify_rows_stay_packed)}


def _observe(ns, scenario, eng, tmp_path, monkeypatch):
    path = str(tmp_path / f"j-{'jax' if ns is J else 'torch'}")
    journal = ns.TokenJournal(path)
    sessions, sched, inj, drive = scenario(ns, eng, journal)
    if ns is T and scenario is sc_verify_rows_stay_packed:
        # greedy verification must never unpack a mask to bool
        def boom(*a, **k):
            raise AssertionError("bitmask.unpack on the verify path")
        monkeypatch.setattr(bitmask, "unpack", boom)
    drive()
    monkeypatch.undo()
    res = [s.result for s in sessions]
    return dict(
        ids=[r.token_ids for r in res], status=[r.status for r in res],
        errors=[r.error for r in res],
        interventions=[r.n_interventions for r in res],
        device_tokens=[r.n_device_tokens for r in res],
        counters={k: getattr(sched, k) for k in COUNTERS},
        log=None if inj is None else [(f.site, f.tick, f.rid)
                                      for f in inj.log],
        events=[(e.kind, e.level, e.what, e.error) for e in sched.sup.events],
        demotes=[r for r in ns.read_records(path) if r["kind"] == "demote"],
        drained=all(s is None for s in sched.slots) and (
            not sched.paged or sched.pool.available == sched.n_pages - 1),
    ), sched


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(engines, name, tmp_path, monkeypatch):
    scenario = SCENARIOS[name]
    ref, _ = _observe(J, scenario, engines[J], tmp_path, monkeypatch)
    got, sched = _observe(T, scenario, engines[T], tmp_path, monkeypatch)
    assert got == ref
    assert got["drained"]
    if name == "all_certified":
        # the fused block committed every token, one host sync a block
        n_tok = sum(len(i) for i in got["ids"])
        assert sched.n_device_tokens == n_tok > 0
        assert got["device_tokens"] == [len(i) for i in got["ids"]]
        assert sched.n_host_syncs / n_tok <= 1 / 8 + 0.1
        host, _ = _observe(T, lambda ns, eng, j: _submit_run(
            ns, eng, PROMPTS, capacity=2), engines[T], tmp_path,
            monkeypatch)
        assert host["ids"] == got["ids"] and host["status"] == got["status"]
    elif name in ("corrupted_table_row", "table_corrupt_injection"):
        assert got["counters"]["n_quotient_escapes"] >= 1
        assert got["demotes"]
    elif name == "device_timeout_storm":
        assert sched.sup.level == 0 and sched.sup.n_recovers >= 1
        assert got["counters"]["n_device_tokens"] > 0


def test_downgraded_certificate_never_enters_device(setup, json_grammar):
    """A stored report with a mask conflict keeps its grammar off the device
    path in both packages, and a device-loop run commits no device token."""
    tok = setup[0]
    got = {}
    for ns in (J, T):
        eng = _engine(ns, setup, json_grammar, 10)
        rep = ns.analyze(json_grammar, list(tok.vocab), tok.eos_id,
                         name="default")
        eng.analysis_reports["default"] = dataclasses.replace(
            rep, n_mask_conflicts=1)
        eng.precompute()
        assert "default" not in eng.device_tables
        assert eng.device_table_set is None
        sessions, sched, _, run = _submit_run(
            ns, eng, PROMPTS[:2], capacity=2, device_loop=True, sync_n=8,
            debug_invariants=True)
        run()
        assert sched.n_device_tokens == 0
        assert all(int(s) == OFF_FRONTIER for s in sched._dev_state)
        got[ns] = ([s.result.token_ids for s in sessions],
                   {k: getattr(sched, k) for k in COUNTERS})
    assert got[T] == got[J]


def test_deadline_clamp_bounds_fused_block(engines):
    """The reference test's own assertions (the clamp reads the wall
    clock): a resident with about 10 ms of deadline left gets a block of
    fewer than sync_n steps, at least one."""
    eng = engines[T]
    sched = T.ContinuousBatchingScheduler(eng, capacity=1, device_loop=True,
                                          sync_n=8, debug_invariants=True)
    s = sched.submit(T.Request(
        PROMPTS[1], T.ConstraintSpec(grammar="default", mode="domino"),
        T.DecodeParams(max_tokens=64, deadline_s=30.0)))
    for _ in range(8):
        if sched._tok_s_ema > 0.0 or s.result is not None:
            break
        sched.step()
    assert s.result is None and sched._tok_s_ema > 0.0
    assert sched.n_deadline_clamps == 0
    s.t_submit = time.perf_counter() - (30.0 - 0.01)
    sched.step()
    assert sched.n_deadline_clamps >= 1
    assert 1 <= sched._last_block_steps < 8
    sched.run()
    assert s.result.status == "deadline_exceeded"
    assert all(x is None for x in sched.slots)
    assert sched.pool.available == sched.n_pages - 1


def test_device_sampler_matches_host_distribution():
    """Gumbel-max over the packed legal set against the host
    ``select_token`` (in distribution: the streams differ by design), and
    temperature 0 giving the masked argmax."""
    rng = np.random.default_rng(0)
    v = 70
    logits = rng.normal(size=v).astype(np.float32) * 2.0
    legal = np.zeros(v, bool)
    legal[rng.choice(v, size=9, replace=False)] = True
    bits = bitmask.pack_bool(legal).view(np.int32)
    temp, n = 0.8, 4000
    keys = torch.tensor(np.stack([np.full(n, 5), np.arange(n)], axis=1))
    dev = masked_sample_packed(
        torch.tensor(np.tile(logits, (n, 1))),
        torch.tensor(np.tile(bits, (n, 1))),
        torch.full((n,), temp), keys).numpy()
    assert legal[dev].all(), "the device sampler drew an illegal token"
    host_rng = np.random.default_rng(5)
    host = np.asarray([select_token(logits, legal, temp, host_rng)
                       for _ in range(n)])
    dev_freq = np.bincount(dev, minlength=v)[legal] / n
    host_freq = np.bincount(host, minlength=v)[legal] / n
    tv = 0.5 * np.abs(dev_freq - host_freq).sum()
    assert tv < 0.06, f"TV distance {tv:.3f} between the samplers"
    # a draw is a pure function of (seed, draw index): rows do not interact
    again = masked_sample_packed(
        torch.tensor(np.tile(logits, (3, 1))),
        torch.tensor(np.tile(bits, (3, 1))),
        torch.full((3,), temp), keys[[7, 3, 7]]).numpy()
    assert list(again) == [dev[7], dev[3], dev[7]]
    greedy = masked_sample_packed(torch.tensor(logits[None]),
                                  torch.tensor(bits[None]),
                                  torch.zeros(1), keys[:1]).numpy()
    assert int(greedy[0]) == int(np.where(legal, logits, -np.inf).argmax())


def test_device_sampler_rows_independent_of_batch(engines, json_grammar):
    """Sampled rows on the device-loop scheduler draw from the device
    sampler: each output stays in its grammar, and a row's tokens depend
    on its seed and draw count only, not on the rows beside it."""
    eng = engines[T]

    def req(i, temp):
        return T.Request(PROMPTS[i], T.ConstraintSpec(grammar="json",
                                                      mode="domino"),
                         T.DecodeParams(max_tokens=12, temperature=temp,
                                        seed=3 + i))
    alone, sched, _, run = _submit_run(T, eng, [req(0, 0.8)], capacity=1,
                                       device_loop=True)
    run()
    mixed, _, _, run = _submit_run(
        T, eng, [req(1, 0.0), req(0, 0.8), req(2, 1.3)], capacity=3,
        device_loop=True)
    run()
    got = alone[0].result
    assert got.status in ("ok", "dead_end") and got.n_tokens > 0
    assert mixed[1].result.token_ids == got.token_ids
    assert alone[0].n_draws == got.n_tokens + int(got.finished)
    for s in alone + mixed:
        d = TDomino(json_grammar, list(eng.tok.vocab), eng.tok.eos_id)
        assert all(d.advance(t) for t in s.result.token_ids)


def _serve(*args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--prompts", "4", "--slots", "2", "--max-tokens", "16", "--dtype",
         "float32", "--print-ids", *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_serve_cli_device_loop_ids_equal_host_loop():
    """The port's serve CLI with ``--device-loop``: the JSON grammar
    certifies against its tokenizer, rows commit tokens in fused blocks,
    and the ``IDS`` lines equal the host loop's.  (The JAX package's CLI
    draws other random weights, so its ids are not comparable; the tests
    above hold the two packages' ids equal on shared weights.)"""
    host, fused = _serve(), _serve("--device-loop", "--sync-n", "4")
    assert "[device-table] json:" in fused
    assert "device-committed" in fused
    assert sum(int(x) for x in re.findall(r"(\d+) device-committed",
                                          fused)) > 0
    ids = [ln for ln in host.splitlines() if ln.startswith("IDS ")]
    assert len(ids) == 4
    assert [ln for ln in fused.splitlines() if ln.startswith("IDS ")] == ids
