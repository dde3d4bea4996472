"""Durability through the port's scheduler and engine against ``repro``'s,
on the same weights, tokenizer, grammar and prompts: a journaled run's
replayed journal (prompt, spec, committed tokens, draws, RNG state,
preemptions, terminal status) equal to the reference's; a crash (a
``crash_hook`` that raises after the K-th fsync, leaving the file as a
kill would) then ``ServingEngine.restore`` giving ids bitwise equal to an
uninterrupted run, in both frameworks, with equal replayed-token counts;
the sampled RNG stream resumed; repeated crash/restore cycles converging;
an unrecoverable request reported, not resurrected; and the serve CLI's
SIGKILL drill (``--journal``/``--crash-after-syncs``/``--restore``) on the
CPU.  2 layers, d_model 64, float32 on the CPU."""
import dataclasses
import os
import pathlib
import re
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig
from repro.models import build_model
from repro.serving import (ConstraintSpec, ContinuousBatchingScheduler,
                           DecodeParams, EngineConfig, Request,
                           ServingEngine, TokenJournal, replay_journal)
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ConstraintSpec as TConstraintSpec
from repro_torch.serving import \
    ContinuousBatchingScheduler as TContinuousBatchingScheduler
from repro_torch.serving import DecodeParams as TDecodeParams
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TServingEngine
from repro_torch.serving import TokenJournal as TTokenJournal
from repro_torch.serving import replay_journal as t_replay_journal

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            dtype="float32", max_seq_len=512)
PROMPTS = ["a: ", "some much longer json prompt here: ", "x"]
# (scheduler, journal, replay, request factory) a framework
JAX = (ContinuousBatchingScheduler, TokenJournal, replay_journal,
       (Request, ConstraintSpec, DecodeParams))
PORT = (TContinuousBatchingScheduler, TTokenJournal, t_replay_journal,
        (TRequest, TConstraintSpec, TDecodeParams))


class Boom(Exception):
    """Raised by the crash hook in place of SIGKILL: the file is left as a
    kill after that fsync would leave it."""


def _boom():
    raise Boom()


@pytest.fixture(scope="module")
def engines(small_tokenizer, json_grammar):
    """``engines(max_tokens)`` -> a (JAX, port) pair of fresh engines on one
    set of weights."""
    tok = small_tokenizer
    cfg = dict(arch_id="tj-attn", family="dense",
               vocab_size=tok.vocab_size, **BASE)
    m = build_model(ModelConfig(**cfg))
    params = m.init(jax.random.PRNGKey(0))
    tcfg = TModelConfig(**cfg)
    tm = t_build_model(tcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    steps = {}

    def make(max_tokens=12):
        eng = ServingEngine(m, params, tok, json_grammar,
                            EngineConfig(mode="domino",
                                         max_tokens=max_tokens),
                            max_len=256)
        eng._prefill, eng._decode = steps.setdefault(
            0, (eng._prefill, eng._decode))
        teng = TServingEngine(tm, tparams, tok, json_grammar,
                              TEngineConfig(mode="domino",
                                            max_tokens=max_tokens),
                              max_len=256, device="cpu")
        return ((eng,) + JAX, (teng,) + PORT)
    return make


def _entries(replay, path):
    return {rid: dataclasses.asdict(e) for rid, e in replay(path).items()}


def _crash(fw, path, reqs, crash_after, capacity=2):
    """Run ``reqs`` journaled until the crash hook fires after the
    ``crash_after``-th fsync."""
    eng, sched_cls, journal_cls = fw[:3]
    j = journal_cls(path, crash_after_syncs=crash_after, crash_hook=_boom)
    sched = sched_cls(eng, capacity=capacity, journal=j)
    for r in reqs:
        sched.submit(r)
    with pytest.raises(Boom):
        sched.run()
    j.dead = True                      # the process is gone


def test_journaled_run_replays_equal_and_restores_shells(engines,
                                                         tmp_path):
    out = []
    for i, fw in enumerate(engines()):
        eng, _, journal_cls, replay, _ = fw
        path = str(tmp_path / f"j{i}")
        baseline = eng.generate_batch(list(PROMPTS), max_batch=2)
        results = eng.generate_batch(list(PROMPTS), max_batch=2,
                                     journal=journal_cls(path))
        assert [r.token_ids for r in results] == \
            [b.token_ids for b in baseline]
        entries = _entries(replay, path)
        assert all(e["terminal"] is not None for e in entries.values())
        shells = eng.restore(path, debug_invariants=True).run()
        assert [r.token_ids for r in shells] == \
            [r.token_ids for r in results]
        assert all(r.n_forward_passes == 0 for r in shells)
        out.append((entries, [r.token_ids for r in results]))
    assert out[1] == out[0]


@pytest.mark.parametrize("crash_after", [1, 4])
def test_crash_and_restore_bitwise(engines, tmp_path, crash_after):
    out = []
    for i, fw in enumerate(engines()):
        eng, _, _, replay, _ = fw
        path = str(tmp_path / f"j{i}")
        baseline = eng.generate_batch(list(PROMPTS), max_batch=2)
        _crash(fw, path, PROMPTS, crash_after)
        entries = _entries(replay, path)
        sched = eng.restore(path, debug_invariants=True)
        restored = sched.run()
        assert [r.token_ids for r in restored] == \
            [b.token_ids for b in baseline]
        assert [r.status for r in restored] == [b.status for b in baseline]
        n_rep = sum(r.n_replayed_tokens for r in restored)
        assert n_rep == sched.n_replayed_tokens
        assert all(s is None for s in sched.slots)
        assert sched.pool.available == sched.n_pages - 1
        out.append((entries, [r.token_ids for r in restored], n_rep,
                    sched.n_preempt))
    assert out[1] == out[0]
    if crash_after > 1:
        assert out[1][2] > 0


def test_crash_restore_resumes_sampled_rng_stream(engines, tmp_path):
    out = []
    for i, fw in enumerate(engines()):
        eng, _, _, replay, (req, spec, dec) = fw
        reqs = [req(p, spec(grammar="default", mode="domino"),
                    dec(temperature=0.8, seed=11 + k, max_tokens=12))
                for k, p in enumerate(PROMPTS)]
        path = str(tmp_path / f"j{i}")
        baseline = eng.generate_batch(list(reqs), max_batch=2)
        _crash(fw, path, reqs, 4)
        entries = _entries(replay, path)
        restored = eng.restore(path, debug_invariants=True).run()
        assert [r.token_ids for r in restored] == \
            [b.token_ids for b in baseline]
        out.append((entries, [r.token_ids for r in restored]))
    assert out[1] == out[0]
    assert any(e["rng_state"] is not None for e in out[1][0].values())


def test_repeated_crash_restore_cycles_converge(engines, tmp_path):
    out = []
    for i, fw in enumerate(engines()):
        eng, _, journal_cls, replay, _ = fw
        path = str(tmp_path / f"j{i}")
        baseline = eng.generate_batch(list(PROMPTS), max_batch=2)
        _crash(fw, path, PROMPTS, 2)
        j2 = journal_cls(path, crash_after_syncs=3, crash_hook=_boom)
        sched2 = eng.restore(path, journal=j2)
        with pytest.raises(Boom):
            sched2.run()
        j2.dead = True
        final = eng.restore(path, journal=journal_cls(path),
                            debug_invariants=True).run()
        assert [r.token_ids for r in final] == \
            [b.token_ids for b in baseline]
        entries = _entries(replay, path)
        assert all(e["terminal"] is not None for e in entries.values())
        out.append(entries)
    assert out[1] == out[0]


def test_unrecoverable_request_reported_not_resurrected(engines, tmp_path,
                                                        json_grammar):
    out = []
    for i, fw in enumerate(engines()):
        eng, _, _, replay, (req, spec, dec) = fw
        good = req("a: ", spec(grammar="default", mode="domino"),
                   dec(max_tokens=12))
        adhoc = req("x", spec(grammar=json_grammar, mode="domino"),
                    dec(max_tokens=12))
        baseline = eng.generate_batch([good], max_batch=1)
        path = str(tmp_path / f"j{i}")
        _crash(fw, path, [good, adhoc], 3)
        entries = replay(path)
        assert entries[0].recoverable and not entries[1].recoverable
        res = eng.restore(path).run()
        assert res[0].token_ids == baseline[0].token_ids
        assert res[1].status == "internal_error"
        assert "not serializable" in res[1].error
        out.append([(r.status, r.token_ids) for r in res])
    assert out[1] == out[0]


def _serve(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--prompts", "4", "--slots", "2", "--max-tokens", "16", *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)


def _ids(out):
    return [ln for ln in out.splitlines() if ln.startswith("IDS ")]


@pytest.mark.parametrize("extra", [
    [], ["--prompts", "5", "--page-size", "8", "--prefix-cache"]],
    ids=["plain", "prefix-cache"])
def test_serve_cli_sigkill_drill(tmp_path, extra):
    """The restart drill through the port's CLI: a reference run, a
    journaled run killed by SIGKILL after its 2nd fsync, and a restore
    whose ``IDS`` lines equal the reference run's; the second case serves
    through the prefix cache (a repeated prompt and 8-token pages make
    whole-page hits certain), as the reference's restart drill does."""
    ref = _serve("--print-ids", *extra)
    assert ref.returncode == 0, ref.stderr
    path = str(tmp_path / "j")
    crash = _serve("--journal", path, "--crash-after-syncs", "2", *extra)
    assert crash.returncode == -signal.SIGKILL, crash.stderr
    rest = _serve("--journal", path, "--restore", "--print-ids", *extra)
    assert rest.returncode == 0, rest.stderr
    assert _ids(rest.stdout) == _ids(ref.stdout) and _ids(ref.stdout)
    assert "resumed live" in rest.stdout
    if extra:
        hits = re.search(r"\[prefix cache: (\d+) hits", ref.stdout)
        assert hits and int(hits.group(1)) > 0
