"""Constrained serving engine of the port: DOMINO as a first-class feature,
mirroring ``repro.serving.engine`` on PyTorch.

The unit of work is a :class:`~repro_torch.serving.request.Request`:
``prompt + ConstraintSpec + DecodeParams``.  The engine owns a grammar
registry -- one shared ``TreeCache`` per registered grammar, warmed by
``precompute()`` (paper Algorithm 2) -- and no per-request policy:

    engine = ServingEngine(model, params, tok, device="cuda")
    engine.register_grammar("json", json_grammar)
    engine.precompute()
    r = engine.generate(Request("a config: ",
                                ConstraintSpec(grammar="json", mode="domino"),
                                DecodeParams(max_tokens=64)))

``generate`` serves one request on a dense B=1 cache; ``generate_batch``
serves many through the continuous-batching scheduler, over a paged KV pool
where every block is full attention and over dense rows otherwise (the
recurrent state of Mamba1/Mamba2 blocks, zamba2's shared-attention K/V).
The model runs eagerly (the JAX package jits ``prefill``/``decode_step``).
The legacy surface -- ``ServingEngine(model, params, tok, grammar,
EngineConfig(...))`` plus bare-string prompts -- works as in the JAX package.

Speculative decoding (paper section 3.6, ``DecodeParams.speculative``)
proposes chains from ONE engine-wide count model and verifies each chain
with one forward over the window: full-attention caches roll back by
rewinding ``len``; recurrent caches (Mamba1/Mamba2) are refed from a copy
of their state taken before the verify forward, because the port's caches
are written in place.

``generate_batch`` takes the reference's failure and durability knobs
(deadlines, the queue limit and timeout, a ``FaultInjector``, the
invariant audit, a ``TokenJournal``, a ``DegradationSupervisor``), and
``restore`` resumes a crashed run from its journal.

Device grammar tables: ``ServingEngine(..., device_tables=True)`` makes
``precompute()`` build a ``DeviceGrammarTable`` for every grammar whose
closure certificate is clean and upload them all as one
``DeviceTableSet``; ``generate_batch(..., device_loop=True, sync_n=8)``
then decodes certified greedy rows ``sync_n`` steps a host sync through
the scheduler's fused block (one CUDA graph replay a block on the card).

The prefix cache: ``generate_batch(..., prefix_cache=True)`` and
``restore(..., prefix_cache=True)`` (paged only) share whole KV pages
across requests with equal token prefixes through the scheduler's radix
tree, so an admission prefills only its private tail; ``pin_prompt``
registers a shared preamble that such a scheduler prefills once and pins.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bitmask
from repro_torch.core.analysis import (OFF_FRONTIER, AnalysisReport,
                                       DeviceGrammarTable, analyze, enforce)
from repro_torch.core.baselines import TemplateSession
from repro_torch.core.grammar import Grammar
from repro_torch.core.scanner import Scanner
from repro_torch.core.speculation import CountModel, Speculator
from repro_torch.core.trees import TreeCache
from repro_torch.device import resolve_device
from repro_torch.models import kvcache
from repro_torch.models.convert import tree_items
from repro_torch.models.model import Model
from repro_torch.serving.request import (ConstraintSpec, DecodeParams,
                                         Request, packed_argmax,
                                         select_token)
from repro_torch.serving.session import GenerationResult
from repro_torch.tokenizer import BPETokenizer

DEFAULT_GRAMMAR = "default"


@dataclasses.dataclass
class EngineConfig:
    """Legacy engine-wide configuration: split into the engine's default
    ``ConstraintSpec`` + ``DecodeParams``, applied only to requests
    submitted as bare strings."""
    mode: str = "domino"              # unconstrained|domino|naive|online
    k: Optional[int] = None           # DOMINO lookahead (None = inf)
    opportunistic: bool = False
    speculative: bool = False
    spec_s: int = 8
    spec_threshold: float = 0.5
    temperature: float = 0.0          # 0 = greedy
    max_tokens: int = 128
    seed: int = 0
    heal: int = 0                     # token healing (paper section 3.5)

    def constraint_spec(self, grammar_ref) -> ConstraintSpec:
        return ConstraintSpec(grammar=grammar_ref, mode=self.mode,
                              k=self.k, opportunistic=self.opportunistic,
                              heal=self.heal)

    def decode_params(self) -> DecodeParams:
        return DecodeParams(temperature=self.temperature,
                            max_tokens=self.max_tokens, seed=self.seed,
                            speculative=self.speculative,
                            spec_s=self.spec_s,
                            spec_threshold=self.spec_threshold)


@dataclasses.dataclass
class _RowPolicy:
    """Selection policy for the single-request path (the scheduler passes
    the Session itself, which exposes the same fields)."""
    temperature: float
    opportunistic: bool
    decode: DecodeParams
    _rng: Optional[np.random.Generator] = None

    @property
    def rng(self) -> np.random.Generator:
        if self._rng is None:
            self._rng = self.decode.make_rng()
        return self._rng


class DeviceTableSet:
    """Every certified grammar's :class:`DeviceGrammarTable` merged into
    one pair of device tensors, so the scheduler's fused block gathers any
    row's mask with one index, whatever grammar the row decodes under:

      ``mask_dev``  -- ``(total_states, ceil(V/32))`` int32 packed masks
                       (the ``uint32`` words of the tables, bit for bit)
      ``trans_dev`` -- ``(total_states, V)`` int32 token -> next state

    Per-grammar state ids are offset into the concatenated range
    (``offsets[name]``); ``OFF_FRONTIER`` (negative) edges stay negative,
    so a state id ``< 0`` always means "host path".  The numpy mirrors
    ``mask_host`` (``uint32``) and ``trans_host`` serve the scheduler's
    per-token bookkeeping without device readbacks.  Built once by
    :meth:`ServingEngine.build_device_tables`; immutable afterwards."""

    def __init__(self, tables: Dict[str, DeviceGrammarTable], device):
        names = sorted(tables)
        self.tables = {n: tables[n] for n in names}
        self.offsets: Dict[str, int] = {}
        masks, trans = [], []
        off = 0
        for n in names:
            t = tables[n]
            self.offsets[n] = off
            masks.append(t.mask_table)
            tr = t.trans.astype(np.int32, copy=True)
            tr[tr >= 0] += off          # remap edges into the concat range
            trans.append(tr)
            off += t.n_states
        self.n_states = off
        self.mask_host = np.concatenate(masks, axis=0)
        self.trans_host = np.concatenate(trans, axis=0)
        # copies: the device tables never alias the host mirrors
        self.mask_dev = torch.tensor(self.mask_host.view(np.int32),
                                     device=device)
        self.trans_dev = torch.tensor(self.trans_host, device=device)

    @property
    def n_bytes(self) -> int:
        return int(self.mask_host.nbytes + self.trans_host.nbytes)

    def sid_for(self, name: str, checker) -> int:
        """Global state id of ``checker``'s current state under grammar
        ``name``, or ``OFF_FRONTIER`` when the grammar has no table or the
        state is outside the certified frontier."""
        off = self.offsets.get(name)
        if off is None:
            return OFF_FRONTIER
        sid = self.tables[name].sid_for(checker)
        return sid + off if sid >= 0 else OFF_FRONTIER


class ServingEngine:
    def __init__(self, model: Model, params, tok: BPETokenizer,
                 grammar: Optional[Grammar] = None,
                 cfg: Optional[EngineConfig] = None,
                 tree_cache: Optional[TreeCache] = None,
                 count_model: Optional[CountModel] = None,
                 max_len: int = 1024,
                 analysis_policy: str = "off",
                 max_adhoc_grammars: int = 32,
                 device_tables: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        if any(p.requires_grad for _, p in tree_items(params)):
            raise ValueError(
                "ServingEngine: params require grad, and serving must not "
                "record an autograd graph (the kernels have no backward); "
                "pass detached params, e.g. tree_map(lambda p: p.detach(), "
                "params), as repro_torch.training.train_loop.train returns")
        self.model = model
        self.params = params
        self.tok = tok
        self.grammar = grammar
        self.cfg = cfg or EngineConfig()
        self.max_len = max_len
        # registration-time static analysis: off | warn | strict
        self.analysis_policy = analysis_policy
        self.analysis_reports: Dict[str, AnalysisReport] = {}
        # device grammar tables: precompute() builds and uploads one for
        # every grammar whose certificate is clean; the others stay on the
        # host path (correctness never depends on certification, only the
        # host syncs a token do)
        self.enable_device_tables = device_tables
        self.device_tables: Dict[str, DeviceGrammarTable] = {}
        self._device_table_set: Optional[DeviceTableSet] = None
        self._grammar_refs: Dict[str, int] = {}
        self._adhoc_order: List[str] = []
        self.max_adhoc_grammars = max_adhoc_grammars
        # grammar registry: name -> (Grammar, shared TreeCache or None when
        # registered lazily because the default mode consults no trees)
        self.registry: Dict[str, Tuple[Grammar, Optional[TreeCache]]] = {}
        constrained_default = self.cfg.mode in ("domino", "naive", "online")
        if grammar is not None:
            if constrained_default:
                self.register_grammar(DEFAULT_GRAMMAR, grammar,
                                      tree_cache=tree_cache)
            else:
                self.registry[DEFAULT_GRAMMAR] = (grammar, None)
        self.default_constraint = self.cfg.constraint_spec(
            DEFAULT_GRAMMAR if grammar is not None else None)
        self.default_decode = self.cfg.decode_params()
        self.tree_cache = (self.registry[DEFAULT_GRAMMAR][1]
                           if grammar is not None and constrained_default
                           else None)
        # speculation: ONE count model engine-wide (priors transfer across
        # requests); Speculators pooled per (s, threshold) share the
        # proposal-chain memo
        self.count_model = count_model or CountModel()
        self._speculators: Dict[Tuple[int, float], Speculator] = {}
        self.speculator = self._speculator_for(self.default_decode)
        # engine-default prompts (system preambles, few-shot headers)
        # registered by pin_prompt(): a prefix-cache scheduler prefills and
        # pins their full pages, so the first request sharing one hits
        self.pinned_prompts: List[str] = []
        # engine-level rng for the legacy default policy
        self.rng = np.random.default_rng(self.cfg.seed)
        self._v = tok.vocab_size   # model logits may be vocab-padded
        # eager steps (the JAX package jits these two)
        self._prefill = self.model.prefill
        self._decode = self.model.decode_step
        head, _, group, tail = self.model.cfg.layer_program
        self._needs_refeed = any(
            b in ("mamba1", "mamba2", "swa")
            for b in list(head) + list(group) + list(tail))
        # operational counters of the last generate_batch's scheduler
        self.last_batch_stats: Dict[str, object] = {}

    # -- grammar registry --------------------------------------------------------

    def register_grammar(self, name: str, grammar: Grammar,
                         tree_cache: Optional[TreeCache] = None,
                         policy: Optional[str] = None) -> TreeCache:
        """Register ``grammar`` under ``name`` with ONE shared TreeCache;
        under a ``warn``/``strict`` analysis policy the grammar is analyzed
        first (strict failures register nothing).  Re-registering the same
        grammar object bumps its refcount.  Returns the cache."""
        prev = self.registry.get(name)
        if prev is not None and prev[0] is grammar and prev[1] is not None:
            self._grammar_refs[name] = self._grammar_refs.get(name, 0) + 1
            return prev[1]
        tc = tree_cache if tree_cache is not None else TreeCache(
            Scanner(grammar), list(self.tok.vocab))
        pol = policy if policy is not None else self.analysis_policy
        if pol != "off":
            report = analyze(grammar, list(self.tok.vocab),
                             self.tok.eos_id, name=name, tree_cache=tc)
            enforce(report, pol)
            self.analysis_reports[name] = report
        self.registry[name] = (grammar, tc)
        self._grammar_refs[name] = self._grammar_refs.get(name, 0) + 1
        return tc

    def unregister_grammar(self, name: str) -> bool:
        """Drop one reference to ``name``; at zero the entry (grammar,
        TreeCache, mask memo, analysis report) is released.  Returns True
        when the entry was fully removed."""
        if name not in self.registry:
            raise KeyError(f"grammar {name!r} is not registered")
        n = self._grammar_refs.get(name, 1) - 1
        if n > 0:
            self._grammar_refs[name] = n
            return False
        self.registry.pop(name, None)
        self._grammar_refs.pop(name, None)
        self.analysis_reports.pop(name, None)
        if name in self._adhoc_order:
            self._adhoc_order.remove(name)
        if self.tree_cache is not None and name == DEFAULT_GRAMMAR:
            self.tree_cache = None
        return True

    def resolve_grammar(self, ref) -> Tuple[Optional[Grammar],
                                            Optional[TreeCache]]:
        """A registered name, a Grammar object (auto-registered by
        identity in a bounded LRU) or None -> (grammar, shared
        TreeCache)."""
        if ref is None:
            return None, None
        if isinstance(ref, str):
            entry = self.registry.get(ref)
            if entry is None:
                raise KeyError(
                    f"grammar {ref!r} is not registered (have: "
                    f"{sorted(self.registry)}); call "
                    f"engine.register_grammar({ref!r}, grammar) first")
            if entry[1] is None:       # lazily registered: build now
                self._grammar_refs.pop(ref, None)
                return entry[0], self.register_grammar(ref, entry[0])
            return entry
        for name, (g, tc) in self.registry.items():
            if g is ref:
                if tc is None:
                    self._grammar_refs.pop(name, None)
                    return g, self.register_grammar(name, g)
                if name in self._adhoc_order:      # LRU touch
                    self._adhoc_order.remove(name)
                    self._adhoc_order.append(name)
                return g, tc
        name = f"grammar@{id(ref):x}"
        self.register_grammar(name, ref)
        self._adhoc_order.append(name)
        while len(self._adhoc_order) > self.max_adhoc_grammars:
            victim = next((n for n in self._adhoc_order
                           if self._grammar_refs.get(n, 1) <= 1), None)
            if victim is None:
                break
            self._adhoc_order.remove(victim)
            self.registry.pop(victim, None)
            self._grammar_refs.pop(victim, None)
            self.analysis_reports.pop(victim, None)
        return self.registry[name]

    def analyze_grammar(self, name: str, policy: Optional[str] = None,
                        **kwargs) -> AnalysisReport:
        """(Re-)run static analysis of a registered grammar against the
        engine's vocabulary on the registry's shared TreeCache; ``kwargs``
        pass through to :func:`repro_torch.core.analysis.analyze`.  The
        report is stored and the policy enforced."""
        grammar, tc = self.resolve_grammar(name)
        report = analyze(grammar, list(self.tok.vocab), self.tok.eos_id,
                         name=name, tree_cache=tc, **kwargs)
        self.analysis_reports[name] = report
        enforce(report, policy if policy is not None
                else self.analysis_policy)
        return report

    def precompute(self) -> Dict[str, float]:
        """Offline warm path: build every reachable subterminal tree of
        every registered grammar now, so serving never builds trees on the
        critical path."""
        out = {"positions": 0.0, "seconds": 0.0, "analysis_seconds": 0.0}
        for name, (grammar, tc) in list(self.registry.items()):
            if tc is None:
                continue
            if self.analysis_policy != "off" \
                    and name not in self.analysis_reports:
                report = analyze(grammar, list(self.tok.vocab),
                                 self.tok.eos_id, name=name, tree_cache=tc)
                self.analysis_reports[name] = report
                out["analysis_seconds"] += report.analysis_time_s
                enforce(report, self.analysis_policy)
            stats = tc.precompute()
            out["positions"] += stats["positions"]
            out["seconds"] += stats["seconds"]
        if self.enable_device_tables:
            out["device_table_seconds"] = self.build_device_tables()
        return out

    def pin_prompt(self, prompt: str) -> None:
        """Register an engine-default prompt (a shared system preamble or
        few-shot header) for pinning: a prefix-cache scheduler's ``warm()``
        prefills its whole-page prefix once and pins the pages against
        eviction.  Schedulers without ``prefix_cache=True`` ignore it."""
        if prompt not in self.pinned_prompts:
            self.pinned_prompts.append(prompt)

    def build_device_tables(self) -> float:
        """Build a :class:`DeviceGrammarTable` for every registered grammar
        whose closure certificate is clean (finite, no merge conflicts, no
        hypothesis truncations, an ``ok()`` report); dirty grammars stay
        host-only.  A grammar with a stored report is judged by it and
        never re-analysed behind its back, so a downgraded certificate
        keeps the grammar off the device path; a grammar without one is
        analysed here with ``emit_device_table=True`` on its shared
        TreeCache.  Returns the seconds spent analysing."""
        spent = 0.0
        for name, (grammar, tc) in list(self.registry.items()):
            if tc is None or name in self.device_tables:
                continue
            report = self.analysis_reports.get(name)
            if report is None:
                report = analyze(grammar, list(self.tok.vocab),
                                 self.tok.eos_id, name=name,
                                 tree_cache=tc, emit_device_table=True)
                self.analysis_reports[name] = report
                spent += report.analysis_time_s
            elif report.device_table is None:
                # a stored report's certificate stands: dirty -> skip
                # without re-analysis; clean but analysed without the
                # table -> analyse again with it
                if (not report.closure.finite or report.n_mask_conflicts
                        or report.n_hyp_truncations or not report.ok()):
                    continue
                report = analyze(grammar, list(self.tok.vocab),
                                 self.tok.eos_id, name=name,
                                 tree_cache=tc, emit_device_table=True)
                self.analysis_reports[name] = report
                spent += report.analysis_time_s
            if report.device_table is not None and report.ok():
                self.device_tables[name] = report.device_table
                tc.device_table = report.device_table
                self._device_table_set = None      # rebuilt lazily
        return spent

    @property
    def device_table_set(self) -> Optional[DeviceTableSet]:
        """The merged upload of every certified grammar (None until
        :meth:`build_device_tables` has certified one)."""
        if self._device_table_set is None and self.device_tables:
            self._device_table_set = DeviceTableSet(self.device_tables,
                                                    self.device)
        return self._device_table_set

    # -- request / checker factory -----------------------------------------------

    def make_request(self, prompt: str,
                     constraint: Optional[ConstraintSpec] = None,
                     decode: Optional[DecodeParams] = None,
                     extra_inputs: Optional[Dict[str, Any]] = None
                     ) -> Request:
        """Default-``Request`` factory (the legacy engine defaults)."""
        return Request(prompt=prompt,
                       constraint=constraint or self.default_constraint,
                       decode=decode or self.default_decode,
                       extra_inputs=extra_inputs)

    def _coerce(self, request: Union[str, Request]) -> Request:
        return (self.make_request(request) if isinstance(request, str)
                else request)

    def _eos_for(self, spec: ConstraintSpec) -> int:
        return spec.eos_id if spec.eos_id is not None else self.tok.eos_id

    def _checker_from_spec(self, spec: ConstraintSpec,
                           heal_prefix: str = ""):
        grammar = tc = None
        if spec.grammar is not None and spec.mode != "unconstrained":
            grammar, tc = self.resolve_grammar(spec.grammar)
        return spec.make_checker(grammar, list(self.tok.vocab),
                                 self._eos_for(spec), tree_cache=tc,
                                 heal_prefix=heal_prefix)

    def _make_checker(self, heal_prefix: str = ""):
        """Checker factory for the engine-DEFAULT constraint."""
        return self._checker_from_spec(self.default_constraint,
                                       heal_prefix)

    def _prep(self, req: Request):
        """Shared request preamble: encode, apply token healing, build the
        checker.  ``generate`` and the scheduler's ``submit`` both go
        through here so their outputs stay token-for-token identical."""
        spec = req.constraint
        prompt_ids = self.tok.encode(req.prompt) or [self.tok.bos_id]
        prompt_ids, heal_prefix = spec.prep_prompt(prompt_ids,
                                                   self.tok.vocab)
        if spec is self.default_constraint:
            checker = self._make_checker(heal_prefix)
        else:
            checker = self._checker_from_spec(spec, heal_prefix)
        return prompt_ids, checker

    def make_session(self, rid: int, request: Union[str, Request],
                     extra_inputs=None):
        """A scheduler Session carrying the request's per-row policy."""
        from repro_torch.serving.session import Session
        req = self._coerce(request)
        prompt_ids, checker = self._prep(req)
        dp = req.decode
        merged = dict(req.extra_inputs or {})
        merged.update(extra_inputs or {})
        return Session(rid=rid, prompt=req.prompt, prompt_ids=prompt_ids,
                       checker=checker, budget=dp.max_tokens,
                       eos_id=self._eos_for(req.constraint), decode=dp,
                       opportunistic=req.constraint.opportunistic,
                       speculator=self._speculator_for(dp), request=req,
                       extra_inputs=merged or None)

    def _speculator_for(self, dp: DecodeParams) -> Optional[Speculator]:
        # greedy-verified: a sampled row's proposals almost never match its
        # draw, and each mismatch would burn an RNG draw whose count depends
        # on the SHARED count model, so sampled rows decode plain
        if not dp.speculative or dp.temperature > 0.0:
            return None
        key = (dp.spec_s, dp.spec_threshold)
        sp = self._speculators.get(key)
        if sp is None:
            sp = Speculator(self.count_model, s=dp.spec_s,
                            threshold=dp.spec_threshold)
            self._speculators[key] = sp
        return sp

    # -- sampling -----------------------------------------------------------------

    def _default_policy(self) -> _RowPolicy:
        pol = _RowPolicy(temperature=self.cfg.temperature,
                         opportunistic=self.cfg.opportunistic,
                         decode=self.default_decode)
        pol._rng = self.rng
        return pol

    def _select(self, logits: np.ndarray, mask: Optional[np.ndarray],
                policy=None) -> int:
        pol = policy or self._default_policy()
        return select_token(logits, mask, pol.temperature,
                            pol.rng if pol.temperature > 0.0 else None)

    def _pick(self, logits: np.ndarray, checker, premask=None,
              policy=None) -> Tuple[Optional[int], int, float]:
        """Select the next token under the row's constraint and decode
        policy.  Returns (token or None at a dead end, intervened?,
        mask_seconds).  Packed uint32 masks stay packed on the greedy
        branch and are unpacked only for temperature > 0 sampling."""
        pol = policy or self._default_policy()
        if checker is None:
            return self._select(logits, None, pol), 0, 0.0
        mask_t = 0.0
        greedy = pol.temperature <= 0.0
        if pol.opportunistic and greedy:
            cand = int(logits.argmax())
            t0 = time.perf_counter()
            ok = checker.check_token(cand)
            mask_t += time.perf_counter() - t0
            if ok:
                return cand, 0, mask_t
        bits = mask = None
        if premask is not None:
            if premask.dtype == np.uint32:
                bits = premask
            else:
                mask = premask
        elif greedy and hasattr(checker, "mask_bits"):
            t0 = time.perf_counter()
            bits = checker.mask_bits()
            mask_t += time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            mask = checker.mask()
            mask_t += time.perf_counter() - t0
        if bits is not None:
            if greedy:
                raw = int(logits.argmax())
                if bitmask.get_bit(bits, raw):
                    return raw, 0, mask_t
                tok = packed_argmax(logits, bits, self._v)
                if tok is None:
                    return None, 0, mask_t
                return tok, 1, mask_t
            # sampling at temperature > 0 is the one place the bits widen;
            # the greedy and verify paths above stay packed
            mask = bitmask.unpack(bits, self._v)  # hotpath-lint: allow
        if not mask.any():
            return None, 0, mask_t
        tok = self._select(logits, mask, pol)
        intervened = int(tok != int(logits.argmax()))
        return tok, intervened, mask_t

    # -- generation -----------------------------------------------------------------

    def _host_logits(self, logits: torch.Tensor) -> np.ndarray:
        """Last position's logits of a (1, S, V) step, sliced to the
        tokenizer's vocab, as float32 on the host."""
        return logits[0, -1, :self._v].float().cpu().numpy()

    def _tokens(self, ids: List[List[int]]) -> torch.Tensor:
        return torch.tensor(ids, dtype=torch.int64, device=self.device)

    def generate(self, request: Union[str, Request],
                 extra_inputs: Optional[Dict[str, Any]] = None
                 ) -> GenerationResult:
        """Serve one request on the single-request path: a dense B=1
        cache whose scalar length takes the decode kernel's contiguous
        mode when ``use_pallas_kernels`` is set."""
        t_start = time.perf_counter()
        req = self._coerce(request)
        dp = req.decode
        eos_id = self._eos_for(req.constraint)
        policy = _RowPolicy(temperature=dp.temperature,
                            opportunistic=req.constraint.opportunistic,
                            decode=dp)
        speculator = self._speculator_for(dp)
        prompt_ids, checker = self._prep(req)
        cache = self.model.init_cache(1, self.max_len, device=self.device)
        inputs = {"tokens": self._tokens([prompt_ids])}
        inputs.update(req.extra_inputs or {})
        inputs.update(extra_inputs or {})

        model_t = mask_t = 0.0
        n_fwd = n_int = n_prop = n_acc = 0
        out_ids: List[int] = []
        snap = None       # pre-verify recurrent state, one buffer a call

        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, inputs, cache)
        logits = self._host_logits(logits)
        model_t += time.perf_counter() - t0
        n_fwd += 1

        finished = dead_end = False
        status: Optional[str] = None
        error: Optional[str] = None
        budget = dp.max_tokens
        while budget > 0 and not finished and not dead_end \
                and status is None:
            if dp.deadline_s is not None \
                    and time.perf_counter() - t_start > dp.deadline_s:
                status = "deadline_exceeded"
                error = f"deadline {dp.deadline_s:g}s exceeded"
                break
            if not np.all(np.isfinite(logits)):
                status = "internal_error"
                error = "non-finite logits from device step"
                break
            # ---- speculative path: propose, verify in one forward ------------
            if (speculator is not None and checker is not None
                    and hasattr(checker, "clone")):
                tok0, intervened, dt = self._pick(logits, checker,
                                                  policy=policy)
                mask_t += dt
                if tok0 is None:
                    dead_end = True
                    break
                n_int += intervened
                if tok0 == eos_id:
                    finished = True
                    checker.advance(tok0)
                    break
                speculator.observe(checker.state_key(), tok0)
                checker.advance(tok0)
                out_ids.append(tok0)
                budget -= 1
                proposals = speculator.propose(checker)
                n_prop += len(proposals)
                feed = [tok0] + proposals
                # a fixed verify width (spec_s + 1); pads are rolled back
                n_pad = (1 + dp.spec_s) - len(feed)
                feed_p = feed + [self.tok.pad_id] * n_pad
                if self._needs_refeed:
                    # the forward overwrites the recurrent state in place
                    snap = kvcache.snapshot_state(cache, snap)
                t0 = time.perf_counter()
                lg_multi, cache = self._decode(self.params, cache,
                                               self._tokens([feed_p]))
                lg_multi = lg_multi[0, :, :self._v].float().cpu().numpy()
                model_t += time.perf_counter() - t0
                n_fwd += 1
                accepted = 0
                for i, prop in enumerate(proposals):
                    if budget <= 0:
                        break
                    if not np.all(np.isfinite(lg_multi[i])):
                        status = "internal_error"
                        error = ("non-finite logits in speculative "
                                 "verify window")
                        break
                    # a raw argmax equal to the proposal needs only an
                    # O(token) legality check, not the full mask
                    tok_i = None
                    if dp.temperature <= 0.0 \
                            and int(lg_multi[i].argmax()) == prop:
                        t0 = time.perf_counter()
                        ok = checker.check_token(prop)
                        mask_t += time.perf_counter() - t0
                        if ok:
                            tok_i = prop
                    if tok_i is None:
                        tok_i, intervened, dt = self._pick(
                            lg_multi[i], checker, policy=policy)
                        mask_t += dt
                        if tok_i is None:
                            dead_end = True
                            break
                        n_int += intervened
                    if tok_i != prop:
                        break
                    speculator.observe(checker.state_key(), tok_i)
                    checker.advance(tok_i)
                    accepted += 1
                    if tok_i == eos_id:
                        finished = True
                        break
                    out_ids.append(tok_i)
                    budget -= 1
                n_acc += accepted
                rejected = len(proposals) - accepted
                if rejected > 0 or n_pad > 0:
                    if self._needs_refeed:
                        # recompute from the pre-verify state at the exact
                        # length: recurrent state cannot host pads
                        t0 = time.perf_counter()
                        cache = kvcache.restore_state(cache, snap)
                        lg_re, cache = self._decode(
                            self.params, cache,
                            self._tokens([feed[:1 + accepted]]))
                        logits = self._host_logits(lg_re)
                        model_t += time.perf_counter() - t0
                        n_fwd += 1
                    else:
                        cache = self.model.rollback(cache,
                                                    rejected + n_pad)
                        logits = lg_multi[accepted]
                else:
                    logits = lg_multi[len(proposals)]
                continue

            # ---- plain path --------------------------------------------------
            tok, intervened, dt = self._pick(logits, checker, policy=policy)
            mask_t += dt
            if tok is None:
                dead_end = True
                break
            n_int += intervened
            if checker is not None:
                checker.advance(tok)
            if tok == eos_id:
                finished = True
                break
            out_ids.append(tok)
            budget -= 1
            t0 = time.perf_counter()
            lg, cache = self._decode(self.params, cache,
                                     self._tokens([[tok]]))
            logits = self._host_logits(lg)
            model_t += time.perf_counter() - t0
            n_fwd += 1

        return GenerationResult(
            status=status or ("dead_end" if dead_end else "ok"),
            error=error,
            text=self.tok.decode(out_ids),
            token_ids=out_ids,
            n_forward_passes=n_fwd,
            n_tokens=len(out_ids),
            n_interventions=n_int,
            n_spec_proposed=n_prop,
            n_spec_accepted=n_acc,
            mask_time_s=mask_t,
            model_time_s=model_t,
            wall_time_s=time.perf_counter() - t_start,
            finished=finished,
            dead_end=dead_end,
            mask_cache_hits=getattr(checker, "n_mask_memo_hits", 0),
            n_hyp_truncations=getattr(checker, "n_hyp_truncations", 0),
            max_hyp_fanout=getattr(checker, "max_hyp_fanout", 1),
        )

    def generate_batch(self, requests: List[Union[str, Request]],
                       max_batch: Optional[int] = None,
                       paged: Optional[bool] = None,
                       page_size: Optional[int] = None,
                       n_pages: Optional[int] = None,
                       queue_limit: Optional[int] = None,
                       queue_timeout_s: Optional[float] = None,
                       default_deadline_s: Optional[float] = None,
                       fault_injector=None,
                       debug_invariants: bool = False,
                       device_loop: bool = False,
                       sync_n: int = 8,
                       journal=None,
                       supervisor=None,
                       prefix_cache: bool = False) -> List[GenerationResult]:
        """Serve ``requests`` through the continuous-batching scheduler.
        ``max_batch`` caps the decode batch (slots); extra requests wait
        and reuse slots.  The KV cache is paged by default on pageable
        architectures (``paged``/``page_size``/``n_pages`` size the pool;
        an undersized pool exerts admission backpressure and recompute
        preemption instead of running out of memory).  Call
        :meth:`precompute` first to keep tree building off the serving
        critical path.

        The failure and durability knobs pass straight to the scheduler:
        ``queue_limit``/``queue_timeout_s`` bound the waiting queue,
        ``default_deadline_s`` the wall time of requests without their own
        ``DecodeParams.deadline_s``; ``fault_injector``,
        ``debug_invariants``, ``journal`` (see :meth:`restore`) and
        ``supervisor`` as there.  Every request gets a result; a non-ok
        one carries its ``status`` and ``error``.

        ``device_loop=True`` runs rows whose grammar carries a clean device
        table through the scheduler's fused block (build the tables first:
        ``ServingEngine(..., device_tables=True)`` and :meth:`precompute`);
        ``sync_n`` is the number of decode steps a block fuses per host
        sync.  Other rows decode on the host path, token for token as with
        ``device_loop=False``.

        ``prefix_cache=True`` (paged only) shares whole KV pages across
        requests with equal token prefixes through a radix tree,
        copy-on-write: an admission maps the cached prefix and prefills
        only its tail, with the same output as a cold cache.  The engine's
        pinned prompts (``pin_prompt``) are prefilled first."""
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler
        cap = min(len(requests), max_batch) if max_batch else len(requests)
        kwargs = {}
        if paged is not None:
            kwargs["paged"] = paged
        if page_size is not None:
            kwargs["page_size"] = page_size
        if n_pages is not None:
            kwargs["n_pages"] = n_pages
        sched = ContinuousBatchingScheduler(
            self, capacity=cap, queue_limit=queue_limit,
            queue_timeout_s=queue_timeout_s,
            default_deadline_s=default_deadline_s,
            fault_injector=fault_injector,
            debug_invariants=debug_invariants,
            device_loop=device_loop, sync_n=sync_n,
            journal=journal, supervisor=supervisor,
            prefix_cache=prefix_cache, **kwargs)
        if prefix_cache:
            # the pinned prompts go in before any admission (precompute()
            # is the caller's)
            sched._pin_prompts()
        sessions = [sched.submit(r) for r in requests]
        sched.run()
        self.last_batch_stats = sched.stats()
        return [s.result for s in sessions]

    def restore(self, journal_path: str, max_batch: Optional[int] = None,
                journal=None, **scheduler_kwargs):
        """Cold-restart recovery: replay the journal at ``journal_path``
        and return a scheduler holding every journaled request -- terminal
        ones with their journaled result, live ones rebuilt (validated
        prefix replayed through a fresh checker, RNG stream restored) and
        queued for re-prefill.  ``run()`` it to finish them; greedy rows
        end bitwise equal to an uninterrupted run.  Pass ``journal``
        (typically ``TokenJournal(journal_path)``, which truncates a torn
        tail) to keep the resumed run durable in the same file: replayed
        state is journaled idempotently, so repeated crash/restore cycles
        converge.  With ``prefix_cache=True`` among ``scheduler_kwargs``
        the live entries adopt cached checker snapshots and re-acquire
        their prefixes' pages through the cache."""
        from repro_torch.serving.journal import replay_journal
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler
        entries = replay_journal(journal_path)
        cap = scheduler_kwargs.pop("capacity", None)
        if cap is None:
            live = sum(1 for e in entries.values()
                       if e.terminal is None and e.recoverable)
            cap = max(1, min(live, max_batch) if max_batch else live)
        sched = ContinuousBatchingScheduler(
            self, capacity=cap, journal=journal, **scheduler_kwargs)
        for entry in entries.values():
            sched.adopt(entry)
        return sched

    # -- template mode ------------------------------------------------------------

    def generate_template(self, prompt: str, parts) -> GenerationResult:
        """GUIDANCE-style template execution (the baseline of the paper's
        Fig. 2 / Table 2): fixed parts are forced as one multi-token
        forward each, generated parts select under their slot's mask."""
        t_start = time.perf_counter()
        session = TemplateSession(parts, list(self.tok.vocab),
                                  self.tok.eos_id, self.tok.encode_greedy)
        prompt_ids = self.tok.encode(prompt) or [self.tok.bos_id]
        cache = self.model.init_cache(1, self.max_len, device=self.device)
        t0 = time.perf_counter()
        logits, cache = self._prefill(
            self.params, {"tokens": self._tokens([prompt_ids])}, cache)
        logits = self._host_logits(logits)
        model_t = time.perf_counter() - t0
        n_fwd = 1
        out_ids: List[int] = []
        budget = self.cfg.max_tokens
        while budget > 0:
            action, payload = session.next_action()
            if action == "done":
                break
            if action == "force":
                if not payload:
                    continue
                out_ids.extend(payload)
                budget -= len(payload)
                t0 = time.perf_counter()
                lg, cache = self._decode(self.params, cache,
                                         self._tokens([payload]))
                logits = self._host_logits(lg)
                model_t += time.perf_counter() - t0
                n_fwd += 1
                continue
            tok = self._select(logits, payload)      # under the slot mask
            session.feed(tok)
            if tok == self.tok.eos_id:
                continue          # the slot ended; EOS is not emitted
            out_ids.append(tok)
            budget -= 1
            t0 = time.perf_counter()
            lg, cache = self._decode(self.params, cache,
                                     self._tokens([[tok]]))
            logits = self._host_logits(lg)
            model_t += time.perf_counter() - t0
            n_fwd += 1
        return GenerationResult(
            text=self.tok.decode(out_ids), token_ids=out_ids,
            n_forward_passes=n_fwd, n_tokens=len(out_ids),
            n_interventions=session.forced_tokens,
            n_spec_proposed=0, n_spec_accepted=0,
            mask_time_s=0.0, model_time_s=model_t,
            wall_time_s=time.perf_counter() - t_start, finished=True)
