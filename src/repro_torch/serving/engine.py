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

Not ported yet (ROADMAP Queue 1): speculative decoding
(``DecodeParams.speculative``), device grammar tables and the fused loop,
``restore``/journaling, ``pin_prompt``/prefix cache and the template
baseline ``generate_template``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import bitmask
from repro_torch.core.analysis import AnalysisReport, analyze, enforce
from repro_torch.core.grammar import Grammar
from repro_torch.core.scanner import Scanner
from repro_torch.core.trees import TreeCache
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.request import (ConstraintSpec, DecodeParams,
                                         Request, packed_argmax,
                                         select_token)
from repro_torch.serving.session import GenerationResult
from repro_torch.tokenizer import BPETokenizer

DEFAULT_GRAMMAR = "default"
SPECULATION_TODO = ("speculative decoding is not ported to repro_torch yet "
                    "(ROADMAP Queue 1: speculation and _verify_row)")


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


class ServingEngine:
    def __init__(self, model: Model, params, tok: BPETokenizer,
                 grammar: Optional[Grammar] = None,
                 cfg: Optional[EngineConfig] = None,
                 tree_cache: Optional[TreeCache] = None,
                 max_len: int = 1024,
                 analysis_policy: str = "off",
                 max_adhoc_grammars: int = 32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.tok = tok
        self.grammar = grammar
        self.cfg = cfg or EngineConfig()
        self.max_len = max_len
        # registration-time static analysis: off | warn | strict
        self.analysis_policy = analysis_policy
        self.analysis_reports: Dict[str, AnalysisReport] = {}
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
        return out

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
        req = (self.make_request(request) if isinstance(request, str)
               else request)
        if req.decode.speculative:
            raise NotImplementedError(SPECULATION_TODO)
        return req

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
                       speculator=None, request=req,
                       extra_inputs=merged or None)

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
            mask = bitmask.unpack(bits, self._v)
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
        prompt_ids, checker = self._prep(req)
        cache = self.model.init_cache(1, self.max_len, device=self.device)
        inputs = {"tokens": self._tokens([prompt_ids])}
        inputs.update(req.extra_inputs or {})
        inputs.update(extra_inputs or {})

        model_t = mask_t = 0.0
        n_fwd = n_int = 0
        out_ids: List[int] = []

        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, inputs, cache)
        logits = self._host_logits(logits)
        model_t += time.perf_counter() - t0
        n_fwd += 1

        finished = dead_end = False
        status: Optional[str] = None
        error: Optional[str] = None
        budget = dp.max_tokens
        while budget > 0:
            if dp.deadline_s is not None \
                    and time.perf_counter() - t_start > dp.deadline_s:
                status = "deadline_exceeded"
                error = f"deadline {dp.deadline_s:g}s exceeded"
                break
            if not np.all(np.isfinite(logits)):
                status = "internal_error"
                error = "non-finite logits from device step"
                break
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
            n_spec_proposed=0,
            n_spec_accepted=0,
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
                       n_pages: Optional[int] = None
                       ) -> List[GenerationResult]:
        """Serve ``requests`` through the continuous-batching scheduler.
        ``max_batch`` caps the decode batch (slots); extra requests wait
        and reuse slots.  The KV cache is paged by default on pageable
        architectures (``paged``/``page_size``/``n_pages`` size the pool;
        an undersized pool exerts admission backpressure and recompute
        preemption instead of running out of memory).  Call
        :meth:`precompute` first to keep tree building off the serving
        critical path."""
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler
        cap = min(len(requests), max_batch) if max_batch else len(requests)
        kwargs = {}
        if paged is not None:
            kwargs["paged"] = paged
        if page_size is not None:
            kwargs["page_size"] = page_size
        if n_pages is not None:
            kwargs["n_pages"] = n_pages
        sched = ContinuousBatchingScheduler(self, capacity=cap, **kwargs)
        sessions = [sched.submit(r) for r in requests]
        sched.run()
        self.last_batch_stats = sched.stats()
        return [s.result for s in sessions]
