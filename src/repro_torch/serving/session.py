"""Per-request serving state.

A :class:`Session` is everything the continuous-batching scheduler needs to
know about one request: its :class:`~repro_torch.serving.request.Request` (the
constraint spec and decode policy), the grammar checker built from the
engine's grammar registry, its budget, per-row decode policy (EOS id,
temperature, sampling RNG, speculator), the KV slot it occupies while
resident, and per-request statistics (mask time, forward passes,
speculation counters, wall-clock).  Sessions are created by
``ServingEngine.make_session`` / ``Scheduler.submit`` and carry their
:class:`GenerationResult` once finished.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class GenerationResult:
    text: str
    token_ids: List[int]
    n_forward_passes: int
    n_tokens: int
    n_interventions: int              # argmax rejected by the mask
    n_spec_proposed: int
    n_spec_accepted: int
    mask_time_s: float
    model_time_s: float
    wall_time_s: float
    finished: bool
    # portion of mask_time_s the scheduler hid under device execution
    # (host builds step t+1's grammar mask while the device runs step t);
    # mask_time_s - mask_overlap_s is what actually sat on the critical
    # path
    mask_overlap_s: float = 0.0
    # full-mask builds served by the state-keyed memo on the shared
    # per-grammar TreeCache (recurring grammar states are a dict lookup
    # instead of a tree walk) — attributed per request, so a mixed batch
    # reports each row's own hits
    mask_cache_hits: int = 0
    # times this request was recompute-preempted by the paged-KV
    # scheduler (pages reclaimed under pool pressure, prompt + generated
    # prefix re-prefilled on re-admission)
    n_preemptions: int = 0
    # tokens committed through the device-resident fused decode loop
    # (certified-grammar rows under device_loop=True; 0 on the host path)
    n_device_tokens: int = 0
    # tokens restored from the crash journal on restart (replayed through
    # the concrete checker, not re-decoded) rather than generated live
    n_replayed_tokens: int = 0
    # prefill positions served from the radix prefix cache (shared KV
    # pages block-mapped instead of recomputed) across every admission
    # of this request — the per-row "prefill FLOPs skipped" signal
    n_cached_prefix_tokens: int = 0
    # the checker reached a state with NO legal token (including EOS).
    # Output up to this point is a valid *prefix* but cannot be completed;
    # forcing EOS here would silently emit grammar-violating output.
    dead_end: bool = False
    # times the checker's scanner-hypothesis set overflowed
    # MAX_HYPOTHESES and was truncated (a nonzero count means masks were
    # potentially UNSOUND — legal tokens may have been excluded).  The
    # static analyzer's ambiguity report (max abstract fan-out) predicts
    # this: a grammar certified with fan-out well under the cap can never
    # truncate at runtime.
    n_hyp_truncations: int = 0
    # peak size of the checker's hypothesis set over this request —
    # compare against AnalysisReport.max_abstract_fanout to validate the
    # analyzer's ambiguity model on real traffic
    max_hyp_fanout: int = 1
    # terminal-status taxonomy (fault-tolerant serving).  Exactly one of:
    #   ok                 normal completion (per-request EOS or budget)
    #   dead_end           checker state with no legal token (see above)
    #   deadline_exceeded  the request's wall-clock deadline elapsed
    #                      (queue wait included) before completion
    #   cancelled          cancel(rid) took effect at a tick boundary
    #   rejected           never decoded: unsatisfiable admission demand
    #                      (prompt pages > pool capacity), bounded-queue
    #                      load shedding, or queue-wait timeout
    #   internal_error     a failure quarantined to this row — non-finite
    #                      logits from the device step, a checker/mask
    #                      exception — while batch-mates kept decoding
    status: str = "ok"
    # human-readable reason accompanying any non-ok status
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def tokens_per_forward(self) -> float:
        return self.n_tokens / max(1, self.n_forward_passes)


@dataclasses.dataclass
class Session:
    """One request's lifecycle through the scheduler.

    States: waiting (slot < 0) -> active (slot >= 0) -> finished
    (result is not None, slot freed).

    The per-row decode policy lives here: ``eos_id``, ``decode``
    (temperature / budget / seed / speculation knobs), ``opportunistic``,
    the per-request sampling ``rng`` and the (engine-shared-count-model)
    ``speculator``.  The scheduler reads policy from the session, never
    from an engine-global config — that is what lets one batch mix
    grammars, modes and sampling policies per row.
    """
    rid: int
    prompt: str
    prompt_ids: List[int]
    checker: Any                      # DominoDecoder-like, or None
    budget: int
    # -- per-row decode policy (filled by ServingEngine.make_session) --
    eos_id: int = -1
    decode: Any = None                # DecodeParams
    opportunistic: bool = False
    speculator: Any = None            # Speculator sharing the engine's
    #                                   count model, or None
    request: Any = None               # the originating Request
    extra_inputs: Optional[Dict[str, Any]] = None
    slot: int = -1
    out_ids: List[int] = dataclasses.field(default_factory=list)
    # per-request statistics
    n_fwd: int = 0                    # forwards while this request resident
    n_int: int = 0
    n_prop: int = 0
    n_acc: int = 0
    n_preempt: int = 0                # paged-KV recompute preemptions
    # sampling-draw counter: number of temperature>0 selections this
    # request has made.  The device sampling kernel folds it into the
    # request's counter-based PRNG key, so a sampled row's stream depends
    # only on (seed, draw index) — never on batch composition — matching
    # the host np.random.Generator contract in spirit (same independence
    # guarantee, different bit stream).
    n_draws: int = 0
    # tokens this request committed through the device-resident fused
    # decode loop (0 for host-path rows)
    n_device_tokens: int = 0
    # tokens restored from the crash journal (see GenerationResult)
    n_replayed: int = 0
    # prefill positions skipped via prefix-cache page hits (cumulative
    # over re-admissions), and whether adopt() cloned a cached checker
    # snapshot instead of replaying the journal through advance()
    n_cached_tokens: int = 0
    cached_checker: bool = False
    mask_time: float = 0.0            # this request's checker time only
    mask_overlap: float = 0.0         # ... of which hidden under device
    model_time: float = 0.0
    # lifecycle (done == result is not None)
    finished_eos: bool = False
    dead_end: bool = False
    # terminal-status override: the scheduler sets this for
    # cancelled/deadline_exceeded/rejected/internal_error terminations;
    # None resolves to "dead_end" or "ok" at finish time
    status: Optional[str] = None
    error: Optional[str] = None
    # set by Scheduler.cancel(rid); honored at the next tick boundary
    cancel_requested: bool = False
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    t_admit: float = 0.0
    t_finish: float = 0.0
    result: Optional[GenerationResult] = None
    _rng: Optional[np.random.Generator] = dataclasses.field(
        default=None, repr=False)

    @property
    def temperature(self) -> float:
        return 0.0 if self.decode is None else self.decode.temperature

    @property
    def deadline_s(self) -> Optional[float]:
        """Per-request wall-clock deadline (seconds from submit, queue
        wait included); None defers to the scheduler default."""
        return getattr(self.decode, "deadline_s", None)

    @property
    def rng(self) -> np.random.Generator:
        """Per-request sampling RNG, created lazily from the request's
        seed: sampled output depends only on the request, never on batch
        composition or admission order."""
        if self._rng is None:
            self._rng = (self.decode.make_rng() if self.decode is not None
                         else np.random.default_rng(0))
        return self._rng

    def finish(self, decode_text) -> GenerationResult:
        self.t_finish = time.perf_counter()
        status = self.status
        if status is None:
            status = "dead_end" if self.dead_end else "ok"
        self.result = GenerationResult(
            status=status,
            error=self.error,
            text=decode_text(self.out_ids),
            token_ids=list(self.out_ids),
            n_forward_passes=self.n_fwd,
            n_tokens=len(self.out_ids),
            n_interventions=self.n_int,
            n_spec_proposed=self.n_prop,
            n_spec_accepted=self.n_acc,
            mask_time_s=self.mask_time,
            mask_overlap_s=self.mask_overlap,
            mask_cache_hits=getattr(self.checker, "n_mask_memo_hits", 0),
            n_preemptions=self.n_preempt,
            n_device_tokens=self.n_device_tokens,
            n_replayed_tokens=self.n_replayed,
            n_cached_prefix_tokens=self.n_cached_tokens,
            model_time_s=self.model_time,
            wall_time_s=self.t_finish - self.t_submit,
            finished=self.finished_eos,
            dead_end=self.dead_end,
            n_hyp_truncations=getattr(self.checker,
                                      "n_hyp_truncations", 0),
            max_hyp_fanout=getattr(self.checker, "max_hyp_fanout", 1),
        )
        return self.result
