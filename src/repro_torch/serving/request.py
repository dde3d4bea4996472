"""Per-request constraint API — the unit the serving stack speaks.

DOMINO's pitch is *non-invasive* constrained generation, so the request
surface must not bake one grammar into the engine: a deployment serving
JSON, C, and unconstrained traffic runs ONE engine (one KV pool, one
scheduler) and routes constraints per request.

 - :class:`ConstraintSpec` — WHAT to constrain with: a grammar reference
   (a name registered on the engine's grammar registry, a ``Grammar``
   object, or None), the constraint mode, the DOMINO lookahead ``k``,
   opportunistic checking, token healing, and an optional per-request EOS
   id.  The checker factory lives here (``make_checker`` /
   ``prep_prompt``), not on the engine.
 - :class:`DecodeParams` — HOW to decode: temperature, token budget,
   sampling seed, and the speculation knobs.
 - :class:`Request` — prompt + ConstraintSpec + DecodeParams (+ optional
   model side inputs).  ``ServingEngine.generate`` and
   ``Scheduler.submit`` both take one (a bare string submits the
   engine-default request, which is how the legacy ``EngineConfig``
   surface keeps working).

Sampling helpers (``select_token`` / ``packed_argmax``) also live here so
the engine and the scheduler share one selection definition: greedy
selection operates directly on packed uint32 rows (bit test + legal-id
argmax, no ``(V,)`` bool materialization), and the bool unpack survives
only on the temperature>0 branch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import bitmask

#: grammar reference inside a ConstraintSpec: a registry name, an actual
#: Grammar object (auto-registered on first use), or None (unconstrained)
GrammarRef = Union[str, Any, None]

_CONSTRAINED_MODES = ("domino", "naive", "online")


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """What to constrain one request with.

    ``grammar`` is a reference, not a tree cache: the engine's grammar
    registry resolves it to a shared per-grammar ``TreeCache``, so a
    thousand requests on the same grammar share one set of subterminal
    trees and one mask memo.
    """
    grammar: GrammarRef = None
    mode: str = "unconstrained"   # unconstrained|domino|naive|online
    k: Optional[int] = None       # DOMINO lookahead (None = ∞)
    opportunistic: bool = False
    # token healing (§3.5): strip the last `heal` prompt tokens and force
    # the stripped text as a generation prefix
    heal: int = 0
    # per-request EOS id; None = the tokenizer's default
    eos_id: Optional[int] = None

    @property
    def constrained(self) -> bool:
        return self.grammar is not None and self.mode in _CONSTRAINED_MODES

    # -- prompt preparation ---------------------------------------------------

    def prep_prompt(self, prompt_ids: List[int],
                    vocab: Sequence[Optional[bytes]]):
        """Apply token healing (§3.5) to an encoded prompt.  Returns
        ``(prompt_ids, heal_prefix)``."""
        if self.heal > 0 and len(prompt_ids) > self.heal:
            from repro_torch.core.healing import heal_prompt
            return heal_prompt(prompt_ids, vocab, n_strip=self.heal)
        return list(prompt_ids), ""

    # -- checker factory ------------------------------------------------------

    def make_checker(self, grammar, vocab: Sequence[Optional[bytes]],
                     eos_id: int, tree_cache=None, heal_prefix: str = ""):
        """Build this spec's grammar checker against a resolved grammar
        and its shared TreeCache (the engine registry resolves
        ``self.grammar`` to both).  Returns None for unconstrained."""
        mode = self.mode
        if mode == "unconstrained" or grammar is None:
            return None
        if mode == "domino" and heal_prefix:
            from repro_torch.core.healing import HealedDecoder
            return HealedDecoder(grammar, list(vocab), eos_id, heal_prefix,
                                 k=self.k, tree_cache=tree_cache)
        if mode == "domino":
            from repro_torch.core.domino import DominoDecoder
            return DominoDecoder(grammar, list(vocab), eos_id, k=self.k,
                                 tree_cache=tree_cache)
        if mode == "naive":
            from repro_torch.core.domino import DominoDecoder
            return DominoDecoder(grammar, list(vocab), eos_id, k=0,
                                 tree_cache=tree_cache)
        if mode == "online":
            from repro_torch.core.baselines import OnlineParserDecoder
            return OnlineParserDecoder(grammar, list(vocab), eos_id,
                                       tree_cache=tree_cache)
        raise ValueError(mode)


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    """How to decode one request."""
    temperature: float = 0.0      # 0 = greedy
    max_tokens: int = 128
    seed: int = 0                 # per-request sampling seed
    speculative: bool = False
    spec_s: int = 8
    spec_threshold: float = 0.5
    # wall-clock deadline in seconds, measured from submission (queue
    # wait included).  None = unbounded.  An overdue request terminates
    # with status ``deadline_exceeded`` at the next tick boundary, its
    # slot and pages freed for batch-mates.
    deadline_s: Optional[float] = None

    def make_rng(self) -> np.random.Generator:
        """Per-request sampling RNG: seeded from the request, so a
        sampled request's output never depends on batch composition or
        admission order."""
        return np.random.default_rng(self.seed)


@dataclasses.dataclass
class Request:
    """One serving request: prompt + constraint + decode policy."""
    prompt: str
    constraint: ConstraintSpec = dataclasses.field(
        default_factory=ConstraintSpec)
    decode: DecodeParams = dataclasses.field(default_factory=DecodeParams)
    # extra model inputs (e.g. multimodal features), merged into the
    # prefill inputs dict
    extra_inputs: Optional[Dict[str, Any]] = None


# -- shared token selection ----------------------------------------------------


def select_token(logits: np.ndarray, mask: Optional[np.ndarray],
                 temperature: float,
                 rng: Optional[np.random.Generator]) -> int:
    """Reference (bool-mask) selection: greedy masked argmax at
    temperature 0, softmax sampling otherwise.  Ties break to the lowest
    index, matching the fused device kernel."""
    lg = logits.astype(np.float64)
    if mask is not None:
        lg = np.where(mask, lg, -1e30)
    if temperature <= 0.0:
        return int(lg.argmax())
    p = np.exp((lg - lg.max()) / temperature)
    p = p / p.sum()
    return int(rng.choice(len(p), p=p))


def packed_argmax(logits: np.ndarray, bits: np.ndarray,
                  v: int) -> Optional[int]:
    """Greedy masked argmax directly on a packed uint32 row: gather the
    legal token ids from the bitset and argmax their logits — no ``(V,)``
    bool round-trip.  Returns None when no bit is set (dead end).  Tie
    break matches ``select_token``/the fused kernel (lowest legal id)."""
    ids = bitmask.to_ids(bits, v)
    if ids.size == 0:
        return None
    lg = logits.astype(np.float64)
    return int(ids[int(np.argmax(lg[ids]))])
