"""Grammar-state-conditioned speculative decoding (§3.6).

A count-based model ``P(l | α, β)`` where α is the scanner subterminal
digest and β a parser item-set signature.  Structured languages are highly
predictable given (α, β) — e.g. after ``"answer":`` in a JSON schema the
next tokens are near-deterministic — so a table of counts proposes up to
``s`` tokens per step; the LLM validates all of them with ONE forward pass
(the transformer scores every proposed position in parallel).  Rejected
suffixes are discarded by rolling the KV cache length back — no
backtracking compute.

Because counts are keyed by *parser* state, proposals are always legal in
the grammar (we additionally re-check against a cloned decoder while
building the proposal chain, which also yields the decoder states needed to
continue proposing).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from repro_torch.core.domino import DominoDecoder

StateKey = Tuple


class CountModel:
    """P(l | alpha, beta) with maximum-likelihood counts.

    ``version`` increments only when an observation CHANGES some state's
    argmax — proposal chains memoized against the version stay valid across
    the (frequent) observations that just reinforce the current mode.
    """

    def __init__(self):
        self.counts: Dict[StateKey, collections.Counter] = {}
        self.totals: Dict[StateKey, int] = collections.defaultdict(int)
        self.version = 0

    def observe(self, state: StateKey, token_id: int) -> None:
        c = self.counts.setdefault(state, collections.Counter())
        prev_top = c.most_common(1)[0][0] if c else None
        c[token_id] += 1
        self.totals[state] += 1
        if c.most_common(1)[0][0] != prev_top:
            self.version += 1

    def predict(self, state: StateKey) -> Optional[Tuple[int, float]]:
        """Most likely token and its probability, or None if unseen state."""
        c = self.counts.get(state)
        if not c:
            return None
        tok, n = c.most_common(1)[0]
        return tok, n / self.totals[state]

    def n_states(self) -> int:
        return len(self.counts)


class Speculator:
    """Builds speculative proposals for a DOMINO decoding session."""

    def __init__(self, model: Optional[CountModel] = None,
                 s: int = 8, threshold: float = 0.5,
                 learn: bool = True):
        self.model = model or CountModel()
        self.s = s
        self.threshold = threshold
        self.learn = learn
        # memoized proposal chains: state_key -> (model.version, chain)
        self._chain_cache: Dict[Tuple, Tuple[int, List[int]]] = {}

    def propose(self, decoder: DominoDecoder) -> List[int]:
        """Chain of up to ``s`` tokens predicted from grammar state.

        Each proposed token is validated against a cloned decoder, so the
        chain is guaranteed grammar-legal.  Chains are memoized per grammar
        state (invalidated when the count model's argmax landscape moves),
        so steady-state proposing is a dict lookup — the host-side analogue
        of the paper's "learned priors remain fixed" measurement setup.
        """
        key = decoder.state_key()
        hit = self._chain_cache.get(key)
        if hit is not None and hit[0] == self.model.version:
            return list(hit[1])
        out: List[int] = []
        d = decoder.clone()
        for _ in range(self.s):
            pred = self.model.predict(d.state_key())
            if pred is None:
                break
            tok, p = pred
            if p < self.threshold:
                break
            if tok == d.eos_id:
                if not d.eos_legal():
                    break
                out.append(tok)
                break
            if not d.advance(tok):
                break
            out.append(tok)
        self._chain_cache[key] = (self.model.version, list(out))
        return out

    def observe(self, decoder_state_key: StateKey, token_id: int) -> None:
        if self.learn:
            self.model.observe(decoder_state_key, token_id)


def verify_greedy(proposed: List[int], model_argmax: List[int]) -> int:
    """Greedy verification: longest prefix where the proposal equals the
    model's argmax at each position.  Returns number of accepted tokens."""
    n = 0
    for p, m in zip(proposed, model_argmax):
        if p != m:
            break
        n += 1
    return n


def verify_stochastic(proposed: List[int], proposal_probs: List[float],
                      model_probs_at: List[float], uniforms: List[float]
                      ) -> int:
    """Speculative-sampling acceptance rule (Chen et al., 2023):
    accept token i iff u_i < min(1, p_model(tok_i) / q(tok_i)).

    ``proposal_probs`` are q(tok) from the count model; the count model is a
    point-mass-ish proposal, so this keeps the output distribution unbiased
    for temperature sampling.
    """
    n = 0
    for q, p, u in zip(proposal_probs, model_probs_at, uniforms):
        if q <= 0.0:
            break
        if u < min(1.0, p / q):
            n += 1
        else:
            break
    return n
