"""Random sampling of strings from a Grammar.

Used by (a) the tokenizer-training corpus generator, (b) the synthetic data
pipeline for training the in-repo models on grammar-structured text, and
(c) property-based tests (every sampled string must be accepted by DOMINO).
"""
from __future__ import annotations

import random
from typing import List, Optional

from repro_torch.core import regex as rx
from repro_torch.core.grammar import Grammar, is_terminal, nt_id


def sample_from_dfa(dfa: rx.DFA, rng: random.Random,
                    max_len: int = 12) -> bytes:
    """Random accepted string of the DFA (biased toward short strings).

    All DFA states are live, so a path to acceptance always exists; we stop
    at accepting states with increasing probability.
    """
    out = bytearray()
    state = dfa.start
    while True:
        accept = dfa.is_accept(state)
        cont = dfa.can_continue(state)
        if accept and (not cont or len(out) >= max_len
                       or rng.random() < 0.35):
            return bytes(out)
        if not cont:
            return bytes(out)  # accept must hold (live states)
        # prefer printable bytes when available, for readable corpora
        choices = list(dfa.trans[state].keys())
        printable = [b for b in choices if 32 <= b < 127]
        b = rng.choice(printable or choices)
        out.append(b)
        state = dfa.step(state, b)


class GrammarSampler:
    def __init__(self, grammar: Grammar, seed: int = 0,
                 max_depth: int = 24, ws: bytes = b" "):
        self.g = grammar
        self.rng = random.Random(seed)
        self.max_depth = max_depth
        self.ws = ws
        # minimal expansion depth per nonterminal, to steer away from
        # divergence when the depth budget runs low
        self.min_depth = self._min_depths()

    def _min_depths(self):
        INF = 1 << 30
        depth = {n: INF for n in range(self.g.n_nonterminals)}
        changed = True
        while changed:
            changed = False
            for r in self.g.rules:
                d = 0
                for s in r.rhs:
                    if is_terminal(s):
                        continue
                    d = max(d, depth[nt_id(s)])
                d = d + 1 if d < INF else INF
                if d < depth[r.lhs]:
                    depth[r.lhs] = d
                    changed = True
        return depth

    def sample(self, max_ws: float = 0.15) -> bytes:
        """One random sentence; ``max_ws`` = chance of inserting whitespace
        between adjacent terminals (exercises the ignore channel)."""
        parts: List[bytes] = []
        self._expand(self.g.start, 0, parts)
        joined = bytearray()
        ig = bool(self.g.ignore)

        def wordish(b: int) -> bool:
            return (48 <= b <= 57) or (65 <= b <= 90) or (97 <= b <= 122) \
                or b in (95, 46, 45)  # _ . -

        for i, p in enumerate(parts):
            if not p:
                continue
            if i and ig and joined:
                # mandatory separator when gluing would re-lex (keyword+ident,
                # number+number, ...); optional elsewhere
                if (wordish(joined[-1]) and wordish(p[0])) \
                        or self.rng.random() < max_ws:
                    joined += self.ws
            joined += p
        return bytes(joined)

    def _expand(self, n: int, depth: int, parts: List[bytes]) -> None:
        rules = self.g.rules_by_lhs.get(n, [])
        if depth >= self.max_depth:
            best = min(rules, key=lambda ri: self._rule_depth(ri))
            choice = best
        else:
            choice = self.rng.choice(rules)
        for s in self.g.rules[choice].rhs:
            if is_terminal(s):
                t = self.g.terminals[s]
                if t.is_literal:
                    parts.append(t.pattern.encode("utf-8"))
                else:
                    parts.append(sample_from_dfa(t.dfa, self.rng))
            else:
                self._expand(nt_id(s), depth + 1, parts)

    def _rule_depth(self, ri: int) -> int:
        d = 0
        for s in self.g.rules[ri].rhs:
            if not is_terminal(s):
                d = max(d, self.min_depth[nt_id(s)])
        return d

    def corpus(self, n: int, sep: bytes = b"\n") -> bytes:
        return sep.join(self.sample() for _ in range(n))
