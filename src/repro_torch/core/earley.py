"""Incremental Earley parser over terminal ids.

DOMINO runs a parser in lock-step with the scanner (§3.4): at inference time
the parser state prunes the precomputed subterminal trees.  We use Earley
because it handles every CFG (the App. C grammars include ambiguity and
nullable rules) and supports O(1)-amortised *incremental* advancing plus
cheap *forking* — the decoder keeps one parser per hypothesis.

The chart is append-only: a fork shares all finalized item-sets, so cloning
is a shallow list copy.

Nullable completion uses the Aycock–Horspool trick (predicting a nullable
nonterminal also advances the predictor), which makes single-pass item-set
construction correct for grammars with epsilon rules.
"""
from __future__ import annotations

from typing import FrozenSet, List, Optional, Set, Tuple

from repro_torch.core.grammar import Grammar, is_terminal, nt_id

# An Earley item: (rule_index, dot_position, origin_set_index)
Item = Tuple[int, int, int]


class _ItemSet:
    __slots__ = ("items", "expected", "wanted_by", "complete_start")

    def __init__(self):
        self.items: Set[Item] = set()
        # terminal id -> list of items expecting it (for scanning)
        self.expected: dict = {}
        # nonterminal id -> list of items expecting it (for completion)
        self.wanted_by: dict = {}
        # True if the start symbol is complete over the whole prefix
        self.complete_start: bool = False


class EarleyParser:
    """Incremental recognizer.

    Usage::

        p = EarleyParser(grammar)
        p.allowed_terminals()      # set of legal next terminal ids
        p2 = p.fork()
        ok = p2.advance(tid)       # feed one terminal; False if illegal
        p2.accepts()               # is the consumed sequence a full parse?
    """

    def __init__(self, grammar: Grammar, _chart: Optional[List[_ItemSet]] = None,
                 _hash: int = 0):
        self.g = grammar
        if _chart is not None:
            self.chart = _chart
            self._hash = _hash
            return
        self.chart = []
        s0 = self._make_set(0, seeds=[(ri, 0, 0)
                                      for ri in grammar.rules_by_lhs.get(
                                          grammar.start, [])])
        self.chart.append(s0)
        self._hash = hash(frozenset(s0.items))

    # -- public API ---------------------------------------------------------

    def fork(self) -> "EarleyParser":
        return EarleyParser(self.g, _chart=list(self.chart), _hash=self._hash)

    @property
    def position(self) -> int:
        return len(self.chart) - 1

    def allowed_terminals(self) -> FrozenSet[int]:
        return frozenset(self.chart[-1].expected.keys())

    def can_accept(self, tid: int) -> bool:
        return tid in self.chart[-1].expected

    def accepts(self) -> bool:
        return self.chart[-1].complete_start

    def advance(self, tid: int) -> bool:
        """Consume terminal ``tid``; returns False (state unchanged) if illegal."""
        cur = self.chart[-1]
        scanners = cur.expected.get(tid)
        if not scanners:
            return False
        pos = len(self.chart)
        seeds = [(ri, dot + 1, org) for (ri, dot, org) in scanners]
        new_set = self._make_set(pos, seeds)
        self.chart.append(new_set)
        # Incremental whole-history fingerprint: equal fingerprints mean the
        # parsers consumed terminal sequences inducing identical charts, so
        # all future behaviour coincides.  Used to deduplicate hypotheses.
        self._hash = hash((self._hash, frozenset(new_set.items)))
        return True

    def chart_fingerprint(self) -> int:
        return self._hash

    def state_signature(self) -> int:
        """A hashable digest of the current item set (used as the parser
        substate β for speculative decoding, §3.6)."""
        return hash(frozenset(self.chart[-1].items))

    def rel_signature(self, clamp: int = 8) -> int:
        """Position-RELATIVE digest of the current item set: every item's
        origin is rebased to its distance from the current position and
        clamped at ``clamp``, so the digest recurs across absolute
        positions (``state_signature`` never does — origins are absolute
        chart indices, so it grows stale with history).

        This is the finite-quotient key the static analyzer
        (:mod:`repro_torch.core.analysis`) explores the decoder state space on.
        It is an ABSTRACTION, not an isomorphism: two parsers with equal
        rel-signatures agree on the current item set shape but may carry
        different charts beyond the clamp horizon, so future completion
        behaviour can diverge.  Callers that need soundness must validate
        conclusions against concrete replays (the analyzer does)."""
        pos = len(self.chart) - 1
        return hash(frozenset(
            (ri, dot, min(pos - org, clamp))
            for (ri, dot, org) in self.chart[-1].items))

    # -- internals ----------------------------------------------------------

    def _make_set(self, pos: int, seeds: List[Item]) -> _ItemSet:
        g = self.g
        st = _ItemSet()
        agenda = list(seeds)
        while agenda:
            item = agenda.pop()
            if item in st.items:
                continue
            st.items.add(item)
            ri, dot, org = item
            rule = g.rules[ri]
            if dot == len(rule.rhs):
                # Completion: lhs finished spanning [org, pos].
                if rule.lhs == g.start and org == 0:
                    st.complete_start = True
                parents = (st.wanted_by.get(rule.lhs, []) if org == pos
                           else self.chart[org].wanted_by.get(rule.lhs, []))
                for (pri, pdot, porg) in list(parents):
                    agenda.append((pri, pdot + 1, porg))
                continue
            sym = rule.rhs[dot]
            if is_terminal(sym):
                st.expected.setdefault(sym, []).append(item)
                continue
            n = nt_id(sym)
            first_want = n not in st.wanted_by
            st.wanted_by.setdefault(n, []).append(item)
            if first_want:
                for nri in g.rules_by_lhs.get(n, []):
                    agenda.append((nri, 0, pos))
            else:
                # A completion of n within this same set may already have
                # happened; re-run completions for already-complete n items.
                for (cri, cdot, corg) in list(st.items):
                    crule = g.rules[cri]
                    if (cdot == len(crule.rhs) and crule.lhs == n
                            and corg == pos):
                        agenda.append((ri, dot + 1, org))
                        break
            if n in g.nullable:
                # Aycock-Horspool: nullable prediction advances the predictor.
                agenda.append((ri, dot + 1, org))
        return st


def parse_terminals(grammar: Grammar, tids: List[int]) -> bool:
    """Convenience recognizer: does the terminal sequence parse fully?"""
    p = EarleyParser(grammar)
    for t in tids:
        if not p.advance(t):
            return False
    return p.accepts()
