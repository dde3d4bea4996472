"""Character scanner: the union automaton of all terminal regexes (§3.2).

Lemma 3.1: any legal program of CFG ``G`` is a sequence of terminals, so the
regex ``R = (r_1 | ... | r_n)+`` over-approximates ``L_G``.  The scanner
tracks *which* terminal sub-automaton each active state belongs to, so that
feeding a vocabulary token byte-by-byte enumerates the *subterminal
sequences* (§3.3) the token induces:

 - ``emissions`` — the terminals completed inside the token (END/FULL
   subterminals, reported to the parser), and
 - ``final position`` — either the FRESH boundary (token ends exactly at a
   terminal boundary) or a mid-terminal position (START/CONTINUATION
   subterminal), represented as a frozenset of ``(terminal_id, dfa_state)``
   configurations (a set because of lexical ambiguity, e.g. keyword vs
   identifier).

Each terminal regex is compiled to its own *byte DFA* (dead states pruned,
so every configuration is live = can still reach acceptance).  The
nondeterminism of the union NFA lives in the *set* of configurations and in
the emit-vs-continue branch at accepting states (maximal munch is NOT
imposed: both segmentations are kept, and the parser prunes illegal ones —
this is required for minimal invasiveness).
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core.grammar import Grammar

# A scanner position: FRESH (token boundary) or frozenset[(tid, dfa_state)].
FRESH = "FRESH"
Position = object  # FRESH | FrozenSet[Tuple[int, int]]
Branch = Tuple[Tuple[int, ...], object]  # (emissions, final_position)


class Scanner:
    def __init__(self, grammar: Grammar):
        self.g = grammar
        self.dfas = [t.dfa for t in grammar.terminals]
        self.ignore = frozenset(grammar.ignore)
        # start moves: byte -> frozenset of (tid, state) configurations
        self._start_moves: Dict[int, FrozenSet[Tuple[int, int]]] = {}
        for b in range(256):
            confs = []
            for tid, dfa in enumerate(self.dfas):
                s2 = dfa.step(dfa.start, b)
                if s2 is not None:
                    confs.append((tid, s2))
            if confs:
                self._start_moves[b] = frozenset(confs)

    # -- single-byte relation -----------------------------------------------

    def start_moves(self, byte: int) -> Optional[FrozenSet[Tuple[int, int]]]:
        return self._start_moves.get(byte)

    def accepting_terminals(self, position) -> List[Tuple[int, int]]:
        """Configurations of ``position`` at an accepting DFA state."""
        if position is FRESH:
            return []
        return [(t, s) for (t, s) in position if self.dfas[t].is_accept(s)]

    # -- token traversal -----------------------------------------------------

    def traverse_token(self, position, token_bytes: bytes,
                       collapse_ignore: bool = True) -> List[Branch]:
        """Enumerate all (emissions, final_position) branches for feeding
        ``token_bytes`` starting at ``position``.

        ``collapse_ignore=True`` drops ignorable terminals (e.g. whitespace)
        from the emission sequences — the parser never sees them, so
        branches differing only in ignore-runs are merged.
        """
        if position is FRESH:
            init: FrozenSet[Tuple[int, int]] = frozenset()
            branches: Dict[Tuple[int, ...], set] = {(): {("FRESH",)}}
            # We encode "at fresh boundary" as the pseudo-conf ("FRESH",).
        else:
            branches = {(): set(position)}
        for b in token_bytes:
            new_branches: Dict[Tuple[int, ...], set] = {}
            starts = self._start_moves.get(b)
            for ems, confs in branches.items():
                direct = set()
                emit_terminals = set()
                for conf in confs:
                    if conf == ("FRESH",):
                        if starts:
                            direct.update(starts)
                        continue
                    t, s = conf
                    dfa = self.dfas[t]
                    s2 = dfa.step(s, b)
                    if s2 is not None:
                        direct.add((t, s2))
                    if dfa.is_accept(s):
                        emit_terminals.add(t)
                if direct:
                    new_branches.setdefault(ems, set()).update(direct)
                if starts:
                    for t in emit_terminals:
                        if collapse_ignore and t in self.ignore:
                            key = ems
                        else:
                            key = ems + (t,)
                        new_branches.setdefault(key, set()).update(starts)
            branches = new_branches
            if not branches:
                return []
        out: List[Branch] = []
        seen = set()
        for ems, confs in branches.items():
            real = frozenset(c for c in confs if c != ("FRESH",))
            if real:
                out.append((ems, real))
            if ("FRESH",) in confs and (ems, FRESH) not in seen:
                seen.add((ems, FRESH))
                out.append((ems, FRESH))
            # Emit-at-token-end: a configuration sitting exactly on an
            # accepting state may close its terminal at the boundary.
            for (t, s) in real:
                if self.dfas[t].is_accept(s):
                    key = ems if (collapse_ignore and t in self.ignore) \
                        else ems + (t,)
                    if (key, FRESH) not in seen:
                        seen.add((key, FRESH))
                        out.append((key, FRESH))
        return out

    def final_branches(self, position) -> List[Tuple[Tuple[int, ...], bool]]:
        """Branches available when generation stops at ``position``:
        (emissions, clean) where clean=True means the position closes at a
        terminal boundary.  Used for EOS legality."""
        if position is FRESH:
            return [((), True)]
        out = []
        for (t, s) in position:
            if self.dfas[t].is_accept(s):
                if t in self.ignore:
                    out.append(((), True))
                else:
                    out.append(((t,), True))
        return out
