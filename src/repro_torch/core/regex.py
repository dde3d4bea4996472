"""Regular-expression engine: pattern -> NFA (Thompson) -> DFA (subset).

DOMINO (§3.1-§3.2) builds character-level automata for every grammar
terminal.  We operate on **bytes** (0..255) so the automata compose directly
with a byte-level BPE vocabulary: a vocabulary token is a byte string and is
fed byte-by-byte through terminal automata.

Supported syntax (sufficient for all App. C grammars of the paper):
  literals, ``.``, escapes (``\\n \\t \\r \\\\ \\" \\/ \\xNN \\d \\w \\s``),
  character classes ``[a-z_]`` / ``[^"\\\\]``, alternation ``|``, grouping
  ``()``, quantifiers ``* + ?`` and ``{m}`` / ``{m,}`` / ``{m,n}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple

ALPHABET_SIZE = 256

# ---------------------------------------------------------------------------
# Pattern AST
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Node:
    pass


@dataclasses.dataclass(frozen=True)
class Chars(Node):
    """A single input byte drawn from ``byte_set``."""

    byte_set: FrozenSet[int]


@dataclasses.dataclass(frozen=True)
class Concat(Node):
    parts: Tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class Alt(Node):
    options: Tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class Repeat(Node):
    inner: Node
    min: int
    max: Optional[int]  # None = unbounded


EPSILON = Concat(())

_DIGITS = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(
    list(range(ord("a"), ord("z") + 1))
    + list(range(ord("A"), ord("Z") + 1))
    + list(range(ord("0"), ord("9") + 1))
    + [ord("_")]
)
_SPACE = frozenset(map(ord, " \t\n\r\f\v"))
_ANY = frozenset(range(ALPHABET_SIZE))


class RegexSyntaxError(ValueError):
    pass


class _Parser:
    def __init__(self, pattern: str):
        # Work on the UTF-8 byte expansion so multi-byte literals behave.
        self.data = pattern
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.data[self.pos] if self.pos < len(self.data) else None

    def next(self) -> str:
        ch = self.peek()
        if ch is None:
            raise RegexSyntaxError(f"unexpected end of pattern: {self.data!r}")
        self.pos += 1
        return ch

    # alternation -> concat ('|' concat)*
    def parse(self) -> Node:
        node = self._alternation()
        if self.pos != len(self.data):
            raise RegexSyntaxError(
                f"trailing characters at {self.pos} in {self.data!r}"
            )
        return node

    def _alternation(self) -> Node:
        options = [self._concat()]
        while self.peek() == "|":
            self.next()
            options.append(self._concat())
        if len(options) == 1:
            return options[0]
        return Alt(tuple(options))

    def _concat(self) -> Node:
        parts: List[Node] = []
        while True:
            ch = self.peek()
            if ch is None or ch in "|)":
                break
            parts.append(self._repeat())
        if len(parts) == 1:
            return parts[0]
        return Concat(tuple(parts))

    def _repeat(self) -> Node:
        atom = self._atom()
        while True:
            ch = self.peek()
            if ch == "*":
                self.next()
                atom = Repeat(atom, 0, None)
            elif ch == "+":
                self.next()
                atom = Repeat(atom, 1, None)
            elif ch == "?":
                self.next()
                atom = Repeat(atom, 0, 1)
            elif ch == "{":
                save = self.pos
                self.next()
                spec = ""
                while self.peek() not in (None, "}"):
                    spec += self.next()
                if self.peek() != "}" or not _valid_brace(spec):
                    # Not a quantifier -- treat '{' as literal.
                    self.pos = save
                    break
                self.next()
                lo, hi = _parse_brace(spec)
                atom = Repeat(atom, lo, hi)
            else:
                break
        return atom

    def _atom(self) -> Node:
        ch = self.next()
        if ch == "(":
            inner = self._alternation()
            if self.peek() != ")":
                raise RegexSyntaxError(f"unbalanced '(' in {self.data!r}")
            self.next()
            return inner
        if ch == "[":
            return self._char_class()
        if ch == ".":
            return Chars(_ANY)
        if ch == "\\":
            return Chars(self._escape())
        if ch in "*+?":
            raise RegexSyntaxError(f"dangling quantifier in {self.data!r}")
        bs = ch.encode("utf-8")
        if len(bs) > 1:  # multi-byte literal = byte sequence
            return Concat(tuple(Chars(frozenset([b])) for b in bs))
        return Chars(frozenset([bs[0]]))

    def _escape(self) -> FrozenSet[int]:
        ch = self.next()
        simple = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
                  "0": "\0", "a": "\a", "b": "\b"}
        if ch in simple:
            return frozenset([ord(simple[ch])])
        if ch == "d":
            return _DIGITS
        if ch == "D":
            return _ANY - _DIGITS
        if ch == "w":
            return _WORD
        if ch == "W":
            return _ANY - _WORD
        if ch == "s":
            return _SPACE
        if ch == "S":
            return _ANY - _SPACE
        if ch == "x":
            hi, lo = self.next(), self.next()
            return frozenset([int(hi + lo, 16)])
        # Escaped literal metacharacter (\\, \", \/, \[, \. ...)
        return _char_bytes(ch)

    def _char_class(self) -> Node:
        negate = False
        if self.peek() == "^":
            self.next()
            negate = True
        members: set = set()
        first = True
        while True:
            ch = self.peek()
            if ch is None:
                raise RegexSyntaxError(f"unterminated class in {self.data!r}")
            if ch == "]" and not first:
                self.next()
                break
            first = False
            if ch == "\\":
                self.next()
                lo_set = self._escape()
                if len(lo_set) != 1:
                    members |= lo_set
                    continue
                lo = min(lo_set)
            else:
                self.next()
                bs = _char_bytes(ch)
                if len(bs) != 1:
                    # multi-byte utf-8 literal inside class: add all bytes
                    members |= bs
                    continue
                lo = min(bs)
            if self.peek() == "-" and self.pos + 1 < len(self.data) and self.data[self.pos + 1] != "]":
                self.next()  # consume '-'
                hc = self.next()
                if hc == "\\":
                    hi_set = self._escape()
                    hi = min(hi_set)
                else:
                    hi = min(_char_bytes(hc))
                members |= set(range(lo, hi + 1))
            else:
                members.add(lo)
        byte_set = frozenset(members)
        if negate:
            byte_set = _ANY - byte_set
        return Chars(byte_set)


def _char_bytes(ch: str) -> FrozenSet[int]:
    bs = ch.encode("utf-8")
    if len(bs) == 1:
        return frozenset([bs[0]])
    # A multi-byte character used as a single atom: represented downstream by
    # the caller via concat of its bytes. We signal with the full set here
    # and let parse() expand; simplest is to expand here:
    return frozenset(bs)  # handled in _atom for len>1 via Concat below


def _valid_brace(spec: str) -> bool:
    parts = spec.split(",")
    if len(parts) not in (1, 2):
        return False
    if not parts[0].isdigit():
        return False
    if len(parts) == 2 and parts[1] and not parts[1].isdigit():
        return False
    return True


def _parse_brace(spec: str) -> Tuple[int, Optional[int]]:
    parts = spec.split(",")
    lo = int(parts[0])
    if len(parts) == 1:
        return lo, lo
    return lo, (int(parts[1]) if parts[1] else None)


def parse(pattern: str) -> Node:
    """Parse ``pattern`` into an AST."""
    return _Parser(pattern).parse()


# ---------------------------------------------------------------------------
# Thompson construction -> NFA
# ---------------------------------------------------------------------------


class NFA:
    """Byte NFA with epsilon transitions.

    transitions[state] is a list of (byte_set | None, target); None = eps.
    """

    def __init__(self):
        self.transitions: List[List[Tuple[Optional[FrozenSet[int]], int]]] = []
        self.start = 0
        self.accepts: set = set()

    def new_state(self) -> int:
        self.transitions.append([])
        return len(self.transitions) - 1

    def add(self, src: int, label: Optional[FrozenSet[int]], dst: int) -> None:
        self.transitions[src].append((label, dst))

    @property
    def n_states(self) -> int:
        return len(self.transitions)


def _build(nfa: NFA, node: Node) -> Tuple[int, int]:
    """Return (entry, exit) fragment states for ``node``."""
    if isinstance(node, Chars):
        s, e = nfa.new_state(), nfa.new_state()
        # Multi-byte UTF-8 literal expanded as a byte chain when the set is a
        # contiguous utf-8 encoding; single bytes are the common case.
        nfa.add(s, node.byte_set, e)
        return s, e
    if isinstance(node, Concat):
        if not node.parts:
            s = nfa.new_state()
            return s, s
        entry, cur = None, None
        for part in node.parts:
            ps, pe = _build(nfa, part)
            if entry is None:
                entry = ps
            else:
                nfa.add(cur, None, ps)
            cur = pe
        return entry, cur
    if isinstance(node, Alt):
        s, e = nfa.new_state(), nfa.new_state()
        for opt in node.options:
            os_, oe = _build(nfa, opt)
            nfa.add(s, None, os_)
            nfa.add(oe, None, e)
        return s, e
    if isinstance(node, Repeat):
        lo, hi = node.min, node.max
        s = nfa.new_state()
        cur = s
        # mandatory copies
        for _ in range(lo):
            ps, pe = _build(nfa, node.inner)
            nfa.add(cur, None, ps)
            cur = pe
        if hi is None:
            # star/plus tail: loop
            ps, pe = _build(nfa, node.inner)
            loop_in = nfa.new_state()
            nfa.add(cur, None, loop_in)
            nfa.add(loop_in, None, ps)
            nfa.add(pe, None, loop_in)
            return s, loop_in
        # bounded optional copies
        end = nfa.new_state()
        nfa.add(cur, None, end)
        for _ in range(hi - lo):
            ps, pe = _build(nfa, node.inner)
            nfa.add(cur, None, ps)
            nfa.add(pe, None, end)
            cur = pe
        return s, end
    raise TypeError(node)


def to_nfa(node: Node) -> NFA:
    nfa = NFA()
    s, e = _build(nfa, node)
    nfa.start = s
    nfa.accepts = {e}
    return nfa


# ---------------------------------------------------------------------------
# Subset construction -> DFA
# ---------------------------------------------------------------------------


class DFA:
    """Deterministic byte automaton.

    ``trans[state]`` maps byte -> next state (sparse dict).
    ``accepts`` is a frozenset of accepting states.
    ``live`` marks states from which an accepting state is reachable; the
    subset construction only produces live states so every DFA state here is
    live by construction (dead sink omitted).
    """

    def __init__(self, trans: List[Dict[int, int]], start: int,
                 accepts: FrozenSet[int]):
        self.trans = trans
        self.start = start
        self.accepts = accepts

    @property
    def n_states(self) -> int:
        return len(self.trans)

    def step(self, state: int, byte: int) -> Optional[int]:
        return self.trans[state].get(byte)

    def is_accept(self, state: int) -> bool:
        return state in self.accepts

    def can_continue(self, state: int) -> bool:
        return bool(self.trans[state])

    def matches(self, data: bytes) -> bool:
        st: Optional[int] = self.start
        for b in data:
            st = self.step(st, b)
            if st is None:
                return False
        return st in self.accepts

    def first_bytes(self, state: int) -> FrozenSet[int]:
        return frozenset(self.trans[state].keys())


def _eps_closure(nfa: NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    stack = list(states)
    seen = set(states)
    while stack:
        s = stack.pop()
        for label, dst in nfa.transitions[s]:
            if label is None and dst not in seen:
                seen.add(dst)
                stack.append(dst)
    return frozenset(seen)


def to_dfa(nfa: NFA) -> DFA:
    start_set = _eps_closure(nfa, frozenset([nfa.start]))
    index: Dict[FrozenSet[int], int] = {start_set: 0}
    order: List[FrozenSet[int]] = [start_set]
    trans: List[Dict[int, int]] = [{}]
    accepts: set = set()
    if nfa.accepts & start_set:
        accepts.add(0)
    i = 0
    while i < len(order):
        cur = order[i]
        # Gather outgoing byte moves.
        moves: Dict[int, set] = {}
        for s in cur:
            for label, dst in nfa.transitions[s]:
                if label is None:
                    continue
                for b in label:
                    moves.setdefault(b, set()).add(dst)
        for b, dsts in moves.items():
            nxt = _eps_closure(nfa, frozenset(dsts))
            if nxt not in index:
                index[nxt] = len(order)
                order.append(nxt)
                trans.append({})
                if nfa.accepts & nxt:
                    accepts.add(index[nxt])
            trans[i][b] = index[nxt]
        i += 1
    # Prune dead states (no path to accept) so can_continue() is meaningful.
    n = len(order)
    rev: List[set] = [set() for _ in range(n)]
    for s, m in enumerate(trans):
        for _, d in m.items():
            rev[d].add(s)
    live = set(accepts)
    stack = list(accepts)
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        # Pattern matches nothing reachable; still return a 1-state dead DFA.
        return DFA([{}], 0, frozenset())
    remap = {}
    new_trans: List[Dict[int, int]] = []
    for s in range(n):
        if s in live:
            remap[s] = len(new_trans)
            new_trans.append({})
    for s in range(n):
        if s not in live:
            continue
        for b, d in trans[s].items():
            if d in live:
                new_trans[remap[s]][b] = remap[d]
    new_accepts = frozenset(remap[s] for s in accepts if s in live)
    return DFA(new_trans, remap[0], new_accepts)


def compile_pattern(pattern: str) -> DFA:
    """Compile a regex pattern string into a byte DFA."""
    return to_dfa(to_nfa(parse(pattern)))


def literal_dfa(text: str) -> DFA:
    """DFA matching exactly the UTF-8 bytes of ``text``."""
    data = text.encode("utf-8")
    trans: List[Dict[int, int]] = [{} for _ in range(len(data) + 1)]
    for i, b in enumerate(data):
        trans[i][b] = i + 1
    return DFA(trans, 0, frozenset([len(data)]))
