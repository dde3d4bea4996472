"""Context-free grammar representation + EBNF parser.

A grammar is a set of BNF productions over *terminals* (defined by regex or
literal — compiled to byte DFAs via :mod:`repro_torch.core.regex`) and
*nonterminals*.  This is the ``G`` of DOMINO §3.1: the parser enforces the
productions, the scanner (see :mod:`repro_torch.core.scanner`) enforces terminal
regexes, per Lemma 3.1.

Text format (Lark-like):

    // line comment  (or '#')
    start: value
    value: object | array | STRING | NUMBER
    object: "{" (pair ("," pair)*)? "}"
    pair: STRING ":" value
    STRING: /"([^"\\]|\\.)*"/
    NUMBER: /-?[0-9]+/
    WS: /[ \t\n\r]+/
    %ignore WS

 - lowercase names: nonterminals; UPPERCASE names: terminals.
 - ``"..."`` inside rules: anonymous literal terminals (deduplicated).
 - EBNF sugar ``( ) | * + ?`` is lowered to fresh BNF rules.
 - ``%ignore T`` marks terminal T as skippable anywhere (lexer-level).

Symbols are encoded as ints: ``sym >= 0`` is a terminal id, ``sym < 0`` is
nonterminal ``~sym``.
"""
from __future__ import annotations

import dataclasses
import re as _stdre
from typing import Dict, List, Optional, Tuple

from repro_torch.core import regex as rx


def nt(nid: int) -> int:
    """Encode nonterminal id as a symbol."""
    return ~nid


def is_terminal(sym: int) -> bool:
    return sym >= 0


def nt_id(sym: int) -> int:
    return ~sym


@dataclasses.dataclass
class Terminal:
    name: str
    dfa: rx.DFA
    pattern: str          # source pattern (regex or literal), for display
    is_literal: bool


@dataclasses.dataclass
class Rule:
    lhs: int              # nonterminal id
    rhs: Tuple[int, ...]  # encoded symbols


class Grammar:
    def __init__(self, terminals: List[Terminal], rules: List[Rule],
                 nonterminal_names: List[str], start: int,
                 ignore: Tuple[int, ...] = ()):
        self.terminals = terminals
        self.rules = rules
        self.nonterminal_names = nonterminal_names
        self.start = start                     # nonterminal id
        self.ignore = tuple(ignore)            # terminal ids skippable anywhere
        # index: rules by lhs
        self.rules_by_lhs: Dict[int, List[int]] = {}
        for i, r in enumerate(rules):
            self.rules_by_lhs.setdefault(r.lhs, []).append(i)
        self.nullable = self._compute_nullable()

    @property
    def n_terminals(self) -> int:
        return len(self.terminals)

    @property
    def n_nonterminals(self) -> int:
        return len(self.nonterminal_names)

    def _compute_nullable(self) -> frozenset:
        nullable: set = set()
        changed = True
        while changed:
            changed = False
            for r in self.rules:
                if r.lhs in nullable:
                    continue
                if all((not is_terminal(s)) and nt_id(s) in nullable
                       for s in r.rhs):
                    nullable.add(r.lhs)
                    changed = True
        return frozenset(nullable)

    def first_sets(self) -> Dict[int, frozenset]:
        """FIRST sets: nonterminal id -> terminal ids that can begin one
        of its derivations.  Standard fixpoint over the rules, epsilon
        handled through ``nullable``.  Used by the static analyzer
        (:mod:`repro_torch.core.analysis`) and useful for any table-driven
        consumer of the grammar."""
        first: Dict[int, set] = {n: set()
                                 for n in range(len(self.nonterminal_names))}
        changed = True
        while changed:
            changed = False
            for r in self.rules:
                f = first[r.lhs]
                before = len(f)
                for s in r.rhs:
                    if is_terminal(s):
                        f.add(s)
                        break
                    f |= first[nt_id(s)]
                    if nt_id(s) not in self.nullable:
                        break
                if len(f) != before:
                    changed = True
        return {n: frozenset(v) for n, v in first.items()}

    def terminal_name(self, tid: int) -> str:
        return self.terminals[tid].name

    def describe(self) -> str:
        lines = []
        for r in self.rules:
            rhs = " ".join(
                self.terminals[s].name if is_terminal(s)
                else self.nonterminal_names[nt_id(s)]
                for s in r.rhs) or "ε"
            lines.append(f"{self.nonterminal_names[r.lhs]} -> {rhs}")
        return "\n".join(lines)


class GrammarSyntaxError(ValueError):
    pass


# ---------------------------------------------------------------------------
# EBNF text parser
# ---------------------------------------------------------------------------

_TOKEN_RE = _stdre.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>(//|\#)[^\n]*)
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<string>"(\\.|[^"\\])*")
  | (?P<regex>/(\\.|[^/\\])+/)
  | (?P<op>[:|()*+?])
  | (?P<directive>%[a-z]+)
    """,
    _stdre.VERBOSE,
)


def _lex(text: str):
    pos = 0
    out = []
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise GrammarSyntaxError(f"bad grammar syntax at {text[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


@dataclasses.dataclass(frozen=True)
class _Sym:
    kind: str  # 'name' | 'literal' | 'regex'
    value: str


@dataclasses.dataclass(frozen=True)
class _Seq:
    items: tuple


@dataclasses.dataclass(frozen=True)
class _Alts:
    options: tuple


@dataclasses.dataclass(frozen=True)
class _Rep:
    inner: object
    op: str  # '*' '+' '?'


class _EbnfParser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, val=None):
        k, v = self.next()
        if k != kind or (val is not None and v != val):
            raise GrammarSyntaxError(f"expected {kind} {val}, got {k} {v!r}")
        return v

    def parse_alts(self) -> _Alts:
        opts = [self.parse_seq()]
        while self.peek() == ("op", "|"):
            self.next()
            opts.append(self.parse_seq())
        return _Alts(tuple(opts))

    def parse_seq(self) -> _Seq:
        items = []
        while True:
            k, v = self.peek()
            if k == "name" and self.toks[self.i + 1] == ("op", ":"):
                break  # start of next rule
            if k in ("eof", "directive") or (k == "op" and v in "|)"):
                break
            items.append(self.parse_item())
        return _Seq(tuple(items))

    def parse_item(self):
        node = self.parse_atom()
        while self.peek()[0] == "op" and self.peek()[1] in "*+?":
            _, op = self.next()
            node = _Rep(node, op)
        return node

    def parse_atom(self):
        k, v = self.next()
        if k == "name":
            return _Sym("name", v)
        if k == "string":
            return _Sym("literal", _unescape(v[1:-1]))
        if k == "regex":
            return _Sym("regex", v[1:-1].replace("\\/", "/"))
        if (k, v) == ("op", "("):
            inner = self.parse_alts()
            self.expect("op", ")")
            return inner
        raise GrammarSyntaxError(f"unexpected {k} {v!r} in rule body")


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            mapping = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\",
                       "/": "/", "0": "\0"}
            out.append(mapping.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class _Builder:
    def __init__(self):
        self.terminals: List[Terminal] = []
        self.term_index: Dict[Tuple[str, str], int] = {}  # (kind,key)->tid
        self.nt_names: List[str] = []
        self.nt_index: Dict[str, int] = {}
        self.rules: List[Rule] = []
        self._anon = 0

    def get_nt(self, name: str) -> int:
        if name not in self.nt_index:
            self.nt_index[name] = len(self.nt_names)
            self.nt_names.append(name)
        return self.nt_index[name]

    def fresh_nt(self, hint: str) -> int:
        self._anon += 1
        return self.get_nt(f"__{hint}_{self._anon}")

    def get_literal_terminal(self, text: str) -> int:
        key = ("lit", text)
        if key not in self.term_index:
            self.term_index[key] = len(self.terminals)
            self.terminals.append(
                Terminal(name=repr(text), dfa=rx.literal_dfa(text),
                         pattern=text, is_literal=True))
        return self.term_index[key]

    def def_terminal(self, name: str, kind: str, pattern: str) -> int:
        key = ("name", name)
        if key in self.term_index:
            raise GrammarSyntaxError(f"terminal {name} redefined")
        tid = len(self.terminals)
        self.term_index[key] = tid
        if kind == "literal":
            dfa = rx.literal_dfa(pattern)
        else:
            dfa = rx.compile_pattern(pattern)
            if dfa.matches(b""):
                raise GrammarSyntaxError(
                    f"terminal {name} matches the empty string; "
                    "empty terminals are not supported (make it '+' not '*')")
        self.terminals.append(Terminal(name=name, dfa=dfa, pattern=pattern,
                                       is_literal=(kind == "literal")))
        return tid

    def lookup_terminal(self, name: str) -> Optional[int]:
        return self.term_index.get(("name", name))

    # -- EBNF lowering ------------------------------------------------------
    def lower(self, lhs: int, node) -> None:
        if isinstance(node, _Alts):
            for opt in node.options:
                self.rules.append(Rule(lhs, self.lower_seq(opt)))
        else:
            self.rules.append(Rule(lhs, self.lower_seq(node)))

    def lower_seq(self, seq: _Seq) -> Tuple[int, ...]:
        syms = []
        for item in seq.items:
            syms.append(self.lower_item(item))
        return tuple(syms)

    def lower_item(self, item) -> int:
        if isinstance(item, _Sym):
            if item.kind == "literal":
                return self.get_literal_terminal(item.value)
            if item.kind == "regex":
                # anonymous inline regex terminal
                key = ("rx", item.value)
                if key not in self.term_index:
                    self.term_index[key] = len(self.terminals)
                    self.terminals.append(Terminal(
                        name=f"/{item.value}/",
                        dfa=rx.compile_pattern(item.value),
                        pattern=item.value, is_literal=False))
                return self.term_index[key]
            name = item.value
            if name[0].isupper():
                tid = self.lookup_terminal(name)
                if tid is None:
                    raise GrammarSyntaxError(f"undefined terminal {name}")
                return tid
            return nt(self.get_nt(name))
        if isinstance(item, _Alts):
            fresh = self.fresh_nt("grp")
            self.lower(fresh, item)
            return nt(fresh)
        if isinstance(item, _Rep):
            inner_sym = self.lower_item(item.inner)
            fresh = self.fresh_nt("rep")
            if item.op == "?":
                self.rules.append(Rule(fresh, ()))
                self.rules.append(Rule(fresh, (inner_sym,)))
            elif item.op == "*":
                self.rules.append(Rule(fresh, ()))
                self.rules.append(Rule(fresh, (inner_sym, nt(fresh))))
            elif item.op == "+":
                self.rules.append(Rule(fresh, (inner_sym,)))
                self.rules.append(Rule(fresh, (inner_sym, nt(fresh))))
            return nt(fresh)
        raise TypeError(item)


def parse_grammar(text: str, start: str = "start") -> Grammar:
    tokens = _lex(text)
    p = _EbnfParser(tokens)
    b = _Builder()
    # First pass: collect rule definitions in order; terminal defs must be
    # processed before rules referencing them, so do two sweeps over the
    # token stream: (1) terminal definitions, (2) nonterminal rules.
    defs: List[Tuple[str, object]] = []
    ignore_names: List[str] = []
    while p.peek()[0] != "eof":
        k, v = p.peek()
        if k == "directive":
            p.next()
            if v == "%ignore":
                nk, nv = p.next()
                if nk != "name":
                    raise GrammarSyntaxError("%ignore expects a terminal name")
                ignore_names.append(nv)
                continue
            raise GrammarSyntaxError(f"unknown directive {v}")
        if k != "name":
            raise GrammarSyntaxError(f"expected rule name, got {k} {v!r}")
        name = p.next()[1]
        p.expect("op", ":")
        body = p.parse_alts()
        defs.append((name, body))
    # Terminal definitions: NAME uppercase and body is a single _Sym literal
    # or regex.
    rule_defs = []
    for name, body in defs:
        if name[0].isupper():
            if (len(body.options) == 1 and len(body.options[0].items) == 1
                    and isinstance(body.options[0].items[0], _Sym)
                    and body.options[0].items[0].kind in ("literal", "regex")):
                sym = body.options[0].items[0]
                b.def_terminal(name, sym.kind, sym.value)
                continue
            raise GrammarSyntaxError(
                f"terminal {name} must be a single literal or /regex/")
        rule_defs.append((name, body))
    if not rule_defs:
        raise GrammarSyntaxError("no rules")
    for name, body in rule_defs:
        b.lower(b.get_nt(name), body)
    if start not in b.nt_index:
        raise GrammarSyntaxError(f"no start rule {start!r}")
    ignore_ids = []
    for n in ignore_names:
        tid = b.lookup_terminal(n)
        if tid is None:
            raise GrammarSyntaxError(f"%ignore of undefined terminal {n}")
        ignore_ids.append(tid)
    return Grammar(b.terminals, b.rules, b.nt_names, b.nt_index[start],
                   tuple(ignore_ids))
