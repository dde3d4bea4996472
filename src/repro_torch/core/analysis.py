"""Grammar × vocabulary static analysis (registration-time verification).

The paper's central claim is that constrained decoding fails when grammars
and sub-word vocabularies are misaligned; until now this repo only
discovered such failures at runtime, as a per-request ``dead_end`` flag
after tokens were already burned.  This module proves (or refutes)
alignment *before* a grammar serves traffic, in two layers:

**Layer 1 — CFG/lexer alone** (:func:`analyze_static`): unreachable and
unproductive nonterminals, terminals whose regex denotes the empty
language, terminals whose whole language is swallowed by a scanner
``%ignore`` rule, and left-recursion / nullable-cycle hazards for the
Earley chart.  Pure symbol-level fixpoints + DFA product constructions —
no vocabulary involved.

**Layer 2 — grammar × vocabulary** (:func:`explore_decoder`): exhaustive
BFS over the reachable DOMINO decoder state space on the finite quotient
``DominoDecoder.abstract_key(clamp)`` = frozenset of per-hypothesis
(position-relative parser signature, scanner position).  Every abstract
state keeps a CONCRETE representative decoder (the first one to reach
it), so per-state packed masks come from the real PR-4 bitset walk and
every reported witness is a real token path.  The exploration yields:

 - **trap states** — reachable states whose packed mask is empty with
   EOS illegal (exactly the runtime ``dead_end`` condition, since
   ``mask_bits()`` bakes the EOS bit in).  Each carries its shortest
   concrete witness token path, replayed through a fresh
   ``DominoDecoder`` to confirm;
 - **EOS-liveness** — states from which no path reaches an EOS-legal
   state (reverse reachability over the recorded edges; only claimed
   when the closure is finite);
 - **alignment gaps** — terminals no vocabulary token sequence can
   spell (they appear in no subterminal-tree emission edge and no
   EOS-boundary emission), i.e. productions statically unreachable
   under this tokenizer;
 - a **closure certificate** — whether the quotient closed under the
   state bound, its state/edge count, and the implied device
   mask-table footprint (``states × ceil(V/32)`` uint32 words): the
   enumeration the ROADMAP's device-resident decode loop uploads.

Soundness of the quotient (READ THIS before trusting a verdict):
``rel_signature`` clamps chart origins, so two concrete decoder states
may share an abstract key while behaving differently beyond the clamp
horizon.  Consequences:

 - every reported trap is REAL (its witness is a concrete replayed
   path) — no false positives;
 - "trap-free" / "EOS-live" verdicts are certificates about the
   *representatives explored*: a conflated state could in principle
   hide a trap.  The explorer therefore samples merge consistency —
   when a transition lands on an already-known key, it periodically
   compares the arriving decoder's mask against the representative's
   (``n_mask_conflicts``).  Zero conflicts over all merges is strong
   evidence the quotient is exact for this grammar; any nonzero count
   downgrades the certificate and is reported as an error.

Policy (:func:`enforce`): ``off`` skips analysis entirely; ``warn``
reports problems as a ``RuntimeWarning`` and registers the grammar
anyway; ``strict`` raises :class:`AnalysisError` *before* the grammar is
registered.  ``warn`` therefore guarantees nothing beyond visibility;
``strict`` guarantees no registered grammar has a known trap, dead
terminal, unproductive reachable nonterminal, alignment gap, or
EOS-liveness hole (modulo the quotient caveat above, tempered by the
conflict sampler and witness replay).
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import bitmask
from repro_torch.core.domino import DominoDecoder
from repro_torch.core.grammar import Grammar, is_terminal, nt_id
from repro_torch.core.regex import DFA
from repro_torch.core.scanner import FRESH, Scanner
from repro_torch.core.trees import TreeCache

POLICIES = ("off", "warn", "strict")
DEFAULT_MAX_STATES = 2048
DEFAULT_CLAMP = 8
# transition-table sentinel: "this (state, token) edge leaves the
# precomputed frontier" — the serving scheduler falls the row back to the
# host path when its state id goes negative
OFF_FRONTIER = -1
# every Nth merge onto a known abstract state re-derives the mask and
# compares it against the representative's (quotient-soundness sampling)
MERGE_CHECK_STRIDE = 7


# ---------------------------------------------------------------------------
# report datatypes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Issue:
    """One layer-1 finding (or an alignment gap)."""
    kind: str          # e.g. "empty-terminal", "unreachable-nonterminal"
    severity: str      # "error" | "warning" | "info"
    symbol: str        # terminal/nonterminal name
    detail: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.kind}: {self.symbol} — {self.detail}"


@dataclasses.dataclass
class Witness:
    """A concrete token path from the start state to an abstract state."""
    state_id: int
    token_ids: List[int]
    text: bytes              # the bytes the token path spells
    confirmed: bool          # fresh-decoder replay reproduced the verdict

    def __str__(self) -> str:
        return (f"state {self.state_id} via {self.token_ids} "
                f"({self.text!r}, {'confirmed' if self.confirmed else 'UNCONFIRMED'})")


@dataclasses.dataclass
class ClosureCertificate:
    """Finite-state-space certificate for the device-resident decode loop.

    When ``finite`` is True the explored graph IS the whole reachable
    quotient: ``n_states`` packed mask rows of ``mask_words`` uint32
    words each (``table_bytes`` on device) plus the recorded transition
    edges are sufficient to run decode without per-token host syncs.
    """
    finite: bool
    n_states: int
    n_edges: int
    mask_words: int          # ceil(V/32)
    table_words: int         # n_states * mask_words
    table_bytes: int         # table_words * 4
    clamp: int
    max_states: int          # the bound the exploration ran under


@dataclasses.dataclass
class DeviceGrammarTable:
    """Device-residency payload for one certified grammar.

    ``mask_table[sid]`` is state ``sid``'s packed legality bitset (the
    exact array ``DominoDecoder.mask_bits()`` returns in that state, EOS
    bit included) and ``trans[sid, tok]`` is the state reached by
    advancing ``tok`` — :data:`OFF_FRONTIER` for tokens the mask forbids
    and for EOS (an absorbing final state the loop checks explicitly).
    Uploaded once per grammar by ``ServingEngine.precompute()``; the
    scheduler's fused decode loop then gathers each row's mask from
    ``mask_table[state]`` and advances ``state = trans[state, tok]``
    entirely on device, syncing to the host only every N tokens.

    Only built from a CLEAN closure certificate (finite, zero merge
    conflicts, zero hypothesis truncations, zero trap states), so inside
    the table: every masked-argmax pick has a recorded transition, no
    reachable state has an empty mask, and the table mask is bitwise
    equal to the concrete checker's mask at the same state.

    Memory: ``n_states * ceil(V/32) * 4`` bytes of masks plus
    ``n_states * V * 4`` bytes of (dense int32) transitions.
    """
    n_states: int
    v: int                     # vocabulary size (table column count)
    eos_id: int
    clamp: int                 # abstract_key clamp the states are keyed by
    mask_table: np.ndarray     # (n_states, ceil(V/32)) uint32
    trans: np.ndarray          # (n_states, V) int32, OFF_FRONTIER sentinel
    key_to_sid: Dict[Tuple, int] = dataclasses.field(default_factory=dict,
                                                     repr=False)

    @property
    def n_bytes(self) -> int:
        return int(self.mask_table.nbytes + self.trans.nbytes)

    def sid_for(self, decoder) -> int:
        """State id of ``decoder``'s current abstract state, or
        :data:`OFF_FRONTIER` when the state is outside the table (the
        caller must then stay on / fall back to the host path)."""
        return self.key_to_sid.get(decoder.abstract_key(self.clamp),
                                   OFF_FRONTIER)


@dataclasses.dataclass
class AnalysisReport:
    grammar_name: str
    vocab_size: int
    eos_id: int
    n_terminals: int
    n_nonterminals: int
    n_rules: int
    issues: List[Issue]                  # layer 1
    alignment_gaps: List[Issue]          # layer 2 (kind="alignment-gap")
    traps: List[Witness]                 # layer 2
    non_eos_live: List[Witness]          # layer 2 (only when finite)
    closure: ClosureCertificate
    max_abstract_fanout: int             # max |hyps| over explored states
    n_merge_checks: int
    n_mask_conflicts: int                # quotient-soundness sampler
    # explored edges that overflowed the decoder's MAX_HYPOTHESES cap:
    # the grammar x vocabulary pair admits more viable token
    # segmentations than the runtime tracks, so runtime masks past such
    # an edge may silently exclude legal tokens.  Warning-level (the
    # grammar still serves), but the runtime counter
    # GenerationResult.n_hyp_truncations will fire on real traffic.
    n_hyp_truncations: int
    analysis_time_s: float
    # populated by analyze(..., emit_device_table=True) when — and only
    # when — the closure certificate is clean (finite, zero merge
    # conflicts, zero truncations, zero traps): the packed-mask +
    # transition tables the device-resident decode loop uploads
    device_table: Optional[DeviceGrammarTable] = None

    # -- verdicts ----------------------------------------------------------

    def problems(self) -> List[str]:
        """Everything that blocks ``strict`` registration."""
        out = [str(i) for i in self.issues if i.severity == "error"]
        out += [str(g) for g in self.alignment_gaps]
        out += [f"trap state: {w}" for w in self.traps]
        out += [f"not EOS-live: {w}" for w in self.non_eos_live]
        if self.n_mask_conflicts:
            out.append(
                f"quotient conflict: {self.n_mask_conflicts}/"
                f"{self.n_merge_checks} sampled merges disagreed on the "
                f"mask — the clamp={self.closure.clamp} abstraction "
                "conflates distinct states; raise clamp")
        return out

    def ok(self) -> bool:
        return not self.problems()

    def summary(self) -> str:
        c = self.closure
        lines = [
            f"grammar {self.grammar_name!r}: "
            f"{self.n_terminals} terminals, {self.n_nonterminals} "
            f"nonterminals, {self.n_rules} rules, |V|={self.vocab_size}",
            f"  closure: {'FINITE' if c.finite else 'NOT CLOSED'} under "
            f"{c.max_states} states (clamp={c.clamp}): {c.n_states} "
            f"states, {c.n_edges} edges; mask table "
            f"{c.n_states}x{c.mask_words} words = {c.table_bytes} bytes",
            f"  ambiguity: max hypothesis fan-out "
            f"{self.max_abstract_fanout}; merge checks "
            f"{self.n_merge_checks}, conflicts {self.n_mask_conflicts}",
        ]
        if self.n_hyp_truncations:
            lines.append(
                f"  [warning] hypothesis-truncation: "
                f"{self.n_hyp_truncations} explored edges overflowed "
                f"MAX_HYPOTHESES — runtime masks may be unsound on "
                f"highly ambiguous inputs (watch "
                f"GenerationResult.n_hyp_truncations)")
        for i in self.issues:
            lines.append(f"  {i}")
        for g in self.alignment_gaps:
            lines.append(f"  {g}")
        for w in self.traps:
            lines.append(f"  [error] trap: {w}")
        for w in self.non_eos_live:
            lines.append(f"  [error] not EOS-live: {w}")
        lines.append(
            f"  verdict: {'OK' if self.ok() else 'FAIL'} "
            f"({self.analysis_time_s:.2f}s)")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """JSON-safe dump (bytes witnesses become latin-1 strings)."""
        def wit(w: Witness) -> dict:
            return {"state_id": w.state_id, "token_ids": list(w.token_ids),
                    "text": w.text.decode("latin-1"),
                    "confirmed": w.confirmed}
        return {
            "grammar": self.grammar_name,
            "vocab_size": self.vocab_size,
            "eos_id": self.eos_id,
            "n_terminals": self.n_terminals,
            "n_nonterminals": self.n_nonterminals,
            "n_rules": self.n_rules,
            "issues": [dataclasses.asdict(i) for i in self.issues],
            "alignment_gaps": [dataclasses.asdict(g)
                               for g in self.alignment_gaps],
            "traps": [wit(w) for w in self.traps],
            "non_eos_live": [wit(w) for w in self.non_eos_live],
            "closure": dataclasses.asdict(self.closure),
            "max_abstract_fanout": self.max_abstract_fanout,
            "n_merge_checks": self.n_merge_checks,
            "n_mask_conflicts": self.n_mask_conflicts,
            "n_hyp_truncations": self.n_hyp_truncations,
            "analysis_time_s": self.analysis_time_s,
            "device_table": None if self.device_table is None else {
                "n_states": self.device_table.n_states,
                "v": self.device_table.v,
                "mask_bytes": int(self.device_table.mask_table.nbytes),
                "trans_bytes": int(self.device_table.trans.nbytes),
                "total_bytes": self.device_table.n_bytes,
            },
            "ok": self.ok(),
            "problems": self.problems(),
        }


class AnalysisError(ValueError):
    """Raised by :func:`enforce` under the ``strict`` policy."""

    def __init__(self, report: AnalysisReport, msg: str):
        super().__init__(msg)
        self.report = report


def enforce(report: AnalysisReport, policy: str) -> AnalysisReport:
    """Apply the registration policy to ``report``.

    ``off``: no-op.  ``warn``: problems become one RuntimeWarning.
    ``strict``: problems raise :class:`AnalysisError` (callers run this
    BEFORE registering, so a strict failure registers nothing).
    """
    if policy not in POLICIES:
        raise ValueError(f"analysis policy must be one of {POLICIES}, "
                         f"got {policy!r}")
    if policy == "off":
        return report
    problems = report.problems()
    if problems:
        msg = (f"grammar {report.grammar_name!r} failed static analysis "
               f"({len(problems)} problem(s)):\n  " + "\n  ".join(problems))
        if policy == "strict":
            raise AnalysisError(report, msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    return report


# ---------------------------------------------------------------------------
# layer 1: CFG / lexer
# ---------------------------------------------------------------------------


def _dfa_minus_nonempty(a: DFA, b: DFA) -> bool:
    """Is ``L(a) \\ L(b)`` nonempty?  Product BFS where ``b`` may fall
    into its (pruned) dead sink, represented as None."""
    start = (a.start, b.start)
    seen = {start}
    stack = [start]
    while stack:
        sa, sb = stack.pop()
        if a.is_accept(sa) and (sb is None or not b.is_accept(sb)):
            return True
        for byte, na in a.trans[sa].items():
            nb = None if sb is None else b.trans[sb].get(byte)
            pair = (na, nb)
            if pair not in seen:
                seen.add(pair)
                stack.append(pair)
    return False


def dfa_subset(a: DFA, b: DFA) -> bool:
    """L(a) ⊆ L(b)."""
    return not _dfa_minus_nonempty(a, b)


def _cycle_nodes(edges: Dict[int, Set[int]]) -> Set[int]:
    """Nodes that lie on a directed cycle (node reaches itself)."""
    # transitive closure by per-node DFS; grammars are small
    on_cycle: Set[int] = set()
    for n0 in edges:
        stack = list(edges.get(n0, ()))
        seen: Set[int] = set()
        while stack:
            n = stack.pop()
            if n == n0:
                on_cycle.add(n0)
                break
            if n in seen:
                continue
            seen.add(n)
            stack.extend(edges.get(n, ()))
    return on_cycle


def reachable_nonterminals(g: Grammar) -> Tuple[Set[int], Set[int]]:
    """(reachable nonterminal ids, terminal ids referenced by a reachable
    rule)."""
    reach = {g.start}
    stack = [g.start]
    terms: Set[int] = set()
    while stack:
        n = stack.pop()
        for ri in g.rules_by_lhs.get(n, []):
            for s in g.rules[ri].rhs:
                if is_terminal(s):
                    terms.add(s)
                elif nt_id(s) not in reach:
                    reach.add(nt_id(s))
                    stack.append(nt_id(s))
    return reach, terms


def empty_terminals(g: Grammar) -> Set[int]:
    """Terminal ids whose regex denotes the EMPTY language (the compiled
    DFA has no accepting state — ``grammar.py`` rejects empty-*string*
    matchers at parse time but cannot see empty-*language* patterns)."""
    return {tid for tid, t in enumerate(g.terminals) if not t.dfa.accepts}


def productive_nonterminals(g: Grammar,
                            dead_terms: Optional[Set[int]] = None
                            ) -> Set[int]:
    """Nonterminals that derive at least one finite terminal string
    (terminals with an empty language count as underivable)."""
    dead = empty_terminals(g) if dead_terms is None else dead_terms
    prod: Set[int] = set()
    changed = True
    while changed:
        changed = False
        for r in g.rules:
            if r.lhs in prod:
                continue
            if all((s not in dead) if is_terminal(s) else (nt_id(s) in prod)
                   for s in r.rhs):
                prod.add(r.lhs)
                changed = True
    return prod


def analyze_static(g: Grammar) -> List[Issue]:
    """Layer 1: symbol-level verification of the CFG + lexer."""
    issues: List[Issue] = []
    dead = empty_terminals(g)
    reach, used_terms = reachable_nonterminals(g)
    prod = productive_nonterminals(g, dead)

    for tid in sorted(dead):
        if tid in used_terms or tid in g.ignore:
            issues.append(Issue(
                "empty-terminal", "error", g.terminal_name(tid),
                "regex denotes the empty language — no byte string can "
                "ever match; every production requiring it is a "
                "guaranteed trap"))
    for n in range(g.n_nonterminals):
        if n not in reach:
            issues.append(Issue(
                "unreachable-nonterminal", "warning",
                g.nonterminal_names[n],
                "never derivable from the start symbol (dead rules)"))
    for tid in range(g.n_terminals):
        if tid not in used_terms and tid not in g.ignore \
                and tid not in dead:
            issues.append(Issue(
                "unused-terminal", "warning", g.terminal_name(tid),
                "referenced by no reachable rule and not %ignore'd — the "
                "scanner still forks hypotheses on every match"))
    for n in sorted(reach):
        if n not in prod:
            issues.append(Issue(
                "unproductive-nonterminal", "error",
                g.nonterminal_names[n],
                "derives no finite terminal string; any decode entering "
                "it can never reach EOS"))

    # %ignore shadowing: a parser-visible terminal whose WHOLE language is
    # also skippable forks the hypothesis set on every occurrence (the
    # scanner keeps both the emit and the ignore branch).
    for tid in sorted(used_terms - dead):
        if tid in g.ignore:
            continue
        for iid in g.ignore:
            if iid in dead:
                continue
            if dfa_subset(g.terminals[tid].dfa, g.terminals[iid].dfa):
                issues.append(Issue(
                    "ignore-shadowed-terminal", "warning",
                    g.terminal_name(tid),
                    f"its whole language is also matched by %ignore "
                    f"terminal {g.terminal_name(iid)} — every occurrence "
                    "doubles the hypothesis fan-out (emit vs skip)"))
                break

    # Left recursion through nullable prefixes: A -> α B ... with α
    # nullable puts B at the leftmost derivation frontier of A.
    ledges: Dict[int, Set[int]] = {n: set() for n in range(g.n_nonterminals)}
    for r in g.rules:
        for s in r.rhs:
            if is_terminal(s):
                break
            ledges[r.lhs].add(nt_id(s))
            if nt_id(s) not in g.nullable:
                break
    for n in sorted(_cycle_nodes(ledges) & reach):
        issues.append(Issue(
            "left-recursion", "info", g.nonterminal_names[n],
            "left-recursive — Earley handles it, but chart item sets "
            "grow with nesting depth; the abstract closure may need a "
            "larger origin clamp to stay finite"))

    # Nullable cycles: A =>+ A consuming nothing — infinitely many
    # derivations of the empty string through A (ambiguity blow-up).
    nedges: Dict[int, Set[int]] = {n: set() for n in range(g.n_nonterminals)}
    for r in g.rules:
        if r.rhs and all((not is_terminal(s)) and nt_id(s) in g.nullable
                         for s in r.rhs):
            for s in r.rhs:
                nedges[r.lhs].add(nt_id(s))
    for n in sorted(_cycle_nodes(nedges) & reach):
        issues.append(Issue(
            "nullable-cycle", "warning", g.nonterminal_names[n],
            "derives itself while producing nothing — infinitely "
            "ambiguous epsilon derivations inflate Earley completion "
            "work at every position"))
    return issues


# ---------------------------------------------------------------------------
# layer 2: grammar x vocabulary
# ---------------------------------------------------------------------------


def spellable_terminals(g: Grammar, tc: TreeCache) -> Set[int]:
    """Terminal ids some vocabulary token SEQUENCE can emit to the
    parser: the union of subterminal-tree emission-edge labels over every
    reachable scanner position, plus EOS-boundary emissions.  Ignore
    terminals are excluded (their emissions are collapsed before the
    parser ever sees them)."""
    tc.precompute()                      # builds trees for all positions
    out: Set[int] = set()
    for pos, tree in tc.trees.items():
        stack = [tree.root]
        while stack:
            node = stack.pop()
            for t, child in node.children.items():
                out.add(t)
                stack.append(child)
        for ems, _clean in tc.scanner.final_branches(pos):
            out.update(ems)
    return out


def alignment_gap_issues(g: Grammar, tc: TreeCache,
                         vocab: Sequence[Optional[bytes]]) -> List[Issue]:
    """Terminals a reachable rule needs but NO token sequence of this
    vocabulary can spell (empty-language terminals are layer-1 findings
    and excluded here)."""
    _reach, used = reachable_nonterminals(g)
    dead = empty_terminals(g)
    spell = spellable_terminals(g, tc)
    vocab_bytes = {b for tokdata in vocab if tokdata for b in tokdata}
    out: List[Issue] = []
    for tid in sorted(used - dead):
        if tid in g.ignore or tid in spell:
            continue
        dfa = g.terminals[tid].dfa
        missing = sorted(b for b in dfa.first_bytes(dfa.start)
                         if b not in vocab_bytes)
        hint = (f"; e.g. no token contains the start byte(s) "
                f"{[chr(b) if 32 <= b < 127 else hex(b) for b in missing[:8]]}"
                if missing else "")
        out.append(Issue(
            "alignment-gap", "error", g.terminal_name(tid),
            f"pattern {g.terminals[tid].pattern!r} cannot be spelled by "
            f"any token sequence of this vocabulary — productions "
            f"requiring it are unreachable at decode time{hint}"))
    return out


@dataclasses.dataclass
class Exploration:
    """Raw layer-2 BFS result (pre-report)."""
    finite: bool
    n_states: int
    n_edges: int
    eos_ok: Dict[int, bool]
    empty_mask: Dict[int, bool]
    paths: Dict[int, List[int]]
    rev_edges: Dict[int, Set[int]]
    max_fanout: int
    n_merge_checks: int
    n_mask_conflicts: int
    # edges whose advance() overflowed MAX_HYPOTHESES and truncated the
    # hypothesis set: runtime masks beyond such an edge may be UNSOUND
    # (legal tokens silently excluded)
    n_hyp_truncations: int
    # forward transition structure (the device-table feedstock):
    # edges[sid][tok] = successor state id for every explored
    # (mask-legal, non-EOS) edge; masks[sid] = the representative's
    # packed mask row (a reference to the memoized read-only array);
    # key_ids = abstract key -> state id
    edges: Dict[int, Dict[int, int]] = dataclasses.field(
        default_factory=dict)
    masks: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    key_ids: Dict[Tuple, int] = dataclasses.field(default_factory=dict)


def explore_decoder(g: Grammar, vocab: Sequence[Optional[bytes]],
                    eos_id: int, tree_cache: Optional[TreeCache] = None,
                    clamp: int = DEFAULT_CLAMP,
                    max_states: int = DEFAULT_MAX_STATES) -> Exploration:
    """Exhaustive BFS over the abstract decoder state space.

    Each abstract key keeps its FIRST concrete decoder as representative;
    masks/transitions are computed on representatives via the real packed
    bitset walk, so witnesses are concrete by construction.  BFS order
    makes every recorded path a shortest witness (in tokens).
    """
    v = len(vocab)
    root = DominoDecoder(g, list(vocab), eos_id, tree_cache=tree_cache)
    ids: Dict[Tuple, int] = {root.abstract_key(clamp): 0}
    reps: Dict[int, DominoDecoder] = {0: root}
    paths: Dict[int, List[int]] = {0: []}
    eos_ok: Dict[int, bool] = {}
    empty_mask: Dict[int, bool] = {}
    rev: Dict[int, Set[int]] = collections.defaultdict(set)
    fwd: Dict[int, Dict[int, int]] = collections.defaultdict(dict)
    masks: Dict[int, np.ndarray] = {}
    queue = collections.deque([0])
    finite = True
    n_edges = 0
    max_fanout = 1
    n_checks = 0
    n_conflicts = 0
    n_merges = 0
    n_truncs = 0
    with warnings.catch_warnings():
        # truncation warns once per decoder; the BFS clones thousands of
        # decoders, so the per-request warning becomes spam here — the
        # count is surfaced in the report instead
        warnings.simplefilter("ignore", RuntimeWarning)
        while queue:
            sid = queue.popleft()
            d = reps[sid]
            max_fanout = max(max_fanout, len(d.hyps))
            bits = d.mask_bits()
            masks[sid] = bits          # shared read-only memo reference
            eos_ok[sid] = bitmask.get_bit(bits, eos_id)
            legal = bitmask.to_ids(bits, v)
            empty_mask[sid] = legal.size == 0
            for tok in legal:
                tok = int(tok)
                if tok == eos_id:
                    continue         # edge into the absorbing final state
                d2 = d.clone()
                if not d2.advance(tok):
                    # mask bit set but advance refused: decoder-internal
                    # mask/transition disagreement — count, never hide
                    n_conflicts += 1
                    continue
                if d2.n_hyp_truncations > d.n_hyp_truncations:
                    n_truncs += 1
                key2 = d2.abstract_key(clamp)
                tid = ids.get(key2)
                if tid is None:
                    if len(ids) >= max_states:
                        finite = False
                        continue         # frontier clipped by the bound
                    tid = len(ids)
                    ids[key2] = tid
                    reps[tid] = d2
                    paths[tid] = paths[sid] + [tok]
                    queue.append(tid)
                else:
                    n_merges += 1
                    if n_merges % MERGE_CHECK_STRIDE == 0:
                        # quotient-soundness sampling: the arriving
                        # concrete state must agree with the
                        # representative's mask
                        n_checks += 1
                        if not np.array_equal(d2.mask_bits(),
                                              reps[tid].mask_bits()):
                            n_conflicts += 1
                rev[tid].add(sid)
                fwd[sid][tok] = tid
                n_edges += 1
    return Exploration(finite=finite, n_states=len(ids), n_edges=n_edges,
                       eos_ok=eos_ok, empty_mask=empty_mask, paths=paths,
                       rev_edges=dict(rev), max_fanout=max_fanout,
                       n_merge_checks=n_checks,
                       n_mask_conflicts=n_conflicts,
                       n_hyp_truncations=n_truncs,
                       edges=dict(fwd), masks=masks, key_ids=dict(ids))


def build_device_table(ex: Exploration, v: int, eos_id: int,
                       clamp: int) -> Optional[DeviceGrammarTable]:
    """Assemble the :class:`DeviceGrammarTable` from an exploration —
    or refuse (return None) unless the closure certificate is CLEAN:

     - ``finite`` — the explored graph is the whole reachable quotient
       (a clipped frontier would make OFF_FRONTIER lie);
     - zero mask conflicts — no explored merge arrived with a mask
       different from its representative's;
     - zero hypothesis truncations — no explored edge overflowed
       MAX_HYPOTHESES, so no mask in the table is potentially unsound;
     - zero trap states — the fused loop's masked argmax always has at
       least one legal token to pick (dead ends would otherwise need
       in-loop detection that the host path handles explicitly).

    Every non-EOS token a table mask allows has a recorded transition,
    so a table walk can only stop at EOS, budget, or an OFF_FRONTIER
    edge — which never appears under a clean certificate.

    SCOPE OF THE CERTIFICATE: the key quotient is an *abstraction* — the
    clamped relative signature deliberately folds state a context-free
    grammar can keep unbounded (e.g. JSON's bracket-nesting stack), so a
    finite table cannot be exact in general.  "Zero mask conflicts"
    certifies every merge the BFS *observed*, not bisimilarity: a
    concrete trajectory can eventually reach a state whose mask differs
    from its table row (a QUOTIENT ESCAPE).  Consumers must therefore
    (a) validate every table-selected token against the concrete checker
    (``advance`` returning False is a certificate violation, never to be
    committed silently), and (b) periodically audit the table mask row
    against the concrete mask, demoting escaped rows to the exact host
    path — the serving scheduler does both, bounding any divergence from
    the host path to one audit interval while output stays
    grammar-valid unconditionally."""
    clean = (ex.finite and ex.n_mask_conflicts == 0
             and ex.n_hyp_truncations == 0
             and not any(ex.empty_mask.values()))
    if not clean or not ex.masks:
        return None
    w = bitmask.n_words(v)
    mask_table = np.zeros((ex.n_states, w), np.uint32)
    trans = np.full((ex.n_states, v), OFF_FRONTIER, np.int32)
    for sid in range(ex.n_states):
        mask_table[sid] = ex.masks[sid]
        for tok, tid in ex.edges.get(sid, {}).items():
            trans[sid, tok] = tid
    return DeviceGrammarTable(n_states=ex.n_states, v=v, eos_id=eos_id,
                              clamp=clamp, mask_table=mask_table,
                              trans=trans, key_to_sid=dict(ex.key_ids))


def _replay_trap(g: Grammar, vocab: Sequence[Optional[bytes]], eos_id: int,
                 tokens: List[int],
                 tree_cache: Optional[TreeCache]) -> bool:
    """Replay a witness path through a FRESH decoder: True iff every
    advance succeeds and the final state is a runtime dead end (empty
    mask, EOS illegal) — i.e. the abstract trap is concretely real."""
    d = DominoDecoder(g, list(vocab), eos_id, tree_cache=tree_cache)
    for t in tokens:
        if not d.advance(t):
            return False
    bits = d.mask_bits()
    return not bits.any()


def _witness_text(vocab: Sequence[Optional[bytes]],
                  tokens: List[int]) -> bytes:
    return b"".join(vocab[t] or b"" for t in tokens)


def analyze(g: Grammar, vocab: Sequence[Optional[bytes]], eos_id: int,
            name: str = "<anonymous>",
            tree_cache: Optional[TreeCache] = None,
            clamp: int = DEFAULT_CLAMP,
            max_states: int = DEFAULT_MAX_STATES,
            max_witnesses: int = 16,
            emit_device_table: bool = False) -> AnalysisReport:
    """Run both analysis layers and assemble the :class:`AnalysisReport`.

    ``tree_cache`` should be the grammar's registry-shared cache when
    called from the engine, so the trees built here are the SAME trees
    serving later uses (the analysis doubles as the precompute warm-up).
    ``max_witnesses`` caps how many trap / non-live witnesses are
    materialized (the counts are always exact).
    ``emit_device_table`` additionally assembles the
    :class:`DeviceGrammarTable` from the exploration (clean certificates
    only — see :func:`build_device_table`); it is opt-in because the
    dense ``(n_states, V)`` transition table costs ``n_states * V * 4``
    bytes of host memory that pure diagnostics never need.
    """
    t0 = time.perf_counter()
    issues = analyze_static(g)
    tc = tree_cache if tree_cache is not None else TreeCache(
        Scanner(g), list(vocab))
    gaps = alignment_gap_issues(g, tc, vocab)
    ex = explore_decoder(g, vocab, eos_id, tree_cache=tc, clamp=clamp,
                         max_states=max_states)

    traps: List[Witness] = []
    trap_ids = [sid for sid in sorted(ex.empty_mask)
                if ex.empty_mask[sid]]
    for sid in trap_ids[:max_witnesses]:
        path = ex.paths[sid]
        traps.append(Witness(
            state_id=sid, token_ids=path,
            text=_witness_text(vocab, path),
            confirmed=_replay_trap(g, vocab, eos_id, path, tc)))

    non_live: List[Witness] = []
    if ex.finite:
        # reverse reachability from every EOS-legal state; anything
        # outside is a liveness hole.  Traps are reported above, not
        # double-reported here.
        live = {sid for sid, ok in ex.eos_ok.items() if ok}
        stack = list(live)
        while stack:
            sid = stack.pop()
            for prev in ex.rev_edges.get(sid, ()):
                if prev not in live:
                    live.add(prev)
                    stack.append(prev)
        hole_ids = [sid for sid in sorted(ex.eos_ok)
                    if sid not in live and not ex.empty_mask[sid]]
        for sid in hole_ids[:max_witnesses]:
            path = ex.paths[sid]
            non_live.append(Witness(
                state_id=sid, token_ids=path,
                text=_witness_text(vocab, path),
                # replay confirms reachability of the state, not the
                # (graph-global) liveness claim itself
                confirmed=True))

    words = bitmask.n_words(len(vocab))
    cert = ClosureCertificate(
        finite=ex.finite, n_states=ex.n_states, n_edges=ex.n_edges,
        mask_words=words, table_words=ex.n_states * words,
        table_bytes=ex.n_states * words * 4, clamp=clamp,
        max_states=max_states)
    return AnalysisReport(
        grammar_name=name, vocab_size=len(vocab), eos_id=eos_id,
        n_terminals=g.n_terminals, n_nonterminals=g.n_nonterminals,
        n_rules=len(g.rules), issues=issues, alignment_gaps=gaps,
        traps=traps, non_eos_live=non_live, closure=cert,
        max_abstract_fanout=ex.max_fanout,
        n_merge_checks=ex.n_merge_checks,
        n_mask_conflicts=ex.n_mask_conflicts,
        n_hyp_truncations=ex.n_hyp_truncations,
        device_table=(build_device_table(ex, len(vocab), eos_id, clamp)
                      if emit_device_table else None),
        analysis_time_s=time.perf_counter() - t0)
