"""DOMINO constrained decoder (§3.5, Algorithm 1).

The decoder maintains a set of *hypotheses* — pairs ``(parser, scanner
position)`` — one per surviving segmentation of the generated byte string
into grammar terminals (lexical ambiguity and emit-vs-continue branches can
temporarily diverge; the grammar prunes them).  Against each hypothesis it
walks the precomputed subterminal tree ``T_q`` to produce the token mask.

Key knobs (paper §3.5-§3.6):
 - ``k`` — the lookahead depth: tokens whose subterminal sequence contains
   at most ``k+1`` parser-visible terminals are considered.  ``k=0`` is
   already sound; ``k=None`` (∞) walks whole trees and is *minimally
   invasive* (Def. 2.1).
 - ``check_token`` — opportunistic masking: validate a model-proposed token
   directly (O(token length)) without computing the full mask.
"""
from __future__ import annotations

import math
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import bitmask
from repro_torch.core.earley import EarleyParser
from repro_torch.core.grammar import Grammar
from repro_torch.core.scanner import FRESH, Scanner
from repro_torch.core.trees import TreeCache, TreeNode

MAX_HYPOTHESES = 64


class DominoDecoder:
    """One decoding session.  Not thread-safe; clone() for speculation."""

    def __init__(self, grammar: Grammar, vocab: Sequence[Optional[bytes]],
                 eos_id: int, k: Optional[int] = None,
                 tree_cache: Optional[TreeCache] = None):
        self.g = grammar
        self.vocab = list(vocab)
        self.eos_id = eos_id
        self.k = math.inf if k is None else k
        self.scanner = (tree_cache.scanner if tree_cache is not None
                        else Scanner(grammar))
        self.trees = tree_cache or TreeCache(self.scanner, self.vocab)
        # hypotheses: list of (EarleyParser, position)
        self.hyps: List[Tuple[EarleyParser, object]] = [
            (EarleyParser(grammar), FRESH)]
        self.finished = False
        self.n_interventions = 0  # steps where the mask rejected argmax
        self.n_mask_memo_hits = 0  # mask_bits() served from trees.mask_memo
        # soundness accounting: advance() caps the surviving segmentation
        # set at MAX_HYPOTHESES; every cap event silently drops viable
        # hypotheses (the decoder may later report a false dead end or an
        # under-full mask).  Count the events instead of hiding them.
        self.n_hyp_truncations = 0
        self.max_hyp_fanout = 1   # peak |hyps| observed (ambiguity report)
        self._warned_truncation = False

    # -- lifecycle -----------------------------------------------------------

    def clone(self) -> "DominoDecoder":
        d = DominoDecoder.__new__(DominoDecoder)
        d.g = self.g
        d.vocab = self.vocab
        d.eos_id = self.eos_id
        d.k = self.k
        d.scanner = self.scanner
        d.trees = self.trees            # shared, read-mostly cache
        d.hyps = [(p.fork(), pos) for (p, pos) in self.hyps]
        d.finished = self.finished
        d.n_interventions = self.n_interventions
        d.n_mask_memo_hits = self.n_mask_memo_hits
        d.n_hyp_truncations = self.n_hyp_truncations
        d.max_hyp_fanout = self.max_hyp_fanout
        d._warned_truncation = self._warned_truncation
        return d

    def snapshot(self) -> "DominoDecoder":
        """A clone with per-session counters zeroed: the fork-point form
        stored by the serving prefix cache.  State (hypothesis set,
        finished flag) is preserved exactly — it is a pure function of
        the tokens advanced, so a request adopting the snapshot behaves
        bitwise-identically to one that replayed the prefix through
        ``advance()`` — while accounting (interventions, memo hits,
        truncations) restarts at zero so per-row attribution stays
        per-row."""
        d = self.clone()
        d.n_interventions = 0
        d.n_mask_memo_hits = 0
        d.n_hyp_truncations = 0
        d.max_hyp_fanout = max(1, len(d.hyps))
        d._warned_truncation = False
        return d

    def reset(self) -> None:
        self.hyps = [(EarleyParser(self.g), FRESH)]
        self.finished = False
        self.n_interventions = 0
        self.n_mask_memo_hits = 0
        self.n_hyp_truncations = 0
        self.max_hyp_fanout = 1
        self._warned_truncation = False

    # -- Algorithm 1 interface ------------------------------------------------

    def mask(self, k: Optional[int] = None) -> np.ndarray:
        """Boolean mask over the vocabulary of legal next tokens."""
        return bitmask.unpack(self.mask_bits(k), len(self.vocab))

    def mask_bits(self, k: Optional[int] = None) -> np.ndarray:
        """Packed (ceil(V/32),) uint32 mask of legal next tokens — the
        pipeline's native form (tree segments -> scheduler staging row ->
        fused kernel, no bool materialization in between).

        Memoized on the shared TreeCache keyed by the full hypothesis
        state: grammar states are immutable, so a recurring state (e.g.
        JSON ``after-","-expecting-key``) is a dict lookup instead of a
        tree walk.  The returned array is read-only and shared; callers
        must copy before mutating.
        """
        kk = self.k if k is None else k
        if self.finished:
            return np.zeros(self.trees.n_mask_words, np.uint32)
        key = self._memo_key(kk)
        memo = self.trees.mask_memo
        cached = memo.get(key)
        if cached is not None:
            self.n_mask_memo_hits += 1
            # cache-wide aggregate: the memo lives on the SHARED
            # TreeCache, so hits here count cross-session sharing too
            # (request B hitting a state request A built)
            self.trees.n_memo_hits += 1
            memo.move_to_end(key)          # LRU: a hit re-marks the entry
            return cached
        acc = np.zeros(self.trees.n_mask_words, np.uint32)
        for parser, pos in self.hyps:
            self._mask_bits_one(parser, pos, kk, acc)
        if self.eos_legal():
            bitmask.set_bit(acc, self.eos_id)
        acc.flags.writeable = False        # memo rows are shared
        while len(memo) >= self.trees.mask_memo_max:
            memo.popitem(last=False)       # LRU: least-recently-used first
        memo[key] = acc
        return acc

    def _memo_key(self, kk) -> Tuple:
        """Exact digest of everything mask_bits() depends on.  Per
        hypothesis: the whole-history chart fingerprint (equal
        fingerprints mean identical future parser behaviour — the same
        property the hypothesis dedup relies on) plus the scanner
        position.  ``eos_id`` is part of the key because the EOS bit is
        baked into the memoized row and the memo is shared cache-wide.
        NOT state_key(): that digests only the first hypothesis via the
        current item set, which is too coarse to key an exact-mask
        cache."""
        return (kk, self.eos_id, tuple((p.chart_fingerprint(), pos)
                                       for p, pos in self.hyps))

    def _mask_bits_one(self, parser: EarleyParser, pos, k,
                       acc: np.ndarray) -> None:
        """OR the packed bitset segments of the visited tree nodes into
        ``acc`` — same walk as ``_mask_one``, no per-token scatters."""
        tree = self.trees.tree(pos)
        ignore = self.scanner.ignore

        def visit(node: TreeNode, p: EarleyParser, depth: int) -> None:
            if node.fresh_bits is not None and depth <= k + 1:
                np.bitwise_or(acc, node.fresh_bits, out=acc)
            if depth <= k:
                for tids, bits in node.partial_bits.items():
                    if any(t in ignore or p.can_accept(t) for t in tids):
                        np.bitwise_or(acc, bits, out=acc)
            if depth >= k + 1:
                return
            for t, child in node.children.items():
                if not p.can_accept(t):
                    continue
                p2 = p.fork()
                p2.advance(t)
                visit(child, p2, depth + 1)

        visit(tree.root, parser, 0)

    def mask_dense(self, k: Optional[int] = None) -> np.ndarray:
        """The pre-bitset scatter walk (bool out, per-token fancy-index
        writes).  Kept as the oracle for parity tests and as the
        ``mask_bench`` baseline; not used on the serving path."""
        kk = self.k if k is None else k
        out = np.zeros(len(self.vocab), dtype=bool)
        if self.finished:
            return out
        for parser, pos in self.hyps:
            self._mask_one(parser, pos, kk, out)
        if self.eos_legal():
            out[self.eos_id] = True
        return out

    def _mask_one(self, parser: EarleyParser, pos, k, out: np.ndarray) -> None:
        tree = self.trees.tree(pos)
        ignore = self.scanner.ignore

        def visit(node: TreeNode, p: EarleyParser, depth: int) -> None:
            # Depth accounting (§3.4): every parser-visible emission is one
            # tree level; a trailing *partial* subterminal (START/CONT of a
            # new terminal) counts as one more level, except the free
            # continuation of the current terminal at the root.
            if node.tokens_fresh and depth <= k + 1:
                out[node.tokens_fresh] = True
            if depth <= k:
                for tids, toks in node.tokens_partial.items():
                    if any(t in ignore or p.can_accept(t) for t in tids):
                        out[toks] = True
            if depth >= k + 1:
                return
            for t, child in node.children.items():
                if not p.can_accept(t):
                    continue
                p2 = p.fork()
                p2.advance(t)
                visit(child, p2, depth + 1)

        visit(tree.root, parser, 0)

    def eos_legal(self) -> bool:
        if self.finished:
            return False
        for parser, pos in self.hyps:
            for ems, _clean in self.scanner.final_branches(pos):
                p = parser
                ok = True
                for t in ems:
                    if t in self.scanner.ignore:
                        continue
                    p = p.fork()
                    ok = p.advance(t)
                    if not ok:
                        break
                if ok and p.accepts():
                    return True
        return False

    def check_token(self, token_id: int) -> bool:
        """Opportunistic masking: is this single token legal right now?

        Does NOT advance state.  O(|token| * branches) — no tree walk, no
        full-vocabulary mask.
        """
        if self.finished:
            return False
        if token_id == self.eos_id:
            return self.eos_legal()
        return bool(self._advance_hyps(token_id, dry_run=True))

    def advance(self, token_id: int) -> bool:
        """Commit a token.  Returns False (state unchanged) if illegal."""
        if self.finished:
            return False
        if token_id == self.eos_id:
            if self.eos_legal():
                self.finished = True
                return True
            return False
        new_hyps = self._advance_hyps(token_id, dry_run=False)
        if not new_hyps:
            return False
        if len(new_hyps) > MAX_HYPOTHESES:
            # Truncation drops viable segmentations: from here on the
            # decoder is an UNDER-approximation (it may reject legal
            # continuations / report a false dead end).  Never silent.
            self.n_hyp_truncations += 1
            if not self._warned_truncation:
                self._warned_truncation = True
                warnings.warn(
                    f"DominoDecoder: hypothesis set hit MAX_HYPOTHESES="
                    f"{MAX_HYPOTHESES} ({len(new_hyps)} viable "
                    f"segmentations); dropping the tail loses soundness "
                    f"for this request (counted in n_hyp_truncations)",
                    RuntimeWarning, stacklevel=2)
        self.hyps = new_hyps[:MAX_HYPOTHESES]
        self.max_hyp_fanout = max(self.max_hyp_fanout, len(self.hyps))
        return True

    # -- internals -------------------------------------------------------------

    def _advance_hyps(self, token_id: int, dry_run: bool):
        data = self.vocab[token_id]
        if data is None or len(data) == 0:
            return []
        ignore = self.scanner.ignore
        new_hyps = []
        seen = set()
        for parser, pos in self.hyps:
            for ems, fpos in self.scanner.traverse_token(pos, data):
                p = parser
                ok = True
                for t in ems:
                    if t in ignore:
                        continue
                    p = p.fork()
                    ok = p.advance(t)
                    if not ok:
                        break
                if not ok:
                    continue
                if fpos is not FRESH:
                    # The open partial terminal must still be acceptable (or
                    # ignorable) for this branch to be viable.
                    viable = frozenset(
                        (t, s) for (t, s) in fpos
                        if t in ignore or p.can_accept(t))
                    if not viable:
                        continue
                    fpos = viable
                if dry_run:
                    return [True]
                key = (p.chart_fingerprint(), fpos)
                if key in seen:
                    continue
                seen.add(key)
                new_hyps.append((p, fpos))
        return new_hyps

    # -- introspection ----------------------------------------------------------

    def state_key(self) -> Tuple:
        """(α, β) digest for the speculative count model (§3.6): the scanner
        subterminal candidates + a parser item-set signature of the first
        hypothesis."""
        parser, pos = self.hyps[0]
        alpha = FRESH if pos is FRESH else frozenset(t for (t, _s) in pos)
        beta = parser.state_signature()
        return (alpha, beta)

    def abstract_key(self, clamp: int = 8) -> Tuple:
        """Finite-quotient digest of the full decoder state: the frozenset
        over hypotheses of (position-relative parser signature, scanner
        position).  This is the key the static analyzer
        (:mod:`repro_torch.core.analysis`) enumerates the reachable state space
        on, and the state id a device-resident mask/transition table would
        be indexed by.  Same caveat as
        :meth:`~repro_torch.core.earley.EarleyParser.rel_signature`: equal keys
        abstract away chart context beyond the clamp horizon."""
        return (self.finished,
                frozenset((p.rel_signature(clamp), pos)
                          for p, pos in self.hyps))

    def legal_tokens(self, k: Optional[int] = None) -> np.ndarray:
        """Ascending ids of the currently legal tokens (EOS included when
        legal) — signature-keyed transition enumeration for the analyzer
        and for table-upload consumers, straight off the packed mask."""
        return bitmask.to_ids(self.mask_bits(k), len(self.vocab))

    @property
    def device_trackable(self) -> bool:
        """True when this decoder's state can be tracked by a precomputed
        :class:`~repro_torch.core.analysis.DeviceGrammarTable`.  Requires
        unbounded lookahead (``k == math.inf``): the analyzer enumerates
        the quotient with full-mask semantics, so a k-limited decoder
        (naive mode, bounded-k DOMINO) would disagree with the table's
        masks even at the very same abstract state.  Subclasses
        (prefix-healed decoders) override hypothesis handling and are
        never trackable — callers must ALSO require the concrete type to
        be exactly ``DominoDecoder``."""
        return self.k == math.inf

    def positions(self) -> List[object]:
        return [pos for (_p, pos) in self.hyps]


def apply_mask(logits: np.ndarray, mask: np.ndarray,
               neg: float = -1e30) -> np.ndarray:
    """Reference host-side mask application (the device-side fused version
    lives in repro_torch.kernels.masked_sample)."""
    out = np.where(mask, logits, neg)
    return out
