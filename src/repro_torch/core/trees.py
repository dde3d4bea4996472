"""Vocabulary-aligned subterminal trees (Algorithm 2, §3.3).

For every scanner position ``q`` we enumerate, for **every** vocabulary
token, the subterminal sequences it induces, and organize them into a
prefix tree ``T_q`` keyed by the *parser-relevant* (non-ignorable) terminal
emissions.  Token ids are attached to the node reached by their emission
sequence, bucketed by how the token *ends*:

 - ``tokens_fresh``     — token ends exactly on a terminal boundary;
 - ``tokens_partial``   — token ends mid-terminal; bucketed by the frozenset
   of candidate terminal ids (the parser must accept at least one of them,
   or the terminal must be ignorable, for the token to be legal).

This is the precomputed data structure that makes DOMINO's mask computation
independent of vocabulary size: at inference time we walk ``T_q`` (pruned by
the parser, bounded by the lookahead ``k``) instead of scanning |V| tokens.

Construction shares work across tokens by DFS over a byte *trie* of the
vocabulary: all tokens with a common byte prefix reuse the same scanner
branch frontier.

Each node additionally carries *packed bitset segments* of its token
buckets (``fresh_bits`` / ``partial_bits``, uint32 words in the
``core/bitmask.py`` layout), attached once at build time.  Mask assembly
then becomes a vectorized ``np.bitwise_or`` accumulation over visited
nodes — no per-token-id fancy-index scatters on the serving critical
path — and the assembled full-vocabulary masks are memoized on the cache
(``mask_memo``), keyed by the decoder's immutable hypothesis state, so a
recurring grammar state is a dict lookup.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core import bitmask
from repro_torch.core.scanner import FRESH, Scanner


class VocabTrie:
    """Byte trie over the vocabulary (token id -> byte string)."""

    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: Dict[int, "VocabTrie"] = {}
        self.token_ids: List[int] = []

    @classmethod
    def build(cls, vocab: List[Optional[bytes]]) -> "VocabTrie":
        root = cls()
        for tok_id, data in enumerate(vocab):
            if data is None or len(data) == 0:
                continue  # special tokens (EOS/PAD) handled by the decoder
            node = root
            for b in data:
                nxt = node.children.get(b)
                if nxt is None:
                    nxt = cls()
                    node.children[b] = nxt
                node = nxt
            node.token_ids.append(tok_id)
        return root

    def count_nodes(self) -> int:
        n = 1
        for c in self.children.values():
            n += c.count_nodes()
        return n


class TreeNode:
    __slots__ = ("children", "tokens_fresh", "tokens_partial",
                 "fresh_bits", "partial_bits")

    def __init__(self):
        self.children: Dict[int, "TreeNode"] = {}
        self.tokens_fresh: List[int] = []
        # frozenset of candidate partial-terminal ids -> token ids
        self.tokens_partial: Dict[FrozenSet[int], List[int]] = {}
        # packed (ceil(V/32),) uint32 segments of the buckets above,
        # attached by TreeCache._build once construction is done; None
        # for an empty fresh bucket (the walk guards on the list)
        self.fresh_bits: Optional[np.ndarray] = None
        self.partial_bits: Dict[FrozenSet[int], np.ndarray] = {}

    def size(self) -> int:
        n = 1
        for c in self.children.values():
            n += c.size()
        return n

    def n_tokens(self) -> int:
        n = len(self.tokens_fresh) + sum(
            len(v) for v in self.tokens_partial.values())
        for c in self.children.values():
            n += c.n_tokens()
        return n


def _step_branches(scanner: Scanner, branches, byte: int):
    """Advance every (emissions -> configuration-set) branch by one byte."""
    starts = scanner.start_moves(byte)
    ignore = scanner.ignore
    new_branches: Dict[Tuple[int, ...], set] = {}
    for ems, confs in branches.items():
        direct = set()
        emit_terminals = set()
        for conf in confs:
            if conf == ("FRESH",):
                if starts:
                    direct.update(starts)
                continue
            t, s = conf
            dfa = scanner.dfas[t]
            s2 = dfa.step(s, byte)
            if s2 is not None:
                direct.add((t, s2))
            if dfa.is_accept(s):
                emit_terminals.add(t)
        if direct:
            new_branches.setdefault(ems, set()).update(direct)
        if starts:
            for t in emit_terminals:
                key = ems if t in ignore else ems + (t,)
                new_branches.setdefault(key, set()).update(starts)
    return new_branches


class SubterminalTree:
    def __init__(self, root: TreeNode, position):
        self.root = root
        self.position = position


class TreeCache:
    """Per-position subterminal trees with lazy construction + memoization.

    ``precompute()`` runs the offline pass of the paper: BFS over all scanner
    positions reachable through any vocabulary token, building every tree.
    """

    def __init__(self, scanner: Scanner, vocab: List[Optional[bytes]]):
        self.scanner = scanner
        self.vocab = vocab
        self.trie = VocabTrie.build(vocab)
        self.trees: Dict[object, SubterminalTree] = {}
        self.build_time_s = 0.0
        # full-mask memo, shared by every decoder on this grammar: key =
        # decoder hypothesis digest (DominoDecoder._memo_key) -> packed
        # (n_mask_words,) uint32 mask.  Entries never go STALE (grammar
        # states are immutable, a key maps to exactly one mask), but the
        # whole-history fingerprint in the key makes most decode steps a
        # fresh entry, so an uncapped memo grows without bound on a
        # long-lived server (n_mask_words*4 bytes per entry — 32 KiB at
        # gemma3's V).  LRU-evict past mask_memo_max (hits re-mark their
        # entry, so recurring grammar states survive churn that a FIFO
        # would evict them under): dropping an entry only costs a
        # rebuild, never correctness.
        self.n_mask_words = bitmask.n_words(len(vocab))
        self.mask_memo: "collections.OrderedDict[object, np.ndarray]" = \
            collections.OrderedDict()
        self.mask_memo_max = 4096
        # aggregate memo hits across EVERY decoder sharing this cache —
        # the cross-session mask-sharing signal (per-decoder counts live
        # on DominoDecoder.n_mask_memo_hits and die with the session)
        self.n_memo_hits = 0
        # device-resident decode table for this grammar (attached by
        # ServingEngine.build_device_tables when the closure certificate
        # is clean): a repro_torch.core.analysis.DeviceGrammarTable, or None.
        # Kept on the cache so everything per-grammar that serving shares
        # lives in one object.
        self.device_table = None

    def tree(self, position) -> SubterminalTree:
        key = position
        t = self.trees.get(key)
        if t is None:
            t0 = time.perf_counter()
            t = self._build(position)
            self.build_time_s += time.perf_counter() - t0
            self.trees[key] = t
        return t

    def precompute(self) -> Dict[str, float]:
        """Offline pass: build trees for every reachable position.

        Returns stats (number of positions, total build seconds).
        """
        t0 = time.perf_counter()
        frontier = [FRESH]
        seen = {FRESH}
        while frontier:
            pos = frontier.pop()
            tree = self.tree(pos)
            for nxt in self._reachable_positions(tree):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return {
            "positions": float(len(self.trees)),
            "seconds": time.perf_counter() - t0,
        }

    def reachable_positions(self, position) -> Iterable[object]:
        """Scanner positions reachable from ``position`` through ONE
        vocabulary token (recorded during tree construction).  Iterating
        this from FRESH to a fixpoint enumerates the whole scanner-side
        state space — ``precompute()`` does exactly that, and the static
        analyzer (:mod:`repro_torch.core.analysis`) walks the same graph for
        its alignment-gap audit."""
        return self._reachable_positions(self.tree(position))

    def _reachable_positions(self, tree: SubterminalTree):
        # Positions are recorded during construction; see _build.
        return tree._positions  # type: ignore[attr-defined]

    def _build(self, position) -> SubterminalTree:
        scanner = self.scanner
        root = TreeNode()
        positions = set()

        def leaf_nodes(ems: Tuple[int, ...]) -> TreeNode:
            node = root
            for t in ems:
                nxt = node.children.get(t)
                if nxt is None:
                    nxt = TreeNode()
                    node.children[t] = nxt
                node = nxt
            return node

        def record(tok: int, branches) -> None:
            ignore = scanner.ignore
            seen_fresh = set()
            seen_partial = set()
            for ems, confs in branches.items():
                real = frozenset(c for c in confs if c != ("FRESH",))
                if real:
                    tids = frozenset(t for (t, _s) in real)
                    if (ems, tids) not in seen_partial:
                        seen_partial.add((ems, tids))
                        node = leaf_nodes(ems)
                        node.tokens_partial.setdefault(tids, []).append(tok)
                    positions.add(real)
                if ("FRESH",) in confs and ems not in seen_fresh:
                    seen_fresh.add(ems)
                    leaf_nodes(ems).tokens_fresh.append(tok)
                for (t, s) in real:
                    if scanner.dfas[t].is_accept(s):
                        key = ems if t in ignore else ems + (t,)
                        if key not in seen_fresh:
                            seen_fresh.add(key)
                            leaf_nodes(key).tokens_fresh.append(tok)
                            positions.add(FRESH)

        if position is FRESH:
            init = {(): {("FRESH",)}}
        else:
            init = {(): set(position)}

        def dfs(trie_node: VocabTrie, branches) -> None:
            for tok in trie_node.token_ids:
                record(tok, branches)
            for byte, child in trie_node.children.items():
                nb = _step_branches(scanner, branches, byte)
                if nb:
                    dfs(child, nb)

        dfs(self.trie, init)
        self._attach_bits(root)
        tree = SubterminalTree(root, position)
        tree._positions = positions  # type: ignore[attr-defined]
        return tree

    def _attach_bits(self, root: TreeNode) -> None:
        """Pack every node's token buckets into uint32 bitset segments
        (build-time cost, so the mask walk is pure bitwise_or)."""
        v = len(self.vocab)
        stack = [root]
        while stack:
            node = stack.pop()
            if node.tokens_fresh:
                node.fresh_bits = bitmask.pack_ids(node.tokens_fresh, v)
            node.partial_bits = {
                tids: bitmask.pack_ids(toks, v)
                for tids, toks in node.tokens_partial.items()}
            stack.extend(node.children.values())
