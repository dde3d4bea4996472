"""Token healing (§3.5 last paragraph; Lundberg & Ribeiro).

At the prompt/generation boundary the prompt's final tokens may have split
a unit the model would rather express with a bridge token (e.g. prompt ends
with ``{"`` but the model's preferred continuation token is ``{"a``).
GUIDANCE heals this by truncating the prompt to an earlier token boundary
and *forcing the stripped text as a prefix of the generation* — the model
re-tokenizes the boundary freely, bridge tokens included.

The constraint is therefore  L(G) ∩ prefix·Σ*  (the healed output must BE a
grammar string AND start with the stripped text).  ``HealedDecoder`` is the
product checker: while the prefix is being consumed, a token must (a) agree
byte-wise with the remaining prefix and (b) advance the underlying DOMINO
decoder; afterwards it delegates entirely.  The paper implements this by
recompiling the grammar with a forced prefix — the product construction
avoids the recompile (the subterminal trees are shared unchanged), which is
an improvement we record in EXPERIMENTS.md §Perf.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.domino import DominoDecoder
from repro_torch.core.grammar import Grammar
from repro_torch.core.trees import TreeCache, VocabTrie


def heal_prompt(prompt_ids: List[int], vocab: Sequence[Optional[bytes]],
                n_strip: int = 1) -> Tuple[List[int], str]:
    """Strip the last ``n_strip`` tokens off the prompt.

    Returns (truncated_prompt_ids, stripped_text).
    """
    if n_strip <= 0 or len(prompt_ids) == 0:
        return list(prompt_ids), ""
    n_strip = min(n_strip, len(prompt_ids))
    kept = list(prompt_ids[:-n_strip])
    stripped = b"".join(vocab[t] or b"" for t in prompt_ids[-n_strip:])
    return kept, stripped.decode("utf-8", errors="surrogateescape")


class HealedDecoder:
    """DOMINO decoder whose output is additionally forced to start with
    ``prefix_text``.  API-compatible subset of DominoDecoder (mask /
    check_token / advance / eos_legal)."""

    def __init__(self, grammar: Grammar, vocab: Sequence[Optional[bytes]],
                 eos_id: int, prefix_text: str,
                 k: Optional[int] = None,
                 tree_cache: Optional[TreeCache] = None):
        self.inner = DominoDecoder(grammar, vocab, eos_id, k=k,
                                   tree_cache=tree_cache)
        self.vocab = list(vocab)
        self.eos_id = eos_id
        self.rest = prefix_text.encode("utf-8")
        self._trie = self.inner.trees.trie

    # -- helpers ---------------------------------------------------------------

    def _prefix_ok(self, data: bytes) -> bool:
        n = min(len(data), len(self.rest))
        return data[:n] == self.rest[:n]

    def _candidates(self) -> List[int]:
        """Tokens compatible with the remaining forced prefix."""
        out: List[int] = []
        node = self._trie
        # tokens that are a prefix of rest
        for b in self.rest:
            node = node.children.get(b)
            if node is None:
                break
            out.extend(node.token_ids)
        else:
            # tokens that extend past the full rest (bridge over boundary)
            stack = [node]
            while stack:
                n = stack.pop()
                for c in n.children.values():
                    out.extend(c.token_ids)
                    stack.append(c)
        return out

    # -- DominoDecoder API -------------------------------------------------------

    @property
    def finished(self) -> bool:
        return self.inner.finished

    def mask(self, k: Optional[int] = None) -> np.ndarray:
        if not self.rest:
            return self.inner.mask(k)
        out = np.zeros(len(self.vocab), dtype=bool)
        for t in self._candidates():
            if self.inner.check_token(t):
                out[t] = True
        return out

    def mask_bits(self, k: Optional[int] = None) -> np.ndarray:
        """Packed mask: delegate to the (memoized) inner decoder once the
        forced prefix is consumed; while the prefix is live, pack the
        candidate scan (few tokens, no tree walk — not worth a memo)."""
        if not self.rest:
            return self.inner.mask_bits(k)
        from repro_torch.core import bitmask
        return bitmask.pack_bool(self.mask(k))

    @property
    def n_mask_memo_hits(self) -> int:
        return self.inner.n_mask_memo_hits

    def check_token(self, token_id: int) -> bool:
        if not self.rest:
            return self.inner.check_token(token_id)
        data = self.vocab[token_id]
        if token_id == self.eos_id or not data:
            return False
        return self._prefix_ok(data) and self.inner.check_token(token_id)

    def advance(self, token_id: int) -> bool:
        if self.rest:
            data = self.vocab[token_id]
            if token_id == self.eos_id or not data \
                    or not self._prefix_ok(data):
                return False
            if not self.inner.advance(token_id):
                return False
            self.rest = self.rest[len(data):]
            return True
        return self.inner.advance(token_id)

    def eos_legal(self) -> bool:
        return not self.rest and self.inner.eos_legal()

    def state_key(self):
        return (len(self.rest),) + self.inner.state_key()

    def clone(self) -> "HealedDecoder":
        h = HealedDecoder.__new__(HealedDecoder)
        h.inner = self.inner.clone()
        h.vocab = self.vocab
        h.eos_id = self.eos_id
        h.rest = self.rest
        h._trie = self._trie
        return h
