"""Model-based retokenization (Algorithm 3, App. B).

Re-encode a target byte string with the tokenization the model itself would
have chosen when forced to produce exactly that text: at each step, among
all vocabulary tokens that are a prefix of the remaining target, pick the
one with the highest model logit.  Used to *naturalize* template-generated
output for the invasiveness analysis (Fig. 2), and as a utility to turn
few-shot demonstration text into model-preferred token ids.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.trees import VocabTrie


def prefix_tokens(trie: VocabTrie, target: bytes) -> List[int]:
    """All token ids that are a (non-empty) prefix of ``target``."""
    out: List[int] = []
    node = trie
    for b in target:
        node = node.children.get(b)
        if node is None:
            break
        out.extend(node.token_ids)
    return out


def retokenize(model_logits: Callable[[List[int]], np.ndarray],
               prompt_ids: List[int], target: bytes,
               vocab: Sequence[Optional[bytes]],
               trie: Optional[VocabTrie] = None) -> List[int]:
    """Algorithm 3: greedy model-preferred tokenization of ``target``.

    ``model_logits(ids)`` returns next-token logits after ``ids``.
    """
    trie = trie or VocabTrie.build(list(vocab))
    out: List[int] = []
    rest = target
    while rest:
        cands = prefix_tokens(trie, rest)
        if not cands:
            raise ValueError(
                f"no vocabulary token is a prefix of {rest[:20]!r}; "
                "vocabulary must cover all single bytes of the target")
        logits = model_logits(prompt_ids + out)
        best = max(cands, key=lambda t: logits[t])
        out.append(best)
        rest = rest[len(vocab[best]):]
    return out


def greedy_tokenize(target: bytes, vocab: Sequence[Optional[bytes]],
                    trie: Optional[VocabTrie] = None) -> List[int]:
    """External-tokenizer stand-in: longest-match greedy encoding (the kind
    of fixed tokenization that causes template-induced misalignment)."""
    trie = trie or VocabTrie.build(list(vocab))
    out: List[int] = []
    rest = target
    while rest:
        cands = prefix_tokens(trie, rest)
        if not cands:
            raise ValueError(f"untokenizable byte {rest[:1]!r}")
        best = max(cands, key=lambda t: len(vocab[t]))
        out.append(best)
        rest = rest[len(vocab[best]):]
    return out
