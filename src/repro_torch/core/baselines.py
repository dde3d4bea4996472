"""Baseline constrained-decoding methods the paper compares against (§2, §4).

1. **Naive greedy constraining** (Fig. 1): only tokens that lie entirely
   within a single grammar terminal are allowed — no bridge tokens.  In our
   lookahead formulation this is exactly ``DOMINO(k=0)`` (the paper's Table 4
   ``k=0`` row equals the §2 naive accuracy number), so we expose it as a
   thin wrapper.

2. **Online parser-guided checking** (llama.cpp grammars / GCD /
   SYNCHROMESH): semantically identical to DOMINO(k=∞) but withOUT
   precomputation — every decode step scans the *entire vocabulary* and
   feeds each token through scanner+parser.  This is the throughput
   baseline of Table 3.

3. **Template-based generation** (GUIDANCE / LMQL): fixed text chunks are
   tokenized externally and force-inserted; only slot contents are
   generated under regex constraints.  Fast (skips forward passes for
   fixed tokens) but invasive: the external tokenization induces the
   misalignment of Fig. 2.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import regex as rx
from repro_torch.core.domino import DominoDecoder
from repro_torch.core.grammar import Grammar
from repro_torch.core.scanner import FRESH


def naive_greedy_decoder(grammar: Grammar, vocab, eos_id: int,
                         tree_cache=None) -> DominoDecoder:
    """Fig.-1 style greedy constraining == DOMINO with lookahead k=0."""
    return DominoDecoder(grammar, vocab, eos_id, k=0, tree_cache=tree_cache)


class OnlineParserDecoder(DominoDecoder):
    """Full-vocabulary online checking: no subterminal trees.

    mask() costs O(|V| * token_len * hypotheses) parser/scanner work per
    step — the cost profile of llama.cpp grammars and GCD, used as the
    performance baseline.  Produces bit-identical masks to DOMINO(k=∞).
    """

    def __init__(self, grammar: Grammar, vocab, eos_id: int, **kw):
        kw.pop("k", None)
        super().__init__(grammar, vocab, eos_id, k=None, **kw)

    def mask(self, k=None) -> np.ndarray:
        out = np.zeros(len(self.vocab), dtype=bool)
        if self.finished:
            return out
        for tok_id, data in enumerate(self.vocab):
            if tok_id == self.eos_id or data is None or len(data) == 0:
                continue
            if self._advance_hyps(tok_id, dry_run=True):
                out[tok_id] = True
        if self.eos_legal():
            out[self.eos_id] = True
        return out

    def mask_bits(self, k=None) -> np.ndarray:
        """Pack the online-scanned mask.  No tree segments and no memo —
        re-checking the whole vocabulary every step IS the baseline cost
        profile this class exists to measure."""
        from repro_torch.core import bitmask
        return bitmask.pack_bool(self.mask(k))


# ---------------------------------------------------------------------------
# Template-based (GUIDANCE-style)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Fixed:
    """A templated chunk, force-inserted via external tokenization."""
    text: str


@dataclasses.dataclass
class Gen:
    """A generation slot constrained by a regex, ended by ``stop`` text or
    by regex completion (whichever the model reaches first)."""
    pattern: str
    stop: Optional[str] = None
    max_tokens: int = 64


TemplatePart = Union[Fixed, Gen]


class TemplateSession:
    """Executes a GUIDANCE-style template against a token-level model.

    The engine asks ``next_action()`` what to do:
      ("force", [token_ids])  — append fixed tokens without a forward pass
      ("gen", mask)           — run the model, sample under ``mask``
      ("done", None)
    and reports sampled tokens back via ``feed(token_id)``.
    """

    def __init__(self, parts: Sequence[TemplatePart],
                 vocab: Sequence[Optional[bytes]], eos_id: int,
                 encode: Callable[[str], List[int]]):
        self.parts = list(parts)
        self.vocab = vocab
        self.eos_id = eos_id
        self.encode = encode
        self.part_idx = 0
        self._slot_dfa: Optional[rx.DFA] = None
        self._slot_state: Optional[int] = None
        self._slot_bytes = b""
        self._slot_tokens = 0
        self.forced_tokens = 0
        self.generated_tokens = 0

    def _enter_part(self):
        while self.part_idx < len(self.parts):
            part = self.parts[self.part_idx]
            if isinstance(part, Fixed):
                ids = self.encode(part.text)
                self.part_idx += 1
                self.forced_tokens += len(ids)
                return ("force", ids)
            # Gen slot
            if self._slot_dfa is None:
                self._slot_dfa = rx.compile_pattern(part.pattern)
                self._slot_state = self._slot_dfa.start
                self._slot_bytes = b""
                self._slot_tokens = 0
            return ("gen", self._slot_mask(part))
        return ("done", None)

    def next_action(self):
        return self._enter_part()

    def _token_fits(self, data: bytes, part: Gen) -> bool:
        st = self._slot_state
        dfa = self._slot_dfa
        for b in data:
            st = dfa.step(st, b)
            if st is None:
                return False
        return True

    def _slot_mask(self, part: Gen) -> np.ndarray:
        mask = np.zeros(len(self.vocab), dtype=bool)
        # token budget exhausted: force the slot closed
        if self._slot_tokens >= part.max_tokens and \
                self._slot_dfa.is_accept(self._slot_state):
            mask[self.eos_id] = True
            return mask
        for tok_id, data in enumerate(self.vocab):
            if data is None or len(data) == 0:
                continue
            if self._token_fits(data, part):
                mask[tok_id] = True
        # allow ending the slot when the regex currently accepts
        if self._slot_dfa.is_accept(self._slot_state):
            mask[self.eos_id] = True
        return mask

    def feed(self, token_id: int) -> None:
        part = self.parts[self.part_idx]
        assert isinstance(part, Gen)
        self.generated_tokens += 1
        if token_id == self.eos_id:
            self._finish_slot()
            return
        data = self.vocab[token_id]
        for b in data:
            self._slot_state = self._slot_dfa.step(self._slot_state, b)
        self._slot_bytes += data
        self._slot_tokens += 1
        if part.stop is not None and part.stop.encode() in self._slot_bytes:
            self._finish_slot()
        elif (self._slot_dfa.is_accept(self._slot_state)
              and not self._slot_dfa.can_continue(self._slot_state)):
            self._finish_slot()

    def _finish_slot(self):
        self._slot_dfa = None
        self._slot_state = None
        self.part_idx += 1


# ---------------------------------------------------------------------------
# Regex-only constraining (Outlines-style precomputed DFA-token table)
# ---------------------------------------------------------------------------


class RegexDecoder:
    """Willard & Louf (2023): precompute, for every DFA state, the set of
    vocabulary tokens that keep the DFA alive.  Regular expressions only —
    the expressivity rung below DOMINO's CFGs."""

    def __init__(self, pattern: str, vocab: Sequence[Optional[bytes]],
                 eos_id: int):
        self.dfa = rx.compile_pattern(pattern)
        self.vocab = vocab
        self.eos_id = eos_id
        self.state: Optional[int] = self.dfa.start
        self.finished = False
        # Precompute state -> allowed token ids (the Outlines index).
        self.table: List[np.ndarray] = []
        for st in range(self.dfa.n_states):
            ok = []
            for tok_id, data in enumerate(vocab):
                if data is None or len(data) == 0:
                    continue
                s = st
                alive = True
                for b in data:
                    s = self.dfa.step(s, b)
                    if s is None:
                        alive = False
                        break
                if alive:
                    ok.append(tok_id)
            self.table.append(np.asarray(ok, dtype=np.int32))

    def mask(self) -> np.ndarray:
        out = np.zeros(len(self.vocab), dtype=bool)
        if self.finished:
            return out
        out[self.table[self.state]] = True
        if self.dfa.is_accept(self.state):
            out[self.eos_id] = True
        return out

    def advance(self, token_id: int) -> bool:
        if token_id == self.eos_id:
            if self.dfa.is_accept(self.state):
                self.finished = True
                return True
            return False
        s = self.state
        for b in self.vocab[token_id]:
            s = self.dfa.step(s, b)
            if s is None:
                return False
        self.state = s
        return True
