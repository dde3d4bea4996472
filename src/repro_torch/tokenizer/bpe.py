"""Byte-level BPE tokenizer, trained in-repo.

The 256 single bytes are always in the vocabulary (ids 0..255), so every
byte string is encodable — a requirement for DOMINO's subterminal trees
(any grammar-legal string must have at least one tokenization) and for
Algorithm 3 retokenization.  Merges are learned with the standard BPE
objective over a corpus; special tokens (PAD/BOS/EOS) sit at the top of the
id space.

Encoding supports two modes:
 - ``encode`` — canonical merge-order BPE (what a deployed tokenizer does);
 - ``encode_greedy`` — longest-match (used to emulate an *external*
   tokenizer for template-misalignment experiments).
"""
from __future__ import annotations

import collections
import json
import pathlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PAD_TOKEN = "<pad>"
BOS_TOKEN = "<bos>"
EOS_TOKEN = "<eos>"
SPECIALS = (PAD_TOKEN, BOS_TOKEN, EOS_TOKEN)


class BPETokenizer:
    def __init__(self, merges: List[Tuple[int, int]]):
        # vocab: id -> bytes; specials map to None (no byte content)
        self.vocab: List[Optional[bytes]] = [bytes([i]) for i in range(256)]
        self.merges = list(merges)
        self.merge_rank: Dict[Tuple[int, int], int] = {}
        for rank, (a, b) in enumerate(self.merges):
            new_id = len(self.vocab)
            self.merge_rank[(a, b)] = rank
            self.vocab.append(self.vocab[a] + self.vocab[b])
        self.pad_id = len(self.vocab)
        self.bos_id = self.pad_id + 1
        self.eos_id = self.pad_id + 2
        self.vocab.extend([None, None, None])
        self._merge_to_id = {
            (a, b): 256 + r for r, (a, b) in enumerate(self.merges)}
        self._bytes_to_id = {
            v: i for i, v in enumerate(self.vocab) if v is not None}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- encoding -------------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        return self.encode_bytes(text.encode("utf-8"))

    def encode_bytes(self, data: bytes) -> List[int]:
        ids = list(data)
        if len(ids) < 2:
            return ids
        while True:
            best_rank = None
            best_pos = -1
            for i in range(len(ids) - 1):
                r = self.merge_rank.get((ids[i], ids[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_pos = i
            if best_rank is None:
                return ids
            ids[best_pos:best_pos + 2] = [
                self._merge_to_id[(ids[best_pos], ids[best_pos + 1])]]

    def encode_greedy(self, text: str) -> List[int]:
        """Longest-match encode (external-tokenizer emulation)."""
        data = text.encode("utf-8")
        out: List[int] = []
        i = 0
        max_len = max((len(v) for v in self.vocab if v), default=1)
        while i < len(data):
            for ln in range(min(max_len, len(data) - i), 0, -1):
                tid = self._bytes_to_id.get(data[i:i + ln])
                if tid is not None:
                    out.append(tid)
                    i += ln
                    break
        return out

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return b"".join(self.vocab[i] or b"" for i in ids)

    # -- persistence ------------------------------------------------------------

    def save(self, path) -> None:
        pathlib.Path(path).write_text(json.dumps({"merges": self.merges}))

    @classmethod
    def load(cls, path) -> "BPETokenizer":
        data = json.loads(pathlib.Path(path).read_text())
        return cls([tuple(m) for m in data["merges"]])


def train_bpe(corpus: bytes, vocab_size: int = 2048,
              word_split: bool = True) -> BPETokenizer:
    """Learn BPE merges.  ``vocab_size`` includes the 256 byte tokens but
    not the 3 specials.  ``word_split`` restricts merges to within
    whitespace-delimited chunks (keeps the pair statistics tractable and
    yields GPT-style word-ish tokens, whitespace prefixed)."""
    n_merges = max(0, vocab_size - 256)
    if word_split:
        # split keeping whitespace attached to the following word
        words: collections.Counter = collections.Counter()
        cur = bytearray()
        for i, b in enumerate(corpus):
            if b in (32, 10, 9, 13) and cur and not _isspace(cur[-1]):
                words[bytes(cur)] += 1
                cur = bytearray()
            cur.append(b)
        if cur:
            words[bytes(cur)] += 1
        seqs = {w: list(w) for w in words}
        counts = dict(words)
    else:
        seqs = {corpus: list(corpus)}
        counts = {corpus: 1}

    # pair -> total count, and pair -> set of words containing it
    pair_count: collections.Counter = collections.Counter()
    pair_words: Dict[Tuple[int, int], set] = collections.defaultdict(set)
    for w, seq in seqs.items():
        c = counts[w]
        for a, b in zip(seq, seq[1:]):
            pair_count[(a, b)] += c
            pair_words[(a, b)].add(w)

    merges: List[Tuple[int, int]] = []
    next_id = 256
    for _ in range(n_merges):
        if not pair_count:
            break
        (a, b), cnt = max(pair_count.items(), key=lambda kv: (kv[1], kv[0]))
        if cnt < 2:
            break
        merges.append((a, b))
        affected = list(pair_words.get((a, b), ()))
        for w in affected:
            seq = seqs[w]
            c = counts[w]
            # remove old pair counts for this word
            for x, y in zip(seq, seq[1:]):
                pair_count[(x, y)] -= c
                if pair_count[(x, y)] <= 0:
                    del pair_count[(x, y)]
                pair_words[(x, y)].discard(w)
            # apply merge
            i = 0
            new_seq = []
            while i < len(seq):
                if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
                    new_seq.append(next_id)
                    i += 2
                else:
                    new_seq.append(seq[i])
                    i += 1
            seqs[w] = new_seq
            for x, y in zip(new_seq, new_seq[1:]):
                pair_count[(x, y)] += c
                pair_words[(x, y)].add(w)
        next_id += 1
    return BPETokenizer(merges)


def _isspace(b: int) -> bool:
    return b in (32, 10, 9, 13)
