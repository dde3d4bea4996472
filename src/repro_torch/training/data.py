"""Synthetic data pipeline.

Two streams, both grammar-grounded (no external datasets offline):

1. ``lm_stream`` — free-form strings sampled from a workload grammar
   (JSON / C / XML ...), for language-model pretraining of the in-repo
   models and for tokenizer training.

2. ``task_stream`` — the *GSM8K-JSON analogue*: little arithmetic word
   problems whose gold answers are JSON objects in the paper's guided-
   math-reasoning schema (App. C Listing 4 / App. D Listing 8).  Because
   answers carry a verifiable number, constrained-decoding accuracy
   (Table 2) is measurable end-to-end with a model trained here.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import grammars
from repro_torch.core.sampling import GrammarSampler
from repro_torch.tokenizer import BPETokenizer

OPS = [("+", lambda a, b: a + b), ("-", lambda a, b: a - b),
       ("*", lambda a, b: a * b)]


@dataclasses.dataclass
class TaskExample:
    prompt: str
    answer_json: str
    answer_value: int


def make_task_example(rng: random.Random, n_steps: Optional[int] = None,
                      easy: bool = False) -> TaskExample:
    """A chained arithmetic problem + JSON reasoning answer.

    ``easy=True`` restricts to single-digit +/- with answers in [-7, 18] —
    learnable by the ~1M-param bench models, so constrained-decoding
    accuracy comparisons (Table 2/4) have signal above zero."""
    n_steps = n_steps or rng.randint(1, 3)
    if easy:
        n_steps = 1
        ops = OPS[:2]
        acc = rng.randint(2, 9)
    else:
        ops = OPS
        acc = rng.randint(2, 20)
    desc = [str(acc)]
    thoughts = []
    for _ in range(n_steps):
        op_s, op_f = ops[rng.randrange(len(ops))]
        b = rng.randint(1, 9) if easy else rng.randint(2, 12)
        new = op_f(acc, b)
        thoughts.append({
            "step": f"apply {op_s}{b}",
            "calculation": f"{acc}{op_s}{b}",
            "result": new,
        })
        desc.append(f"{op_s} {b}")
        acc = new
    prompt = "Q: compute " + " ".join(desc) + "\nA: "
    answer = json.dumps({"thoughts": thoughts, "answer": acc})
    return TaskExample(prompt, answer, acc)


def few_shot_prefix(rng: random.Random, n: int = 3,
                    easy: bool = False) -> str:
    parts = []
    for _ in range(n):
        ex = make_task_example(rng, easy=easy)
        parts.append(ex.prompt + ex.answer_json)
    return "\n".join(parts) + "\n"


_PER = ["Anna", "Bob", "Carla", "David", "Eva", "Frank"]
_LOC = ["Paris", "Berlin", "Tokyo", "Oslo", "Lima"]
_ORG = ["Acme", "Globex", "Initech", "Umbrella"]
_NER_TEMPLATES = [
    ("{p} works at {o}", [("p", "PER"), ("o", "ORG")]),
    ("{p} visited {l}", [("p", "PER"), ("l", "LOC")]),
    ("{o} opened an office in {l}", [("o", "ORG"), ("l", "LOC")]),
    ("{p} met {p2} in {l}", [("p", "PER"), ("p2", "PER"), ("l", "LOC")]),
]


def make_ner_example(rng: random.Random) -> TaskExample:
    """CoNLL-2003 analogue: extract entities into the App. D JSON schema."""
    tmpl, slots = _NER_TEMPLATES[rng.randrange(len(_NER_TEMPLATES))]
    pools = {"PER": _PER, "LOC": _LOC, "ORG": _ORG}
    fills = {}
    ents = []
    for slot, typ in slots:
        val = rng.choice(pools[typ])
        fills[slot] = val
        ents.append({"text": val, "type": typ})
    sent = tmpl.format(**fills)
    prompt = f"S: {sent}\nE: "
    answer = json.dumps({"entities": ents})
    return TaskExample(prompt, answer, len(ents))


def ner_few_shot(rng: random.Random, n: int = 2) -> str:
    parts = []
    for _ in range(n):
        ex = make_ner_example(rng)
        parts.append(ex.prompt + ex.answer_json)
    return "\n".join(parts) + "\n"


def evaluate_entities(text: str, gold_json: str) -> Optional[float]:
    """F1-ish exact-set score of extracted entities, or None if unparsable."""
    try:
        got = json.loads(text)["entities"]
        want = json.loads(gold_json)["entities"]
        gset = {(e["text"], e["type"]) for e in got}
        wset = {(e["text"], e["type"]) for e in want}
        if not gset and not wset:
            return 1.0
        inter = len(gset & wset)
        p = inter / max(1, len(gset))
        r = inter / max(1, len(wset))
        return 2 * p * r / max(1e-9, p + r)
    except (KeyError, TypeError, ValueError, AttributeError):
        return None


class NERDataset:
    """LM rows of few-shot NER extraction examples."""

    def __init__(self, tok: BPETokenizer, seq_len: int = 192, seed: int = 0,
                 few_shot: int = 2):
        self.tok = tok
        self.seq_len = seq_len
        self.rng = random.Random(seed)
        self.few_shot = few_shot

    def sample_row(self) -> Tuple[np.ndarray, np.ndarray]:
        ex = make_ner_example(self.rng)
        prefix = ner_few_shot(self.rng, self.few_shot)
        ids = self.tok.encode(prefix + ex.prompt) \
            + self.tok.encode(ex.answer_json) + [self.tok.eos_id]
        S = self.seq_len + 1
        labels = list(ids)
        if len(ids) >= S:
            ids, labels = ids[:S], labels[:S]
        else:
            pad = S - len(ids)
            ids = ids + [self.tok.pad_id] * pad
            labels = labels + [-1] * pad
        return np.asarray(ids, np.int32), np.asarray(labels, np.int32)

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            rows = [self.sample_row() for _ in range(batch_size)]
            yield {"tokens": np.stack([r[0] for r in rows]),
                   "labels": np.stack([r[1] for r in rows])[:, 1:]}


class TaskDataset:
    """Fixed-length packed LM rows of few-shot + problem + JSON answer.

    Labels: -1 (masked) on prompt/pad positions when ``mask_prompt``;
    otherwise plain LM over the whole row.
    """

    def __init__(self, tok: BPETokenizer, seq_len: int = 256,
                 seed: int = 0, few_shot: int = 2,
                 mask_prompt: bool = False, easy: bool = False):
        self.tok = tok
        self.seq_len = seq_len
        self.rng = random.Random(seed)
        self.few_shot = few_shot
        self.mask_prompt = mask_prompt
        self.easy = easy

    def sample_row(self) -> Tuple[np.ndarray, np.ndarray]:
        ex = make_task_example(self.rng, easy=self.easy)
        prefix = few_shot_prefix(self.rng, self.few_shot, easy=self.easy) \
            if self.few_shot else ""
        p_ids = self.tok.encode(prefix + ex.prompt)
        a_ids = self.tok.encode(ex.answer_json) + [self.tok.eos_id]
        ids = p_ids + a_ids
        labels = ([-1] * len(p_ids) if self.mask_prompt else
                  list(ids[:len(p_ids)])) + list(a_ids)
        S = self.seq_len + 1
        if len(ids) >= S:
            ids, labels = ids[:S], labels[:S]
        else:
            pad = S - len(ids)
            ids = ids + [self.tok.pad_id] * pad
            labels = labels + [-1] * pad
        return np.asarray(ids, np.int32), np.asarray(labels, np.int32)

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            rows = [self.sample_row() for _ in range(batch_size)]
            tokens = np.stack([r[0] for r in rows])
            labels = np.stack([r[1] for r in rows])
            yield {"tokens": tokens, "labels": labels[:, 1:]}


class GrammarLMDataset:
    """Plain LM stream over grammar-sampled strings."""

    def __init__(self, tok: BPETokenizer, grammar_name: str = "json",
                 seq_len: int = 256, seed: int = 0):
        self.tok = tok
        self.seq_len = seq_len
        g = grammars.load(grammar_name)
        self.sampler = GrammarSampler(g, seed=seed)

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        S = self.seq_len + 1
        buf: List[int] = []
        while True:
            rows = []
            while len(rows) < batch_size:
                while len(buf) < S:
                    buf.extend(self.tok.encode_bytes(self.sampler.sample()))
                    buf.append(self.tok.eos_id)
                rows.append(np.asarray(buf[:S], np.int32))
                buf = buf[S:]
            yield {"tokens": np.stack(rows)}


def evaluate_answer(text: str) -> Optional[int]:
    """Parse a generated JSON answer; returns the 'answer' value or None."""
    try:
        obj = json.loads(text)
        v = obj.get("answer")
        if isinstance(v, (int, float)):
            return int(v)
    except (json.JSONDecodeError, AttributeError, TypeError, ValueError):
        pass
    return None
