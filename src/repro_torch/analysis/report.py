"""Batch analysis runs and report serialization."""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import grammars as zoo
from repro_torch.core.analysis import AnalysisReport, analyze


def bytes_vocab() -> Tuple[List[Optional[bytes]], int]:
    """The synthetic byte-level vocabulary the CI gate analyzes under:
    all 256 single bytes plus one EOS sentinel.  Deterministic, needs no
    trained tokenizer artifact, and exercises every grammar path a
    byte-complete real vocabulary would (alignment gaps against it can
    only come from the grammar itself)."""
    vocab: List[Optional[bytes]] = [bytes([i]) for i in range(256)]
    vocab.append(None)                   # EOS
    return vocab, 256


def run_batch(names: Sequence[str], vocab: Sequence[Optional[bytes]],
              eos_id: int, clamp: int, max_states: int,
              progress=None,
              emit_device_table: bool = False) -> Dict[str, AnalysisReport]:
    """Analyze each named zoo grammar; returns name -> report."""
    out: Dict[str, AnalysisReport] = {}
    for name in names:
        g = zoo.load(name)
        rep = analyze(g, vocab, eos_id, name=name, clamp=clamp,
                      max_states=max_states,
                      emit_device_table=emit_device_table)
        out[name] = rep
        if progress is not None:
            progress(rep)
    return out


def write_json(reports: Dict[str, AnalysisReport], path: str) -> None:
    payload = {
        "reports": {name: rep.to_dict() for name, rep in reports.items()},
        "ok": all(rep.ok() for rep in reports.values()),
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
