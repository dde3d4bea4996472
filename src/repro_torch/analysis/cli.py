"""``python -m repro_torch.analyze`` — registration-time grammar verification.

Examples::

    python -m repro_torch.analyze json               # one zoo grammar
    python -m repro_torch.analyze --all --strict     # the CI gate
    python -m repro_torch.analyze --all --json report.json
    python -m repro_torch.analyze my.lark --tokenizer artifacts/tokenizer.json

Exit status: 0 when every analyzed grammar is clean, 1 under ``--strict``
when any report has problems (the gate condition), 2 on usage errors.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

from repro_torch.analysis.report import bytes_vocab, run_batch, write_json
from repro_torch.core import grammars as zoo
from repro_torch.core.analysis import (DEFAULT_CLAMP, DEFAULT_MAX_STATES,
                                 AnalysisReport, analyze)
from repro_torch.core.grammar import parse_grammar


def _load_vocab(tokenizer_path: Optional[str]) -> Tuple[list, int]:
    if tokenizer_path is None:
        return bytes_vocab()
    from repro_torch.tokenizer import BPETokenizer
    tok = BPETokenizer.load(tokenizer_path)
    return list(tok.vocab), tok.eos_id


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analyze",
        description="Static grammar x vocabulary analysis (trap states, "
                    "EOS-liveness, alignment gaps, closure certificate).")
    ap.add_argument("grammars", nargs="*",
                    help="zoo grammar names (see --list) or .lark file paths")
    ap.add_argument("--all", action="store_true",
                    help="analyze every grammar in the zoo")
    ap.add_argument("--list", action="store_true",
                    help="list zoo grammar names and exit")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if any report has problems (CI gate)")
    ap.add_argument("--tokenizer", metavar="PATH", default=None,
                    help="BPE tokenizer artifact to analyze against "
                         "(default: synthetic 256-byte vocab + EOS)")
    ap.add_argument("--clamp", type=int, default=DEFAULT_CLAMP,
                    help="origin clamp of the abstract quotient "
                         "(default %(default)s)")
    ap.add_argument("--max-states", type=int, default=DEFAULT_MAX_STATES,
                    help="abstract state budget before the closure is "
                         "declared non-finite (default %(default)s)")
    ap.add_argument("--emit-device-table", action="store_true",
                    help="assemble the device grammar table from each "
                         "clean closure certificate and report its "
                         "shape/footprint (what the serving engine "
                         "uploads under device_tables=True); grammars "
                         "whose certificate is not clean report the "
                         "refusal reason instead")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the full reports as JSON")
    ap.add_argument("--quiet", action="store_true",
                    help="only print verdict lines, not full summaries")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(zoo.GRAMMARS):
            print(name)
        return 0
    names = list(zoo.GRAMMARS) if args.all else args.grammars
    if not names:
        ap.print_usage(sys.stderr)
        print("error: no grammars given (name one, or use --all)",
              file=sys.stderr)
        return 2

    vocab, eos_id = _load_vocab(args.tokenizer)
    reports = {}
    for name in names:
        if name in zoo.GRAMMARS:
            reports.update(run_batch(
                [name], vocab, eos_id, args.clamp, args.max_states,
                emit_device_table=args.emit_device_table))
        elif os.path.exists(name):
            with open(name) as f:
                g = parse_grammar(f.read())
            reports[name] = analyze(
                g, vocab, eos_id, name=name, clamp=args.clamp,
                max_states=args.max_states,
                emit_device_table=args.emit_device_table)
        else:
            print(f"error: {name!r} is neither a zoo grammar nor a file "
                  f"(zoo: {', '.join(sorted(zoo.GRAMMARS))})",
                  file=sys.stderr)
            return 2

    for name, rep in reports.items():
        if args.quiet:
            print(f"{name}: {'OK' if rep.ok() else 'FAIL'}")
        else:
            print(rep.summary())
            print()
        if args.emit_device_table:
            tbl = rep.device_table
            if tbl is not None:
                print(f"{name}: device table CERTIFIED — "
                      f"{tbl.n_states} states, masks "
                      f"{tbl.mask_table.shape} + trans {tbl.trans.shape}"
                      f" = {tbl.n_bytes / 1024:.0f} KiB")
            else:
                why = []
                if not rep.closure.finite:
                    why.append("closure not finite")
                if rep.n_mask_conflicts:
                    why.append(f"{rep.n_mask_conflicts} mask conflicts")
                if rep.n_hyp_truncations:
                    why.append(f"{rep.n_hyp_truncations} hypothesis "
                               "truncations")
                if rep.traps:
                    why.append(f"{len(rep.traps)} trap states")
                print(f"{name}: device table REFUSED — "
                      f"{'; '.join(why) or 'no exploration masks'} "
                      f"(rows for this grammar serve on the host path)")
    if args.json:
        write_json(reports, args.json)
        print(f"wrote {args.json}")

    n_bad = sum(not rep.ok() for rep in reports.values())
    if n_bad:
        print(f"{n_bad}/{len(reports)} grammar(s) FAILED analysis",
              file=sys.stderr)
        if args.strict:
            return 1
    return 0
