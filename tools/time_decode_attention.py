#!/usr/bin/env python3
"""Time the port's plain-score decode attention kernel on the card at
``chip_smoke.py``'s shapes, beside the library's attention and the bound,
for several key-split targets and, optionally, an older kernel.

    python3 tools/time_decode_attention.py [--targets 264,528,1056]
        [--baseline OLD/decode_attention.cu]

Shapes (bf16, G=32, Qh=1, D=64, 64-key pages): "main" B=4 with keys [51,
25, 24, 29] over 16 pages a row, "contiguous" the same rows as 1024-slot
stripes with keys [51, 1, 24, 1], "long" 1000 keys a row over 20 pages,
"long_cold" 4096 keys a row over 64 pages (a 134 MB pool, 2.7 times the
L2).  ``--targets`` sets ``ref.SPLIT_BLOCKS`` in turn; ``--baseline``
builds an older ``decode_attention.cu`` whose ``repro_decode_attention``
has no split arguments (the interface before key splitting) and times it
in the same run, in the order baseline, kernel, kernel, baseline, for each
target (``baseline_ms`` keeps the pair around the last target).  Prints
the card and one JSON line a shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import kernel_variants as kv

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", default="528")
    ap.add_argument("--baseline", type=pathlib.Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_decode_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ref
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    old = None if args.baseline is None else kv.baseline(
        args.baseline, "repro_decode_attention",
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p])

    def old_call(q, kp, vp, ln, tbl):
        b, s, g, qh, dk = q.shape
        out = torch.empty(q.shape[:4] + vp.shape[-1:], dtype=q.dtype,
                          device="cuda")
        rc = old(1 if q.dtype == torch.bfloat16 else 0, q.data_ptr(),
                 kp.data_ptr(), vp.data_ptr(), ln.data_ptr(),
                 None if tbl is None else tbl.data_ptr(), out.data_ptr(), b,
                 s, g, qh, dk, vp.shape[-1], kp.shape[1],
                 1 if tbl is None else tbl.shape[1], dk ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        build.check(rc, "baseline decode_attention")
        return out

    gen = torch.Generator(device="cuda")
    cases = {}
    for name, lens, mp in (("main", [51, 25, 24, 29], 16),
                           ("long", [1000] * 4, 20),
                           ("long_cold", [4096] * 4, 64)):
        gen.manual_seed(4)
        cases[name] = cs._paged_case(torch, gen, torch.bfloat16, 1, 1, lens,
                                     False, mp=mp)
    q, kp, vp, _, tbl = cases["main"]
    cases["contiguous"] = (
        q, ref.gather_pages(kp, tbl).contiguous(),
        ref.gather_pages(vp, tbl).contiguous(),
        torch.tensor([51, 1, 24, 1], dtype=torch.int32, device="cuda"), None)
    default = ref.SPLIT_BLOCKS
    for name, (q, kp, vp, ln, tbl) in cases.items():
        want = ref.decode_attention_ref(q, kp, vp, ln, block_tables=tbl)
        row = {"library_ms": cs.time_ms(torch, cs._sdpa_yardstick(
                   torch, q, kp, vp, ln, tbl)),
               "bound_ms": cs._attn_bound(q, kp, ln, tbl, "bfloat16")[0]}
        for target in map(int, args.targets.split(",")):
            ref.SPLIT_BLOCKS = target

            def new():
                return decode_attention_cuda(q, kp, vp, ln, block_tables=tbl)
            err = (new().float() - want.float()).abs().max().item()
            if old is None:
                times = [cs.time_ms(torch, new)]
            else:
                err_old = (old_call(q, kp, vp, ln, tbl).float()
                           - want.float()).abs().max().item()
                t = [cs.time_ms(torch, f) for f in (
                    lambda: old_call(q, kp, vp, ln, tbl), new, new,
                    lambda: old_call(q, kp, vp, ln, tbl))]
                times = t[1:3]
                row["baseline_ms"] = [t[0], t[3]]
                row["baseline_err"] = err_old
            row[f"target_{target}"] = {"ms": times, "max_abs_err": err,
                                       "plan": cs._plan_text(q, kp, tbl)}
        ref.SPLIT_BLOCKS = default
        print(name, json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
