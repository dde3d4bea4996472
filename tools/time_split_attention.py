#!/usr/bin/env python3
"""Time the port's split-score decode attention kernel (absorbed MLA, the
bfloat16 tensor-core kernel) on the card at ``chip_smoke.py``'s shapes,
beside the library's attention and the bound, for several block targets of
its key-split plan and, optionally, an older kernel.

    python3 tools/time_split_attention.py [--targets 66,132,264]
        [--baseline OLD/decode_attention.cu] [--ablate]

Shapes (bf16, deepseek-v3's width: 128 heads, latent 512, rope 64, one KV
group, 64-key pages): "main" B=4 with keys [51, 25, 1, 1] over 16 pages a
row (a mid-run decode call of the serve phase), "long" 1000 keys a row over
20 pages, "long_cold" 16384 keys a row over 256 pages (a 75.5 MB pool, 1.5
times the L2).  ``--targets`` sets ``ref.SCORE_BLOCKS`` in turn;
``--baseline`` builds an older ``decode_attention.cu`` whose
``repro_decode_attention_split`` takes no split arguments (the interface
before this kernel split its keys) and times it in the same run, in the
order baseline, kernel, kernel, baseline, for each target (``baseline_ms``
keeps the pair around the last target).  ``--ablate`` builds the kernel
library again with one part of the bfloat16 kernel taken out at a time (the
key loads, the score products, the P @ V products, or the split merge: the
kernel writes its split's state as if it were the output, and the second
pass is not launched) and times each at the default target: what a part
costs is how much faster the kernel runs without it.  The ablated kernels
give wrong outputs; only their times are printed.  Prints the card and one
JSON line a shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import kernel_variants as kv

ROOT = pathlib.Path(__file__).resolve().parents[1]
# part taken out -> (text of csrc/decode_attention.cu, its replacement)
ABLATIONS = {
    "no_key_loads": [
        ("    if (i < n_steps) issue(i);\n", ""),
        ("    if (i + kStages - 1 < n_steps) issue(i + kStages - 1);", "")],
    "no_scores": [("      if (kk < k_end) {", "      if (kk < 0) {")],
    "no_pv": [("      if (mt_live && c < R) {",
               "      if (mt_live && c < 0) {")],
    "no_merge": [
        ("  if (n_live <= 1) {", "  if (true) {"),
        ("  if (e != cudaSuccess || n_split == 1) return e;", "  return e;")],
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", default="132")
    ap.add_argument("--baseline", type=pathlib.Path)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_split_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ref
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_split_cuda as split

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    old = None if args.baseline is None else kv.baseline(
        args.baseline, "repro_decode_attention_split",
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p])
    ablated = (kv.edited("decode_attention.cu", ABLATIONS) if args.ablate
               else {})
    scale = 1.0 / math.sqrt(192)

    def old_call(q, q2, lat, rp, ln, tbl):
        b, s, g, qh, r = q.shape
        out = torch.empty_like(q)
        rc = old(1, q.data_ptr(), q2.data_ptr(), lat.data_ptr(),
                 rp.data_ptr(), ln.data_ptr(), tbl.data_ptr(), out.data_ptr(),
                 b, s, g, qh, r, q2.shape[-1], lat.shape[1], tbl.shape[1],
                 scale, torch.cuda.current_stream().cuda_stream)
        build.check(rc, "baseline decode_attention_split")
        return out

    gen = torch.Generator(device="cuda")
    default = ref.SCORE_BLOCKS
    for name, lens, mp in (("main", [51, 25, 1, 1], 16),
                           ("long", [1000] * 4, 20),
                           ("long_cold", [16384] * 4, 256)):
        gen.manual_seed(7)
        q, q2, lat, rp, ln, tbl = cs._split_case(torch, gen, torch.bfloat16, 1,
                                                 lens, False, mp=mp)
        want = ref.decode_attention_ref(q, lat, lat, ln, scale=scale, q2=q2,
                                        k2=rp, block_tables=tbl)
        row = {"library_ms": cs.time_ms(torch, cs._split_sdpa_yardstick(
                   torch, q, q2, lat, rp, ln, tbl, scale), n=10),
               "bound_ms": cs._split_bound(q, q2, lat, ln, tbl,
                                           "bfloat16")[0]}
        for target in map(int, args.targets.split(",")):
            ref.SCORE_BLOCKS = target

            def new():
                return split(q, lat, lat, q2, rp, ln, scale=scale,
                             block_tables=tbl)
            err = (new().float() - want.float()).abs().max().item()
            if old is None:
                times = [cs.time_ms(torch, new)]
            else:
                err_old = (old_call(q, q2, lat, rp, ln, tbl).float()
                           - want.float()).abs().max().item()
                n_old = 5 if name == "long_cold" else 20
                t = [cs.time_ms(torch, f, n=n) for f, n in (
                    (lambda: old_call(q, q2, lat, rp, ln, tbl), n_old),
                    (new, 50), (new, 50),
                    (lambda: old_call(q, q2, lat, rp, ln, tbl), n_old))]
                times = t[1:3]
                row["baseline_ms"] = [t[0], t[3]]
                row["baseline_err"] = err_old
            row[f"target_{target}"] = {"ms": times, "max_abs_err": err,
                                       "plan": cs._split_plan_text(q, q2, lat,
                                                                   tbl)}
        ref.SCORE_BLOCKS = default
        for part, alt in ablated.items():
            with kv.launching_from(alt):
                row[f"ablate_{part}_ms"] = cs.time_ms(torch, new)
        print(name, json.dumps(row), flush=True)
        del q, q2, lat, rp, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
