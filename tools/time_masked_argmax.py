#!/usr/bin/env python3
"""Time the port's masked-argmax kernels (packed-word and byte masks) on the
card, beside their plain version, their bounds, a ``torch.argmax``
yardstick and, optionally, an older kernel; for several split plans and
with parts of the kernel taken out.

    python3 tools/time_masked_argmax.py [--baseline OLD/masked_argmax.cu]
        [--plans 1024,4096,16384] [--ablate] [--variants unroll1,threads128]

Shapes (inputs drawn as in ``chip_smoke.py``'s argmax phase: a random row,
an all-illegal row, a row of one legal token, rows with ties):
"main" B=4 V=403 with a row stride of 100352 (the stablelm-1.6b serve
run's call) and "main_bytes" the same with the deepseek-v3 replay's stride
of 129280 and a byte mask; "long" B=4 V=100352 (stablelm-1.6b's vocabulary)
in float32 and ("long_bf16") bfloat16; "long_bytes" B=4 V=129280
(deepseek-v3's) with a byte mask; "long_cold" and "long_cold_bytes" B=64
V=262144 (gemma3-27b's vocabulary: 67 MB of float32 logits, above the
50 MB L2).  Each prints the plan that ``ref.argmax_plan`` chose, whether
the kernel equals the plain version bit for bit and two calls equal each
other, its bound (each byte read or written once at 3.35 TB/s), and
``argmax_ms``: ``torch.argmax`` over the same unmasked logits, the call a
selection tick makes anyway -- a yardstick, not the same function.

``--baseline`` builds an older ``masked_argmax.cu`` whose entry points take
no dtype or plan (one block a row, float32 only: commit 8feb28b's) and times
it beside the kernel; at a bfloat16 shape it runs on a float32 copy of the
logits (``baseline_on``).  ``--plans`` lists tokens a block: each is timed
against the kernel's own plan with the row split into blocks of that
length.  ``--ablate`` times the kernel against itself with one part taken
out at a time: the split (``one_split``: one block a row), the vectors
(``scalar``: every token by the scalar code; a rebuilt library), the
independence of the loads (``gated``: each logit load waits on its mask
bits again; a rebuilt library) or the merge (``no_merge``: the splits
write their pairs and stop, so the row's result is never written and its
``bitwise`` is null; a rebuilt library); what a part costs is how much
faster the kernel runs without it.  ``--variants`` builds the library
again with each named change of ``VARIANTS`` (the same function with
another unroll depth or block size) and times it against the kernel in the
same way, with its bits.  Every time is the mean of a run of
back-to-back calls (``chip_smoke.time_ms``), each pair taken in the order
other, kernel, kernel, other, and both readings are printed, as lists.
At the long_cold shapes the SM clock and the power draw are sampled by
``nvidia-smi`` while the kernel runs back to back for about a second.  Prints the card, the
sha256 of the kernel source it built, and one JSON line a shape.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

import kernel_variants as kv

ROOT = pathlib.Path(__file__).resolve().parents[1]
# name, mask layout, logit dtype, B, V, row stride
SHAPES = (("main", "packed", "float32", 4, 403, 100352),
          ("main_bytes", "bytes", "float32", 4, 403, 129280),
          ("long", "packed", "float32", 4, 100352, 100352),
          ("long_bf16", "packed", "bfloat16", 4, 100352, 100352),
          ("long_bytes", "bytes", "float32", 4, 129280, 129280),
          ("long_cold", "packed", "float32", 64, 262144, 262144),
          ("long_cold_bytes", "bytes", "float32", 64, 262144, 262144))
# part taken out -> (text of csrc/masked_argmax.cu, its replacement)
ABLATIONS = {
    "scalar": [("constexpr bool kVectorLoads = true;",
                "constexpr bool kVectorLoads = false;")],
    "gated": [
        ("        raw[u] = __ldg(reinterpret_cast<const uint4*>(row + t));",
         "        raw[u] = m[u] ? __ldg(reinterpret_cast<const uint4*>(row + t))"
         " : make_uint4(0, 0, 0, 0);"),
        ("    const float x = L::widen(__ldg(row + t));\n"
         "    consider(mask.legal(t) ? x : kNeg, t, best_v, best_i);",
         "    consider(mask.legal(t) ? L::widen(__ldg(row + t)) : kNeg, t, "
         "best_v, best_i);")],
    "no_merge": [
        ("    __threadfence();  // the pair is visible before the count says so\n"
         "    s_last = atomicAdd(counters + b, 1) == n_split - 1;",
         "    s_last = false;")],
}

# variant -> (text of csrc/masked_argmax.cu, its replacement): the same
# function with another block size or unroll depth
VARIANTS = {
    **{f"unroll{u}": [("constexpr int kUnroll = 2;",
                       f"constexpr int kUnroll = {u};")] for u in (1, 4, 8)},
    **{f"threads{t}": [("constexpr int kThreads = 256;",
                        f"constexpr int kThreads = {t};")] for t in (128, 512)},
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=pathlib.Path)
    ap.add_argument("--plans", default="")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--variants", default="",
                    help="comma-separated names of VARIANTS")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_masked_argmax: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.masked_sample import kernel as mk
    from repro_torch.kernels.masked_sample.ref import (ArgmaxPlan,
                                                       argmax_plan,
                                                       masked_argmax_ref,
                                                       unpack_bits)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    src = build.CSRC / "masked_argmax.cu"
    print(f"{src.relative_to(ROOT)} sha256 "
          f"{hashlib.sha256(src.read_bytes()).hexdigest()}", flush=True)
    splits = [int(p) for p in args.plans.split(",") if p]
    variants = [x for x in args.variants.split(",") if x]
    edits = {**(ABLATIONS if args.ablate else {}),
             **{name: VARIANTS[name] for name in variants}}
    libs = kv.edited("masked_argmax.cu", edits) if edits else {}
    lib = build.library()
    old = {}
    if args.baseline is not None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        old = {"packed": kv.baseline(args.baseline,
                                     "repro_masked_argmax_packed",
                                     [p, ll, p, i, i, i, p, p, p]),
               "bytes": kv.baseline(args.baseline,
                                    "repro_masked_argmax_bytes",
                                    [p, ll, p, ll, i, i, p, p, p])}

    def ms(f, n):
        return cs.time_ms(torch, f, n=n)

    def planned(fn, plan):
        """``fn`` with the kernel's plan replaced by ``plan``."""
        def call():
            mk.argmax_plan = lambda b, v: plan
            try:
                return fn()
            finally:
                mk.argmax_plan = argmax_plan
        return call

    def on(alt, fn):
        def call():
            with kv.launching_from(alt):
                return fn()
        return call

    gen = torch.Generator(device="cuda")
    for name, layout, dtype, b, v, stride in SHAPES:
        gen.manual_seed(3)
        logits, bits = cs._mask_case(torch, gen, b, v, stride,
                                     dtype=getattr(torch, dtype))
        mask = bits if layout == "packed" else unpack_bits(bits, v)
        wrapper = (mk.masked_argmax_packed if layout == "packed"
                   else mk.masked_argmax_bytes)
        plan = argmax_plan(b, v)
        esize = logits.element_size()
        n_bytes = (b * v * esize + b * 8
                   + (bits.numel() * 4 if layout == "packed" else b * v))
        bnd, by = cs.bound_ms(n_bytes, b * v, "float32")
        n = 200 if v * b < 10 ** 6 else 50

        def new():
            return wrapper(logits, mask)
        got = new()
        want = masked_argmax_ref(logits, mask)
        again = new()
        row = {"shape": f"B={b} V={v} row stride {logits.stride(0)} "
                        f"{dtype} logits, {layout} mask",
               "plan": plan._asdict(), "bytes": n_bytes, "bound_ms": bnd,
               "bound_by": by,
               "bitwise_plain": all(g.equal(w) for g, w in zip(got, want)),
               "bitwise_repeat": all(g.equal(a) for g, a in zip(got, again)),
               "plain_ms": ms(lambda: masked_argmax_ref(logits, mask), 10),
               "argmax_ms": ms(lambda: torch.argmax(logits, dim=-1), n)}
        if old:
            base_lg = logits.float() if dtype != "float32" else logits
            fn = old[layout]
            ld_mask = bits.shape[1] if layout == "packed" else mask.stride(0)

            def old_call():
                idx = torch.empty((b,), dtype=torch.int32, device="cuda")
                val = torch.empty((b,), dtype=torch.float32, device="cuda")
                rc = fn(base_lg.data_ptr(), base_lg.stride(0),
                        mask.data_ptr(), ld_mask, b, v, idx.data_ptr(),
                        val.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                build.check(rc, "baseline masked_argmax")
                return idx, val
            ref_old = old_call()
            row["baseline_on"] = ("float32 copy" if dtype != "float32"
                                  else "the same logits")
            row["baseline_bitwise"] = all(g.equal(w) for g, w in
                                          zip(got, ref_old))
            row["baseline_ms"], row["ms"] = kv.pair(ms, old_call, new, n)
        else:
            row["ms"] = [ms(new, n) for _ in range(2)]
        for split_len in splits:
            if split_len >= v:
                continue
            alt = planned(new, ArgmaxPlan(-(-v // split_len), split_len))
            row[f"plan_{split_len}"] = dict(
                zip(("kernel_ms", "plan_ms"), kv.pair(ms, new, alt, n)),
                n_split=-(-v // split_len),
                bitwise=all(g.equal(w) for g, w in zip(alt(), want)))
        if args.ablate:
            parts = {name_: on(libs[name_], new) for name_ in ABLATIONS}
            if plan.n_split > 1:
                parts["one_split"] = planned(
                    new, ArgmaxPlan(1, -(-v // 32) * 32))
            for part, alt in parts.items():
                row[f"ablate_{part}"] = dict(
                    zip(("kernel_ms", "ablated_ms"),
                        kv.pair(ms, on(lib, new), alt, n)),
                    bitwise=None if part == "no_merge" else
                    all(g.equal(w) for g, w in zip(alt(), want)))
        for var in variants:
            alt = on(libs[var], new)
            row[f"variant_{var}"] = dict(
                zip(("kernel_ms", "variant_ms"),
                    kv.pair(ms, on(lib, new), alt, n)),
                bitwise=all(g.equal(w) for g, w in zip(alt(), want)))
        if name.startswith("long_cold"):
            row["clock_mhz"], row["power_w"] = kv.clock_during(torch, new)
        print(name, json.dumps(row), flush=True)
        if not (row["bitwise_plain"] and row["bitwise_repeat"]):
            print(f"time_masked_argmax: {name}: the kernel differs from the "
                  "plain version or from itself", file=sys.stderr)
            return 1
        del logits, bits, mask
    return 0


if __name__ == "__main__":
    sys.exit(main())
