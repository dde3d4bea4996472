#!/usr/bin/env python3
"""Time the port's Mamba2 SSD scan kernel on the card at zamba2-1.2b's
width (64 heads, D = N = 64), beside its plain version and its bounds, for
several plans and, optionally, an older kernel.

    python3 tools/time_ssd_scan.py [--baseline OLD/ssd_scan.cu]
        [--plans 32:2,64:1,64:4,64:2:8] [--ablate] [--phases]

Shapes (float32, operands drawn as in ``chip_smoke.py``'s scan phase):
"main" B=4 S=1 (the serving path's decode call, the decode path), "prompt"
B=1 S=37 (an admission prefill), "long" B=1 S=300, "long_cold" B=1 S=2048
(71 MB of operands, above the 50 MB L2).  For each shape the kernel's and
the plain version's largest error against a float64 recurrence are printed
beside the kernel's against the plain version.  ``bound_ms`` is
``chip_smoke._ssd_bound``'s; ``recurrence_f32_ms`` is the recurrence's
operations at the float32 rate, the figure earlier runs used as the
bound, computed.

``--baseline`` builds an older ``ssd_scan.cu`` whose ``repro_ssd_scan``
takes no plan (the step-by-step kernel of commit b51716d) and times it
beside the kernel.  ``--plans`` lists chunk:d_split[:warps] layouts of the
chunked path, each timed beside the kernel's own: d_split is passed
through the plan, and a chunk or a count of warps a block other than the
kernel's (``kChunk``, ``kChunkThreads`` in ``csrc/ssd_scan.cu``) builds
the library again with that constant edited.  ``--ablate`` builds the
library again with one part of the chunked path taken out at a time (the
compensation: one TF32 pass instead of three; the state products, C h^T
and the state update; or the staging waits) and times each against the
kernel: what a part costs is how much faster the kernel runs without it.
The ablated kernels give wrong outputs; only their times are printed.
``--phases`` builds the library again with the SM clock read by each warp
of block 0 at the phase boundaries of every chunk, and prints for the
shapes of more than one chunk the cycles each warp spends from the chunk's
first barrier to the end of staging and its scan, in phase 1 (G o M and
C h_prev^T), at the barrier after it, in phase 2 (Y and the state update),
and from there to the next chunk's first barrier (the wait for its tiles
and the slowest warp): the median over the chunks (the first and last left
out where there are more than two) of the largest and the smallest over the
warps.
Every time is the mean of a run of back-to-back calls
(``chip_smoke.time_ms``), each pair taken in the order other, kernel,
kernel, other, and both readings are printed, as lists.  At long_cold the
SM clock and the power draw are sampled by ``nvidia-smi`` while the kernel
runs back to back for about a second.  Prints the card and one JSON line a
shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import kernel_variants as kv

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = (("main", 4, 1), ("prompt", 1, 37), ("long", 1, 300),
          ("long_cold", 1, 2048))
H = D = N = 64
# part taken out -> (text of csrc/ssd_scan.cu, its replacement)
ABLATIONS = {
    "one_pass": [(
        "        mma_tf32(small[q], al, bh0, bh1);  // compensation: lo * hi\n"
        "        mma_tf32(small[q], ah, bl0, bl1);  // compensation: hi * lo\n",
        "")],
    "no_state": [
        ("        warp_gemm(big, small, [&](int i, int k) { return sc[i * PN + k]; }, "
         "[&](int k, int d) { return hp[d * PH + k]; }, m0, n0, nt, 0, Np);\n", ""),
        ("        warp_gemm(big, small, [&](int d, int j) { return sx[j * PX + d] * "
         "my[2 * L + j]; }, [&](int j, int n) { return sb[j * PN + n]; }, m0, n0, "
         "nt, 0, L);\n", "")],
    "no_waits": [(
        "    cp_async_wait_all();  // this thread's copies of chunk c have landed\n",
        "")],
}


STAMP = ("if (blockIdx.x == 0 && lane == 0 && c < 64) "
         "ssd_stamps[(c * 5 + {}) * 32 + warp] = stamp_clock();\n")
# the stamped build: the SM clock at five points of each chunk, by warp, read
# with a memory clobber so that the compiler keeps each read between the
# barriers and memory operations around it
PHASES = [
    ("#include <stdint.h>\n",
     "#include <stdint.h>\n__device__ long long ssd_stamps[64 * 5 * 32];\n"
     "extern \"C\" int repro_ssd_stamps(void* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, ssd_stamps, sizeof(ssd_stamps));\n}\n"
     "__device__ __forceinline__ long long stamp_clock() {\n"
     "  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) :: \"memory\");\n"
     "  return t;\n}\n"),
    ("    __syncthreads();      // everyone's have, and chunk c - 1 is consumed\n",
     "    __syncthreads();      // everyone's have, and chunk c - 1 is consumed\n    "
     + STAMP.format(0)),
    ("      eL = expf(cum_l);\n      __syncwarp();\n    }\n",
     "      eL = expf(cum_l);\n      __syncwarp();\n    }\n    " + STAMP.format(1)),
    ("    }\n    __syncthreads();\n\n    // Phase 2",
     "    }\n    " + STAMP.format(2) + "    __syncthreads();\n    " + STAMP.format(3)
     + "\n    // Phase 2"),
    ("big[q][e] + small[q][e];\n      }\n    }\n  }\n",
     "big[q][e] + small[q][e];\n      }\n    }\n    " + STAMP.format(4) + "  }\n"),
]


def _phases(lib, nc, warps):
    """Median over chunks of the SM cycles each part of a chunk takes, the
    largest and the smallest over the warps.  Each interval is read within
    one warp: the clocks of an SM's sub-partitions are not aligned."""
    buf = (ctypes.c_longlong * (64 * 5 * 32))()
    lib.repro_ssd_stamps.argtypes = [ctypes.c_void_p]
    if lib.repro_ssd_stamps(ctypes.cast(buf, ctypes.c_void_p)) != 0:
        raise RuntimeError("time_ssd_scan: stamps not read")

    def at(c, p, w):
        return buf[(c * 5 + p) * 32 + w]
    names = ("stage_and_scan", "phase1", "barrier", "phase2", "wait", "chunk")
    parts = {k: [] for k in names}
    chunks = range(1, nc - 1) if nc > 2 else range(1)
    for c in chunks:
        per_warp = []
        for w in range(warps):
            p = [at(c, i, w) for i in range(5)] + [at(c + 1, 0, w)]
            per_warp.append([p[1] - p[0], p[2] - p[1], p[3] - p[2],
                             p[4] - p[3], p[5] - p[4], p[5] - p[0]])
        for i, k in enumerate(names):
            parts[k].append((max(v[i] for v in per_warp),
                             min(v[i] for v in per_warp)))
    return {k: {"max": statistics.median(a for a, _ in v),
                "min": statistics.median(b for _, b in v)}
            for k, v in parts.items()}


def _constant(src, name):
    """The value of ``constexpr int <name>`` in a kernel source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _layout_edits(src, chunk, warps):
    """(text, replacement) pairs that set the chunked path's chunk and its
    warps a block in ``ssd_scan.cu``."""
    return [(f"constexpr int {name} = {_constant(src, name)};",
             f"constexpr int {name} = {value};")
            for name, value in (("kChunk", chunk),
                                ("kChunkThreads", 32 * warps))
            if value != _constant(src, name)]


def _scan64(torch, x, bm, cm, ld, dt, h0):
    """The recurrence in float64, step by step: the yardstick of both."""
    x, bm, cm, ld, dt, h = (t.double() for t in (x, bm, cm, ld, dt, h0))
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(ld[:, t])[..., None, None] * h + (
            dt[:, t, :, None] * x[:, t])[..., None] * bm[:, t, None, None, :]
        ys.append(torch.einsum("bhdn,bn->bhd", h, cm[:, t]))
    return torch.stack(ys, dim=1), h


def _err(got, want):
    return max((g.double() - w.double()).abs().max().item()
               for g, w in zip(got, want))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=pathlib.Path)
    ap.add_argument("--plans", default="")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_ssd_scan: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ref
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    src = (build.CSRC / "ssd_scan.cu").read_text()
    chunk0 = _constant(src, "kChunk")
    warps0 = _constant(src, "kChunkThreads") // 32
    plans = [tuple(map(int, p.split(":"))) for p in args.plans.split(",")
             if p]
    plans = [(c, d, rest[0] if rest else warps0) for c, d, *rest in plans]
    edits = dict(ABLATIONS) if args.ablate else {}
    if args.phases:
        edits["phases"] = PHASES
    for c, _, w in plans:
        if (c, w) != (chunk0, warps0):
            edits[f"layout_{c}_{w}"] = _layout_edits(src, c, w)
    libs = kv.edited("ssd_scan.cu", edits) if edits else {}
    lib = build.library()
    old = None if args.baseline is None else kv.baseline(
        args.baseline, "repro_ssd_scan",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    auto = ref.ssd_plan

    def forced(d_split):
        """ref.ssd_plan with the chunked path's slices fixed."""
        def plan(s, h, d, n):
            p = auto(s, h, d, n)
            return p if p.path == "decode" else p._replace(d_split=d_split)
        return plan

    def old_call(x, bm, cm, ld, dt, h0):
        b, s, h, d = x.shape
        y = torch.empty_like(x)
        hT = torch.empty_like(h0)
        rc = old(x.data_ptr(), bm.data_ptr(), cm.data_ptr(), ld.data_ptr(),
                 dt.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
                 b, s, h, d, bm.shape[-1],
                 torch.cuda.current_stream().cuda_stream)
        build.check(rc, "baseline ssd_scan")
        return y, hT

    def ms(f, n):
        return cs.time_ms(torch, f, n=n)

    def planned(plan):
        """The kernel on this shape's operands, laid out by ``plan``."""
        def call():
            ref.ssd_plan = plan
            try:
                return ssd_scan_cuda(*ops)
            finally:
                ref.ssd_plan = auto
        return call

    def on(alt, fn):
        """``fn`` launching from the library ``alt``."""
        def call():
            with kv.launching_from(alt):
                return fn()
        return call

    gen = torch.Generator(device="cuda")
    for name, b, s in SHAPES:
        gen.manual_seed(5)
        ops = cs._scan_inputs(
            torch, gen, [(b, s, H, D), (b, s, N), (b, s, N), (b, s, H),
                         (b, s, H), (b, H, D, N)],
            [None, None, None, -0.3, 0.2, None])
        chunk = min(128, s)
        want = ref.ssd_scan_ref(*ops, chunk=chunk)
        exact = _scan64(torch, *ops)
        bnd, by = cs._ssd_bound(ops[0], N)
        n_new = 20 if name == "long_cold" else 50

        def new():
            return ssd_scan_cuda(*ops)
        got = new()
        row = {"shape": f"B={b} S={s} H={H} D={D} N={N}",
               "plan": ref.ssd_plan(s, H, D, N)._asdict(),
               "bound_ms": bnd, "bound_by": by,
               "recurrence_f32_ms": cs._ssd_recurrence_ms(ops[0], N),
               "plain_ms": ms(lambda: ref.ssd_scan_ref(*ops, chunk=chunk),
                              3 if s > 300 else 10),
               "plain_err_f64": _err(want, exact),
               "max_abs_err": _err(got, want), "err_f64": _err(got, exact),
               "bitwise_repeat": all(g.equal(k) for g, k in zip(got, new()))}
        if old is None:
            row["ms"] = [ms(new, n_new) for _ in range(2)]
        else:
            row["baseline_err_f64"] = _err(old_call(*ops), exact)
            row["baseline_ms"], row["ms"] = kv.pair(
                ms, lambda: old_call(*ops), new, 10 if s > 300 else n_new)
        if s > 1:
            for c, d_split, w in plans:
                key = f"plan_{c}:{d_split}:{w}"
                alt = planned(forced(d_split))
                if (c, w) != (chunk0, warps0):
                    alt = on(libs[f"layout_{c}_{w}"], alt)
                row[key] = dict(zip(
                    ("kernel_ms", "plan_ms"),
                    kv.pair(ms, planned(auto), alt, n_new)),
                    max_abs_err=_err(alt(), want))
            for part in ABLATIONS if args.ablate else ():
                row[f"ablate_{part}"] = dict(zip(
                    ("kernel_ms", "ablated_ms"),
                    kv.pair(ms, on(lib, new), on(libs[part], new), n_new)))
        if args.phases and s > chunk0:
            on(libs["phases"], new)()
            torch.cuda.synchronize()
            row["phase_cycles"] = _phases(libs["phases"], -(-s // chunk0),
                                          warps0)
        if name == "long_cold":
            row["clock_mhz"], row["power_w"] = kv.clock_during(torch, new)
        print(name, json.dumps(row), flush=True)
        del ops, want, exact
    return 0


if __name__ == "__main__":
    sys.exit(main())
