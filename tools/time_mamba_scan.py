#!/usr/bin/env python3
"""Time the port's Mamba1 selective-scan kernel on the card at
falcon-mamba-7b's width (d_inner 8192, N 16), beside its plain version and
its bound, for several layouts and, optionally, an older kernel.

    python3 tools/time_mamba_scan.py [--plans 256:32,128:32,256:32:2]
        [--baseline OLD/mamba_scan.cu] [--ablate] [--variants a,b] [--sass]

Shapes (float32, operands drawn as in ``chip_smoke.py``'s scan phase):
"main" B=4 S=1 (the serving path's decode call), "prefill" B=1 S=37 (its
admission prefill), "long" B=1 S=300, "long_cold" B=1 S=2048 (201 MB of
dt, x and y, four times the L2).  For each shape the kernel's and the plain
version's largest error against a float64 recurrence are printed beside
the kernel's against the plain version.

``--plans`` lists layouts as threads:tile[:states]: ``ref.SCAN_THREADS``,
``ref.TIME_TILE`` and the states a lane holds (4 unless given; another
count builds the library again with the kernel's ``kStates`` set to it);
the first is timed with ``--ablate``.  ``--baseline`` builds an older
``mamba_scan.cu`` whose ``repro_mamba_scan`` takes no plan (as in commit
fa341cc) and times it beside each layout.  Every time is the mean of a run
of back-to-back calls (``chip_smoke.time_ms``), and each is taken twice in
the order other, kernel, kernel, other: both readings of each pair are
printed, as lists.  ``--ablate`` builds the library again with one part of
the scan taken out at a time (the exponentials; the staging waits; or the
y reduction and store, with the products by C_t that feed it) and times
each against the kernel: what a part costs is how much faster the kernel
runs without it.  The ablated kernels give wrong outputs; only their times
are printed.  ``--variants`` builds the library again with each named
change of ``VARIANTS`` (the same function, computed otherwise) and times
it against the kernel in the same way, with its errors.  At long_cold the
SM clock and the power draw are sampled by
``nvidia-smi`` while the kernel runs back to back for about a second
(``clock_mhz``, ``power_w``: the median sample).  ``--sass`` reads the
compiled kernel (4 lanes, vector state) with ``cuobjdump`` and prints the
instructions of its staged loop and the exponentials among them: their
ratio is the instructions a state-step.  Prints the card and one JSON line
a shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

import kernel_variants as kv

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = (("main", 4, 1), ("prefill", 1, 37), ("long", 1, 300),
          ("long_cold", 1, 2048))
D, N = 8192, 16
STATES = "constexpr int kStates = 4;"
# part taken out -> (text of csrc/mamba_scan.cu, its replacement)
ABLATIONS = {
    "no_exp": [("fmaf(expf(dtv * av[i]), h[i], dx * bv[i])",
                "fmaf(dtv * av[i], h[i], dx * bv[i])")],
    "no_waits": [("    cp_async_wait<kStages - 2>();", "")],
    "no_y": [
        ("      const float yv = all_reduce<L>(part);\n"
         "      if (live && j == 0) y[off] = yv;", "      (void)part;"),
        ("      const float yv = reduce_scatter<L>(acc, j);\n"
         "      store_if(y + (row0 + u + j) * d + ch, yv, live && u + j < steps);",
         "      (void)acc;")],
}
# variant -> (text of csrc/mamba_scan.cu, its replacement)
VARIANTS = {
    # y's predicated store without a memory clobber: the next group's
    # shared-memory loads may move above it
    "store_free": [('"f"(v), "r"((int)p)\n      : "memory");',
                    '"f"(v), "r"((int)p));')],
    # the same, and four groups of L steps unrolled instead of two
    "store_free_unroll4": [('"f"(v), "r"((int)p)\n      : "memory");',
                            '"f"(v), "r"((int)p));'),
                           ("#pragma unroll 2\n", "#pragma unroll 4\n")],
    # the same store, and a group's factors, B_t * dt * x and C_t for its
    # L steps formed before the states are updated (the same operations)
    "store_free_exps_first": [
        ('"f"(v), "r"((int)p)\n      : "memory");', '"f"(v), "r"((int)p));'),
        ("""        acc[q] = lane_step(h, av, sdt[t * kRow], sx[t * kRow], b4.v, c4.v);
      }
""", """        const float dtv = sdt[t * kRow], dx = dtv * sx[t * kRow];
#pragma unroll
        for (int i = 0; i < kStates; ++i) {
          e[q][i] = expf(dtv * av[i]);
          bx[q][i] = dx * b4.v[i];
          cq[q][i] = c4.v[i];
        }
      }
#pragma unroll
      for (int q = 0; q < L; ++q) {
        acc[q] = 0.f;
#pragma unroll
        for (int i = 0; i < kStates; ++i) {
          h[i] = fmaf(e[q][i], h[i], bx[q][i]);
          acc[q] = fmaf(h[i], cq[q][i], acc[q]);
        }
      }
"""), ("      float acc[L];\n",
       "      float acc[L], e[L][kStates], bx[L][kStates], cq[L][kStates];\n")],
}


def _scan64(torch, dt, x, bm, cm, a, h0):
    """The recurrence in float64, step by step: the yardstick of both."""
    dt, x, bm, cm, a, h = (t.double() for t in (dt, x, bm, cm, a, h0))
    ys = []
    for t in range(dt.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * x[:, t])[:, :, None] * bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
    return torch.stack(ys, dim=1), h


def _loop_sass(lib_path):
    """{"loop_instructions", "loop_exps"} of the 4-lane vector-state
    kernel's loop densest in exponentials (MUFU.EX2), the staged steps, in
    the library at ``lib_path``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    fn = next(b for b in text.split("Function : ")[1:]
              if "mamba_scan_kernelILi4ELb1E" in b.splitlines()[0])
    ins = [(int(a, 16), op) for a, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s*([^;]*);", fn)]
    loops = []
    for addr, op in ins:
        m = re.search(r"BRA 0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:   # a backward branch
            body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
            loops.append((sum("MUFU.EX2" in o for o in body), len(body)))
    exps, n = max(loops, key=lambda e: e[0] / e[1])
    return {"loop_instructions": n, "loop_exps": exps}


def _err(got, want):
    return max((g.double() - w.double()).abs().max().item()
               for g, w in zip(got, want))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plans", default="256:32")
    ap.add_argument("--baseline", type=pathlib.Path)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--variants", default="")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_mamba_scan: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import ref
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    plans = []
    for p in args.plans.split(","):
        threads, tile, *states = map(int, p.split(":"))
        plans.append((threads, tile, states[0] if states else 4))
    edits = {f"states{k}": [(STATES, STATES.replace("4", str(k)))]
             for _, _, k in plans if k != ref.STATES_A_LANE}
    if args.ablate:
        edits.update(ABLATIONS)
    changes = [v for v in args.variants.split(",") if v]
    edits.update({v: VARIANTS[v] for v in changes})
    libs = kv.edited("mamba_scan.cu", edits) if edits else {}
    lib = build.library()
    if args.sass:
        print("sass", json.dumps(_loop_sass(lib._name)), flush=True)
    old = None if args.baseline is None else kv.baseline(
        args.baseline, "repro_mamba_scan",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    default = (ref.SCAN_THREADS, ref.TIME_TILE, ref.STATES_A_LANE)

    def use(threads, tile, states):
        """The kernel at this layout: its library and the plan's knobs."""
        ref.SCAN_THREADS, ref.TIME_TILE, ref.STATES_A_LANE = (threads, tile,
                                                              states)
        return lib if states == default[2] else libs[f"states{states}"]

    def old_call(dt, x, bm, cm, a, h0):
        b, s, d = dt.shape
        y = torch.empty_like(dt)
        h = torch.empty_like(h0)
        rc = old(dt.data_ptr(), x.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                 a.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(), b,
                 s, d, a.shape[1], torch.cuda.current_stream().cuda_stream)
        build.check(rc, "baseline mamba_scan")
        return y, h

    def pair(other, kernel, n):
        return kv.pair(lambda f, k: cs.time_ms(torch, f, n=k), other, kernel,
                       n)

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
            torch, gen, [(b, s, D), (b, s, D), (b, s, N), (b, s, N), (D, N),
                         (b, D, N)], [0.1, None, None, None, -1.0, None])
        want = ref.mamba_scan_ref(*ops)
        exact = _scan64(torch, *ops)
        bnd, by = cs._mamba_bound(ops[0], N)
        row = {"shape": f"B={b} S={s} d={D} N={N}", "bound_ms": bnd,
               "bound_by": by,
               "plain_ms": cs.time_ms(torch, lambda: ref.mamba_scan_ref(*ops),
                                      n=3 if s > 1 else 20),
               "plain_err_f64": _err(want, exact)}
        n_new = 20 if name == "long_cold" else 50

        def new():
            return mamba_scan_cuda(*ops)
        if old is not None:
            row["baseline_err_f64"] = _err(old_call(*ops), exact)
        for threads, tile, states in plans:
            with kv.launching_from(use(threads, tile, states)):
                got = new()
                entry = {"plan": ref.scan_plan(s, D, N),
                         "max_abs_err": _err(got, want),
                         "err_f64": _err(got, exact)}
                if old is None:
                    entry["ms"] = [cs.time_ms(torch, new, n=n_new)
                                   for _ in range(2)]
                else:
                    entry["baseline_ms"], entry["ms"] = pair(
                        lambda: old_call(*ops), new,
                        3 if s > 300 else n_new)
            row[f"plan_{threads}:{tile}:{states}"] = entry
        kernel_lib = use(*plans[0])
        with kv.launching_from(kernel_lib):
            if name == "long_cold":
                row["clock_mhz"], row["power_w"] = kv.clock_during(torch, new)
        for v in changes:
            with kv.launching_from(libs[v]):
                got = new()
            row[f"variant_{v}"] = dict(zip(
                ("kernel_ms", "variant_ms"),
                pair(on(kernel_lib, new), on(libs[v], new), n_new)),
                max_abs_err=_err(got, want), err_f64=_err(got, exact),
                bitwise=all(g.equal(k) for g, k in
                            zip(got, on(kernel_lib, new)())))
        for part in ABLATIONS if args.ablate else ():
            row[f"ablate_{part}"] = dict(zip(("kernel_ms", "ablated_ms"), pair(
                on(kernel_lib, new), on(libs[part], new), n_new)))
        ref.SCAN_THREADS, ref.TIME_TILE, ref.STATES_A_LANE = default
        print(name, json.dumps(row), flush=True)
        del ops, want, exact
    return 0


if __name__ == "__main__":
    sys.exit(main())
