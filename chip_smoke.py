#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines and its seconds; any failure exits
non-zero without the final result line):

 1. environment and kernel build: the card's name and power limit, torch
    and CUDA versions, the nvcc build of every kernel from ``csrc/``;
 2. masked argmax, packed-word and byte-mask kernels vs the plain version
    on the card (bitwise), and the byte-mask kernel vs the packed kernel on
    the packed form of the same mask (bitwise): odd row strides and rows
    off a 16-byte boundary, float32, bfloat16 and float16 logits, ties on
    either side of the plan's split edges, a legal NaN (it never wins; the
    other rows equal the plain version), B=64 at V=262144, two calls
    bitwise equal; each timed at B=4 on a real vocabulary (V=100352 packed,
    129280 bytes) and at B=64 V=262144 (67 MB of logits, above the L2),
    beside its bound and a ``torch.argmax`` yardstick, with its split;
 3. decode attention, kernel vs plain version on the card: paged
    (shuffled tables, -1 vacancies, foreign pages poisoned with NaN) and
    contiguous, (S, Qh) in {(1, 1), (3, 1), (3, 2), (9, 7)} (63 query rows
    at the last, in tiles of 16), float32 (atol 1e-5: only the summation
    order differs) and bfloat16 (atol = rtol = 2e-2 in float32: about one
    bf16 ulp of the output); timed at B=4 with 1000 keys a row (the pool
    warm in the L2) and 4096 (a pool 2.7 times the L2), each with the key
    split it chose; and the split-score kernel of absorbed MLA at
    deepseek-v3's width (128 heads, latent 512, rope 64), paged and
    contiguous, S in {1, 2, 9}, float32 (CUDA cores; atol = rtol = 1e-4:
    576-long dot products in another order) and bfloat16 (tensor cores;
    2e-2), NaN-poisoned pools bitwise equal, two calls bitwise equal; timed
    in bfloat16 at B=4 with 1000 keys a row and 16384 (a 75.5 MB pool, 1.5
    times the L2), each with the key split it chose;
 4. the Mamba1 selective scan and the Mamba2 SSD scan, kernel vs plain
    version on the card in float32 (atol = rtol = 1e-4: the Mamba1 kernel
    walks the recurrence step by step, the SSD kernel computes the chunked
    form on the tensor cores in error-compensated TF32 with other chunks
    than the plain version, and the sums run in other orders), at the
    serving paths' decode and prefill shapes, with nonzero h0, and two
    calls that carry the state against one call over the whole sequence
    (bitwise for the Mamba1 scan); both scans also over a 2048-step prompt
    (timed beside their bounds) and at ragged widths (the Mamba1 scan 130
    channels with N = 5 and 12, the SSD scan 3 heads of D = 7 with N = 5);
    two SSD calls on the same inputs bitwise equal;
 5. serving, at its published width with random weights, through
    ``ServingEngine.generate_batch`` with the DOMINO JSON grammar, 4
    requests in 4 slots, 32 tokens each: stablelm-1.6b over a paged KV
    pool, then falcon-mamba-7b (Mamba1) and zamba2-1.2b (Mamba2 with a
    shared attention block) on dense rows of recurrent state, then
    deepseek-v3-671b (MLA + 256-expert MoE) over a paged latent pool, its
    depth cut to fit one card (``DEPTH``: 1 layer in float32, 2 in
    bfloat16; every width as published).  Each model's weights are freed
    before the next is drawn.  For each:
    (a) float32 through the kernels against the same requests through the
    plain path (greedy ids and statuses equal), (b) bfloat16 through the
    kernels (tokens/s, the tick's breakdown, launches a tick).  Every
    kernel counter is set to 0 just before a run and read just after it;
    a kernel of the model's path that did not launch, or launched another
    number of times than its layers say, fails the phase;
 6. the public ``masked_argmax`` op on byte masks (the entry point that
    reaches the byte-mask kernel, which no serving path calls): the
    deepseek-v3 bf16 run's ticks replayed through it with their masks
    unpacked to bytes, counters reset just before and read just after;
 7. each kernel's launches on the serving paths, its parity, and its time
    beside its plain version, its bound and a library yardstick, on the
    inputs a serving path gave it.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
MODELS = ("stablelm-1.6b", "falcon-mamba-7b", "zamba2-1.2b",
          "deepseek-v3-671b")
# depth cuts that fit one 80 GB card, by dtype (widths stay as published):
# one deepseek-v3 layer is 11.5 B parameters, the embedding and head 1.9 B
DEPTH = {"deepseek-v3-671b": {"float32": 1, "bfloat16": 2}}
N_REQUESTS = 4
MAX_TOKENS = 32
PAGE_SIZE = 64
MAX_LEN = 1024
SCAN_TOL = 1e-4
SPLIT_TOL = 1e-4           # split-score attention, float32
PROMPTS = ["A person encoded as a JSON object: ", "Results: ", "Config: ",
           "Data record: "]
# kernel name -> (package of its launch wrapper, the wrapper's name)
KERNELS = {
    "decode_attention": ("repro_torch.kernels.decode_attention",
                         "decode_attention_cuda"),
    "decode_attention_split": ("repro_torch.kernels.decode_attention",
                               "decode_attention_split_cuda"),
    "masked_argmax_packed": ("repro_torch.kernels.masked_sample",
                             "masked_argmax_packed"),
    "masked_argmax_bytes": ("repro_torch.kernels.masked_sample",
                            "masked_argmax_bytes"),
    "mamba_scan": ("repro_torch.kernels.mamba_scan", "mamba_scan_cuda"),
    "ssd_scan": ("repro_torch.kernels.ssd_scan", "ssd_scan_cuda"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def _wrappers():
    import importlib
    return {name: getattr(importlib.import_module(pkg + ".kernel"), fn)
            for name, (pkg, fn) in KERNELS.items()}


def reset_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in _wrappers().items()}


# -- timing ---------------------------------------------------------------------


def time_ms(torch, fn, n: int = 50) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls.  The card
    is first held busy so the host can queue every launch before the
    first runs: the events then time the card, not the host's launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- phase 1 --------------------------------------------------------------------


def phase_env(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"[build] kernels built from {build.CSRC.relative_to(ROOT)} in "
        f"{build.build_seconds if build.build_seconds is not None else time.perf_counter() - t0:.1f}s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")
    for fn, info in _ptxas_by_function(build.build_log).items():
        if "decode_attention_kernel" in fn \
                or "decode_attention_split_mma_kernel" in fn \
                or "mamba_scan_kernelILi4E" in fn \
                or "ssd_chunk_kernel" in fn or "ssd_decode_kernelILb1E" in fn:
            log(f"[build] {_demangle(fn)}: {info}")
    return card


def _ptxas_by_function(text):
    """ptxas -v's report, one line a kernel: registers, spills and static
    shared memory, by mangled name."""
    import re
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([A-Za-z0-9_]+)'?", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(fn, {})["spill"] = (f"spills {m.group(1)}/"
                                               f"{m.group(2)} B st/ld")
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            out.setdefault(fn, {})["regs"] = (
                f"{m.group(1)} registers, static smem "
                f"{m.group(2) or 0} B")
    return {fn: ", ".join(v[k] for k in ("regs", "spill") if k in v)
            for fn, v in out.items()}


def _demangle(name):
    """``name`` as C++ (``cu++filt`` beside nvcc), else as it is."""
    from repro_torch.kernels import build
    tool = pathlib.Path(build._nvcc()).parent / "cu++filt"
    if tool.exists():
        r = subprocess.run([str(tool), name], capture_output=True, text=True,
                           timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip()
    return name


# -- phase 2 --------------------------------------------------------------------


def _mask_case(torch, gen, b, v, stride, col0=0, dtype=None):
    """Strided logits (row stride > v, as the scheduler's padded view,
    starting at column ``col0``; float32 unless ``dtype``) and packed int32
    words with an all-zero row, a one-legal row and rows with deliberate
    ties."""
    dev = "cuda"
    full = torch.randn((b, stride), generator=gen, device=dev)
    if dtype is not None:
        full = full.to(dtype)
    logits = full[:, col0:col0 + v]
    w = -(-v // 32)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (b, w), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)
    if v % 32:
        bits[:, -1] &= (1 << (v % 32)) - 1      # tail bits past V are zero
    bits[0] = 0                                  # all-illegal row
    if b > 1:
        bits[1] = 0                              # one legal token
        t = v // 2
        bits[1, t // 32] = torch.tensor(1 << (t % 32), dtype=torch.int64) \
            .to(torch.int32)
    for r in range(2, b):                        # ties among legal tokens
        logits[r, : min(v, 64)] = 10.0
    return logits, bits


def _set_legal(torch, bits, r, t):
    bits[r, t // 32] |= torch.tensor(1 << (t % 32), dtype=torch.int64) \
        .to(torch.int32).item()


def _argmax_check(torch, what, logits, bits, want=None, rows=slice(None)):
    """Both kernels on ``logits`` (the byte kernel on the bool form of
    ``bits``), bitwise against ``want`` (default: the plain version) on
    ``rows`` and against each other everywhere; a second call of each
    bitwise equal to the first.  Returns the packed kernel's result."""
    from repro_torch.kernels.masked_sample.kernel import (masked_argmax_bytes,
                                                          masked_argmax_packed)
    from repro_torch.kernels.masked_sample.ref import (masked_argmax_ref,
                                                       unpack_bits)
    mask = unpack_bits(bits, logits.shape[1])
    if want is None:
        want = masked_argmax_ref(logits, bits)
    got_p = masked_argmax_packed(logits, bits)
    got_b = masked_argmax_bytes(logits, mask)
    pairs = ((got_p, masked_argmax_packed(logits, bits), "a second call"),
             (got_b, masked_argmax_bytes(logits, mask), "a second call"),
             (got_b, got_p, "the packed kernel"))
    torch.cuda.synchronize()
    for name, (i1, v1) in (("packed", got_p), ("byte-mask", got_b)):
        if not (torch.equal(i1[rows], want[0][rows])
                and torch.equal(v1[rows], want[1][rows])):
            bad = (i1[rows] != want[0][rows]).nonzero().flatten()[:4].tolist()
            raise AssertionError(f"{name} argmax, {what}: kernel differs from "
                                 f"the plain version at rows {bad}")
    for (i1, v1), (i2, v2), other in pairs:
        if not (torch.equal(i1, i2) and torch.equal(v1, v2)):
            raise AssertionError(f"argmax, {what}: a result differs from "
                                 f"{other}")
    return got_p


def _argmax_timing(torch, layout, logits, bits):
    """{ms, plain_ms, bound_ms} of one kernel on (B, V) float32 logits,
    logged beside the plan and the ``torch.argmax`` yardstick over the same
    unmasked logits (not the same function: it goes on the log line only)."""
    from repro_torch.kernels.masked_sample.kernel import (masked_argmax_bytes,
                                                          masked_argmax_packed)
    from repro_torch.kernels.masked_sample.ref import (argmax_plan,
                                                       masked_argmax_ref,
                                                       unpack_bits)
    b, v = logits.shape
    if layout == "packed":
        fn, mask = masked_argmax_packed, bits
        n_bytes = b * v * 4 + bits.numel() * 4 + b * 8
    else:
        fn, mask = masked_argmax_bytes, unpack_bits(bits, v)
        n_bytes = b * v * 5 + b * 8
    bnd, _ = bound_ms(n_bytes, b * v, "float32")
    out = {"shape": f"B={b} V={v} float32",
           "ms": time_ms(torch, lambda: fn(logits, mask)),
           "plain_ms": time_ms(torch, lambda: masked_argmax_ref(logits, mask),
                               n=10),
           "bound_ms": bnd}
    yard = time_ms(torch, lambda: torch.argmax(logits, dim=-1))
    plan = argmax_plan(b, v)
    log(f"[argmax] {layout} B={b} V={v}: kernel {out['ms']:.4f} ms "
        f"(n_split {plan.n_split} of {plan.split_len} tokens), plain "
        f"{out['plain_ms']:.4f} ms, bound {bnd:.5f} ms (bytes), yardstick "
        f"torch.argmax {yard:.4f} ms")
    return out


def phase_masked_argmax(torch):
    """Both argmax kernels against the plain version and each other, bit
    for bit: bool and int8 byte masks, odd row strides and rows off a
    16-byte boundary, bfloat16 and
    float16 logits, ties on either side of a split edge, a NaN row, B=64 at
    V=262144, two calls equal; then each timed at B=4 on a real vocabulary
    ("long") and at B=64 V=262144 ("long_cold").  Returns {layout: {"long":
    ..., "long_cold": ...}}."""
    from repro_torch.kernels.masked_sample.kernel import (masked_argmax_bytes,
                                                          masked_argmax_packed)
    from repro_torch.kernels.masked_sample.ref import (argmax_plan,
                                                       masked_argmax_ref,
                                                       unpack_bits)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for b in (1, 4, 64):
        for v in (400, 100352, 1001):
            logits, bits = _mask_case(torch, gen, b, v, v + 96)
            _argmax_check(torch, f"B={b} V={v}", logits, bits)
            log(f"[argmax] B={b} V={v}: bitwise equal")
    # the byte-mask kernel: bool and int8 masks (any nonzero byte legal),
    # bitwise against the plain version and the packed kernel
    for b in (4, 64):
        for v in (403, 129280):
            logits, bits = _mask_case(torch, gen, b, v, v + 96)
            i_w, v_w = masked_argmax_packed(logits, bits)
            for name, mask in (("bool", unpack_bits(bits, v)),
                               ("int8", unpack_bits(bits, v).to(torch.int8)
                                * -3)):
                i1, v1 = masked_argmax_bytes(logits, mask)
                i2, v2 = masked_argmax_ref(logits, mask)
                torch.cuda.synchronize()
                for what, (i3, v3) in (("plain", (i2, v2)),
                                       ("packed kernel", (i_w, v_w))):
                    if not (torch.equal(i1, i3) and torch.equal(v1, v3)):
                        bad = (i1 != i3).nonzero().flatten()[:4].tolist()
                        raise AssertionError(
                            f"byte-mask argmax B={b} V={v} {name}: kernel "
                            f"differs from the {what} at rows {bad}")
                if i1[0].item() != 0 \
                        or v1[0].item() != torch.tensor(-1e30).item():
                    raise AssertionError("byte-mask argmax: all-illegal row")
            log(f"[argmax] byte mask B={b} V={v} bool and int8: bitwise "
                "equal to plain and to the packed kernel")
    # odd row strides and rows that start off a 16-byte boundary, in
    # float32, bfloat16 and float16 (widened exactly in the kernel)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for b, v, stride, col0 in ((4, 100352, 100353, 0),
                                   (4, 129280, 129283, 1), (64, 1001, 1009, 3),
                                   (4, 403, 100352, 0)):
            logits, bits = _mask_case(torch, gen, b, v, stride, col0, dtype)
            _argmax_check(torch, f"B={b} V={v} {dtype} stride "
                          f"{logits.stride(0)} from column {col0}", logits,
                          bits)
        log(f"[argmax] {dtype}: odd strides and unaligned rows bitwise equal")
    # an equal maximum on either side of every split edge (row 2), and in
    # the last token of one split and the first of the next only (row 3)
    for b, v in ((4, 100352), (64, 262144)):
        logits, bits = _mask_case(torch, gen, b, v, v + 1)
        plan = argmax_plan(b, v)
        edges = [s * plan.split_len for s in range(1, plan.n_split)]
        for r, toks in ((2, [t for e in edges for t in (e - 1, e)]),
                        (3, [edges[-1] - 1, edges[-1]])):
            logits[r] = torch.where(logits[r] >= 10.0, 0.0, logits[r])
            for t in toks:
                logits[r, t] = 20.0
                _set_legal(torch, bits, r, t)
        i1, _ = _argmax_check(torch, f"ties across split edges B={b} V={v}",
                              logits, bits)
        if i1[2].item() != edges[0] - 1 or i1[3].item() != edges[-1] - 1:
            raise AssertionError("argmax: a tie across a split edge went to "
                                 "the higher index")
        log(f"[argmax] B={b} V={v}: ties across {len(edges)} split edges go "
            "to the lower index")
    # a legal NaN in one split: never wins, and the other rows are the
    # plain version's
    for b, v in ((4, 100352), (4, 403)):
        logits, bits = _mask_case(torch, gen, b, v, v)
        t = v // 3
        logits[1, t] = float("nan")
        _set_legal(torch, bits, 1, t)
        no_nan = logits.clone()
        no_nan[1, t] = float("-inf")
        _argmax_check(torch, f"NaN row B={b} V={v}", logits, bits,
                      want=masked_argmax_ref(no_nan, bits))
        _argmax_check(torch, f"rows beside a NaN row B={b} V={v}", logits,
                      bits, rows=slice(2, None))
        log(f"[argmax] NaN row B={b} V={v}: the NaN never wins, the other "
            "rows equal the plain version")
    logits, bits = _mask_case(torch, gen, 64, 262144, 262144)
    _argmax_check(torch, "B=64 V=262144", logits, bits)
    log("[argmax] B=64 V=262144: both kernels bitwise equal to plain, to "
        "each other and to a second call")
    out = {"packed": {"long_cold": _argmax_timing(torch, "packed", logits,
                                                  bits)},
           "bytes": {"long_cold": _argmax_timing(torch, "bytes", logits,
                                                 bits)}}
    del logits, bits
    for layout, v in (("packed", 100352), ("bytes", 129280)):
        logits, bits = _mask_case(torch, gen, 4, v, v)
        out[layout]["long"] = _argmax_timing(torch, layout, logits, bits)
    return out


# -- phase 3 --------------------------------------------------------------------


def _paged_case(torch, gen, dtype, s_win, qh, lens, poison, mp=20):
    b, g, d, ps = len(lens), 32, 64, PAGE_SIZE
    n_pages = 1 + b * mp
    kp = torch.randn((n_pages, ps, g, d), generator=gen, device="cuda")
    vp = torch.randn((n_pages, ps, g, d), generator=gen, device="cuda")
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1) \
        .tolist()
    tbl = torch.full((b, mp), -1, dtype=torch.int32)
    owned = []
    for i, ln in enumerate(lens):
        n = -(-(ln + s_win - 1) // ps)
        tbl[i, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        owned += perm[:n]
        del perm[:n]
    if poison:
        foreign = torch.ones(n_pages, dtype=torch.bool)
        foreign[owned] = False
        kp[foreign.cuda()] = float("nan")
        vp[foreign.cuda()] = float("nan")
    q = torch.randn((b, s_win, g, qh, d), generator=gen, device="cuda")
    return (q.to(dtype), kp.to(dtype), vp.to(dtype),
            torch.tensor(lens, dtype=torch.int32, device="cuda"),
            tbl.cuda())


def _check_attn(torch, got, want, dtype, what):
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = (got.float() - want.float()).abs().max().item()
    bad = not torch.allclose(got.float(), want.float(), atol=tol,
                             rtol=0.0 if dtype == torch.float32 else tol)
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"decode attention {what}: max abs err {err}")
    return err


def phase_decode_attention(torch):
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, gather_pages)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    lens = [0, 1, 63, 64, 65, 1000]
    for dtype in (torch.float32, torch.bfloat16):
        for s_win, qh in ((1, 1), (3, 1), (3, 2), (9, 7)):
            gen.manual_seed(3)
            clean = _paged_case(torch, gen, dtype, s_win, qh, lens, False)
            gen.manual_seed(3)
            dirty = _paged_case(torch, gen, dtype, s_win, qh, lens, True)
            q, kp, vp, ln, tbl = clean
            out = decode_attention_cuda(q, kp, vp, ln, block_tables=tbl)
            out_dirty = decode_attention_cuda(*dirty[:4],
                                              block_tables=dirty[4])
            want = decode_attention_ref(q, kp, vp, ln, block_tables=tbl)
            torch.cuda.synchronize()
            err = _check_attn(torch, out, want, dtype,
                              f"paged {dtype} S={s_win} Qh={qh}")
            if not torch.equal(out, out_dirty):
                raise AssertionError("decode attention: NaN in foreign pages "
                                     "changed the output")
            if s_win == 1 and out[0].abs().max().item() != 0.0:
                raise AssertionError("decode attention: empty row not 0")
            # contiguous mode: the same rows as dense stripes
            kd = gather_pages(kp, tbl).contiguous()
            vd = gather_pages(vp, tbl).contiguous()
            out_c = decode_attention_cuda(q, kd, vd, ln)
            want_c = decode_attention_ref(q, kd, vd, ln)
            torch.cuda.synchronize()
            err_c = _check_attn(torch, out_c, want_c, dtype,
                                f"contiguous {dtype} S={s_win} Qh={qh}")
            log(f"[attn] {str(dtype).split('.')[-1]} S={s_win} Qh={qh} "
                f"lens={lens}: paged err {err:.2e}, poisoned pool bitwise "
                f"equal, contiguous err {err_c:.2e}")
    timed = {}
    for name, keys, mp in (("long", 1000, 20), ("long_cold", 4096, 64)):
        gen.manual_seed(4)
        q, kp, vp, ln, tbl = _paged_case(torch, gen, torch.bfloat16, 1, 1,
                                         [keys] * 4, False, mp=mp)
        k_ms = time_ms(torch, lambda: decode_attention_cuda(
            q, kp, vp, ln, block_tables=tbl))
        p_ms = time_ms(torch, lambda: decode_attention_ref(
            q, kp, vp, ln, block_tables=tbl))
        lib_ms = time_ms(torch, _sdpa_yardstick(torch, q, kp, vp, ln, tbl))
        bnd, by = _attn_bound(q, kp, ln, tbl, "bfloat16")
        pool_mb = 2 * kp.numel() * kp.element_size() / 1e6
        shape = (f"B=4 S=1 G=32 Qh=1 D=64 bf16, {keys} keys a row over "
                 f"{PAGE_SIZE}-key pages, K+V pool {pool_mb:.1f} MB")
        log(f"[attn] {name}: {shape}: {_plan_text(q, kp, tbl)}; kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library {lib_ms:.4f} ms, "
            f"bound {bnd:.5f} ms by {by} ({bnd / k_ms:.0%} of it)")
        timed[name] = {"shape": shape, "ms": k_ms, "plain_ms": p_ms,
                       "library_ms": lib_ms, "bound_ms": bnd}
    return timed


def _plan_text(q, kp, tbl):
    """The key split the plain-score kernel takes at these shapes, and its
    dynamic shared memory a block."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.kernel import _DTYPES
    from repro_torch.kernels.decode_attention.ref import key_split_plan
    b, s_win, g, qh, dk = q.shape
    n_tiles = 1 if tbl is None else tbl.shape[1]
    n_split, split_len = key_split_plan(b, g, kp.shape[1], n_tiles,
                                        tbl is not None)
    smem = build.library().repro_decode_attention_smem(
        _DTYPES[q.dtype], s_win * qh, dk, dk)
    return (f"n_split {n_split} x {split_len} keys, grid ({b * g}, "
            f"{n_split}) of 128 threads, {smem} B dynamic smem a block")


def _split_case(torch, gen, dtype, s_win, lens, poison, h=128, r=512,
                d2=64, mp=20):
    """Absorbed-MLA split-score inputs at deepseek-v3's width: q_lat
    (B,S,1,h,r), q_rope (B,S,1,h,d2), a latent pool (n_pages, 64, 1, r) --
    key and value -- and a rope pool (n_pages, 64, 1, d2), lengths and a
    shuffled table of ``mp`` entries a row with -1 vacancies; pages no row
    owns poisoned with NaN when ``poison``."""
    b, ps = len(lens), PAGE_SIZE
    n_pages = 1 + b * mp
    lat = torch.randn((n_pages, ps, 1, r), generator=gen, device="cuda")
    rp = torch.randn((n_pages, ps, 1, d2), generator=gen, device="cuda")
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1) \
        .tolist()
    tbl = torch.full((b, mp), -1, dtype=torch.int32)
    owned = []
    for i, ln in enumerate(lens):
        n = -(-(ln + s_win - 1) // ps)
        tbl[i, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        owned += perm[:n]
        del perm[:n]
    if poison:
        foreign = torch.ones(n_pages, dtype=torch.bool)
        foreign[owned] = False
        lat[foreign.cuda()] = float("nan")
        rp[foreign.cuda()] = float("nan")
    q = torch.randn((b, s_win, 1, h, r), generator=gen, device="cuda")
    q2 = torch.randn((b, s_win, 1, h, d2), generator=gen, device="cuda")
    return (q.to(dtype), q2.to(dtype), lat.to(dtype), rp.to(dtype),
            torch.tensor(lens, dtype=torch.int32, device="cuda"), tbl.cuda())


def _check_split(torch, got, want, dtype, what):
    tol = SPLIT_TOL if dtype == torch.float32 else 2e-2
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) \
            or not torch.isfinite(got).all():
        raise AssertionError(f"split-score attention {what}: max abs err "
                             f"{err} beyond atol = rtol = {tol}")
    return err


def _split_plan_text(q, q2, lat, tbl):
    """The key split the bfloat16 split-score kernel takes at these shapes,
    and its dynamic shared memory a block."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.ref import (SCORE_ROWS,
                                                          split_score_plan)
    b, s_win, g, qh, r = q.shape
    n_tiles = 1 if tbl is None else tbl.shape[1]
    n_split, split_len = split_score_plan(b, g, s_win * qh, lat.shape[1],
                                          n_tiles, tbl is not None)
    tiles = -(-(s_win * qh) // SCORE_ROWS)
    smem = build.library().repro_decode_attention_split_smem(
        r, q2.shape[-1])
    rows = n_split * b * g * s_win * qh
    scratch = 0 if n_split == 1 else rows * (r + 4) * 4
    return (f"n_split {n_split} x {split_len} keys, grid ({tiles}, {n_split}, "
            f"{b * g}) of 512 threads, {smem} B dynamic smem a block, "
            f"scratch {scratch / 1e6:.2f} MB")


def phase_split_attention(torch):
    """The split-score kernel against its plain version at deepseek-v3's
    width; returns {"long": ..., "long_cold": ...} (the shape, ms, plain
    ms, library ms and bound ms) at B=4, 1000 and 16384 keys a row, bf16."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_split_cuda as split
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, gather_pages)
    gen = torch.Generator(device="cuda")
    scale = 1.0 / math.sqrt(192)
    lens = [0, 1, 63, 64, 65, 1000]
    for dtype in (torch.float32, torch.bfloat16):
        for s_win in (1, 2, 9):
            gen.manual_seed(6)
            q, q2, lat, rp, ln, tbl = _split_case(torch, gen, dtype, s_win,
                                                  lens, False)
            gen.manual_seed(6)
            dirty = _split_case(torch, gen, dtype, s_win, lens, True)
            out = split(q, lat, lat, q2, rp, ln, scale=scale,
                        block_tables=tbl)
            out_dirty = split(dirty[0], dirty[2], dirty[2], dirty[1],
                              dirty[3], dirty[4], scale=scale,
                              block_tables=dirty[5])
            want = decode_attention_ref(q, lat, lat, ln, scale=scale, q2=q2,
                                        k2=rp, block_tables=tbl)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            err = _check_split(torch, out, want, dtype,
                               f"paged {name} S={s_win}")
            if not torch.equal(out, out_dirty):
                raise AssertionError("split-score attention: NaN in foreign "
                                     "pages changed the output")
            if not torch.equal(out, split(q, lat, lat, q2, rp, ln,
                                          scale=scale, block_tables=tbl)):
                raise AssertionError("split-score attention: two calls "
                                     "differ")
            if out[0, 0].abs().max().item() != 0.0:
                raise AssertionError("split-score attention: empty row not 0")
            kd = gather_pages(lat, tbl).contiguous()
            k2d = gather_pages(rp, tbl).contiguous()
            out_c = split(q, kd, kd, q2, k2d, ln, scale=scale)
            want_c = decode_attention_ref(q, kd, kd, ln, scale=scale, q2=q2,
                                          k2=k2d)
            torch.cuda.synchronize()
            err_c = _check_split(torch, out_c, want_c, dtype,
                                 f"contiguous {name} S={s_win}")
            log(f"[split] {name} S={s_win} H=128 R=512 D2=64 lens={lens}: "
                f"paged err {err:.2e}, poisoned pool bitwise equal, two calls "
                f"bitwise equal, contiguous err {err_c:.2e}")
    timed = {}
    for what, keys, mp in (("long", 1000, 20), ("long_cold", 16384, 256)):
        gen.manual_seed(7)
        q, q2, lat, rp, ln, tbl = _split_case(torch, gen, torch.bfloat16, 1,
                                              [keys] * 4, False, mp=mp)
        k_ms = time_ms(torch, lambda: split(q, lat, lat, q2, rp, ln,
                                            scale=scale, block_tables=tbl))
        p_ms = time_ms(torch, lambda: decode_attention_ref(
            q, lat, lat, ln, scale=scale, q2=q2, k2=rp, block_tables=tbl),
            n=10)
        lib_ms = time_ms(torch, _split_sdpa_yardstick(torch, q, q2, lat, rp,
                                                      ln, tbl, scale), n=10)
        bnd, by = _split_bound(q, q2, lat, ln, tbl, "bfloat16")
        pool_mb = (lat.numel() + rp.numel()) * lat.element_size() / 1e6
        shape = (f"B=4 S=1 H=128 R=512 D2=64 bf16, {keys} keys a row over "
                 f"{PAGE_SIZE}-key pages, latent + rope pool {pool_mb:.1f} MB")
        log(f"[split] {what}: {shape}: "
            f"{_split_plan_text(q, q2, lat, tbl)}; "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms, bound {bnd:.5f} ms by {by} "
            f"({bnd / k_ms:.0%} of it)")
        timed[what] = {"shape": shape, "ms": k_ms, "plain_ms": p_ms,
                       "library_ms": lib_ms, "bound_ms": bnd}
        del q, q2, lat, rp
    return timed


def _split_sdpa_yardstick(torch, q, q2, lat, rp, ln, tbl, scale):
    """One library attention call computing the split score's function:
    queries [q || q2] against keys [latent || rope] with the latent as
    values (Dk = R + D2, Dv = R), pages gathered and concatenated
    beforehand (not timed).  A yardstick only: the port never calls it."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ref import gather_pages
    b, s_win, g, qh, r = q.shape
    kd, k2d = (lat, rp) if tbl is None else (gather_pages(lat, tbl),
                                              gather_pages(rp, tbl))
    t = kd.shape[1]
    qs = torch.cat([q, q2], -1).permute(0, 2, 3, 1, 4).reshape(
        b, g * qh, s_win, -1)
    ks = torch.cat([kd, k2d], -1).permute(0, 2, 1, 3) \
        .repeat_interleave(qh, dim=1)
    vs = kd.permute(0, 2, 1, 3).repeat_interleave(qh, dim=1)
    lim = ln.long()[:, None] + torch.arange(s_win, device=q.device)
    mask = (torch.arange(t, device=q.device)[None, None, :]
            < lim[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  scale=scale)


def _split_bound(q, q2, lat, ln, tbl, dtype):
    """Each visible key's latent and rope rows read once, q, q2 read and
    the output written once; 2 (R + D2) + 2 R flops a (key, query row)."""
    b, s_win, g, qh, r = q.shape
    d2 = q2.shape[-1]
    cap = lat.shape[1] if tbl is None else tbl.shape[1] * lat.shape[1]
    keys = sum(max(0, min(int(x) + s_win - 1, cap)) for x in ln.tolist())
    pairs = sum(max(0, min(int(x) + s, cap)) for x in ln.tolist()
                for s in range(s_win)) * g * qh
    esize = q.element_size()
    n_bytes = (keys * g * (r + d2) * esize + b * s_win * g * qh
               * (2 * r + d2) * esize + ln.numel() * 4
               + (0 if tbl is None else tbl.numel() * 4))
    return bound_ms(n_bytes, pairs * (4 * r + 2 * d2), dtype)


def _sdpa_yardstick(torch, q, kp, vp, ln, tbl):
    """One fused library attention call over the same rows as the kernel,
    pages gathered beforehand (the gather is not timed; ``tbl`` None reads
    ``kp``/``vp`` as contiguous stripes).  A yardstick only: the port never
    calls it."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ref import gather_pages
    bq, s_win, g, qh, d = q.shape
    if tbl is None:
        kd, vd = kp, vp
    else:
        kd, vd = gather_pages(kp, tbl), gather_pages(vp, tbl)
    t = kd.shape[1]
    qs = q.permute(0, 2, 3, 1, 4).reshape(bq, g * qh, s_win, d)
    ks = kd.permute(0, 2, 1, 3).repeat_interleave(qh, dim=1)
    vs = vd.permute(0, 2, 1, 3).repeat_interleave(qh, dim=1)
    lim = ln.long()[:, None] + torch.arange(s_win, device=q.device)
    mask = (torch.arange(t, device=q.device)[None, None, :]
            < lim[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                  attn_mask=mask)


def _attn_bound(q, kp, ln, tbl, dtype):
    b, s_win, g, qh, d = q.shape
    cap = kp.shape[1] if tbl is None else tbl.shape[1] * kp.shape[1]
    keys = sum(max(0, min(int(x) + s_win - 1, cap)) for x in ln.tolist())
    esize = q.element_size()
    n_bytes = (keys * g * 2 * d * esize + 2 * q.numel() * esize
               + ln.numel() * 4 + (0 if tbl is None else tbl.numel() * 4))
    n_ops = keys * g * qh * s_win * 4 * d
    return bound_ms(n_bytes, n_ops, dtype)


# -- phase 4 --------------------------------------------------------------------


def _mamba_bound(dt, n):
    """Each operand read once, y and hT written once; 7 operations a
    (row, step, channel, state): dt*A, exp, two products and a sum for
    the update, a product and a sum for y."""
    b, s, d = dt.shape
    n_bytes = 4 * (3 * b * s * d + 2 * b * s * n + d * n + 2 * b * d * n)
    return bound_ms(n_bytes, 7 * b * s * d * n, "float32")


def _ssd_bytes(x, n):
    """Each operand read once, y and hT written once."""
    b, s, h, d = x.shape
    return 4 * (2 * b * s * h * d + 2 * b * s * n + 2 * b * s * h
                + 2 * b * h * d * n)


def _ssd_bound(x, n):
    """The bytes, or the operations at the rate of the units that can do
    them.  S = 1: the recurrence's 5 a (row, head, dim, state) at the
    float32 rate.  S > 1: the chunked form's products in 64-step chunks
    (the last ragged), as three TF32 passes at the TF32 rate (the least
    time for float32-accurate products on this card): a chunk of l steps
    takes l (l + 1) / 2 N multiply-adds a row for the causal C B^T, shared
    by the heads, and, a head, l (l + 1) / 2 D for (G o M) (x dt) and
    l D N each for C h^T and the state update; two operations each."""
    b, s, h, d = x.shape
    if s == 1:
        return bound_ms(_ssd_bytes(x, n), 5 * b * h * d * n, "float32")
    ls = [min(64, s - t) for t in range(0, s, 64)]
    macs = b * sum(l * (l + 1) // 2 * (n + h * d) + 2 * h * l * d * n
                   for l in ls)
    return bound_ms(_ssd_bytes(x, n), 3 * 2 * macs, "tf32")


def _ssd_recurrence_ms(x, n):
    """The recurrence's 5 operations a (row, step, head, dim, state) at the
    float32 rate: the figure earlier runs used as #5's bound, computed."""
    b, s, h, d = x.shape
    return 5 * b * s * h * d * n / PEAK_OPS["float32"] * 1e3


def _scan_err(torch, got, want, what):
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    ok = all(torch.allclose(g, w, atol=SCAN_TOL, rtol=SCAN_TOL)
             and torch.isfinite(g).all() for g, w in zip(got, want))
    if not ok:
        raise AssertionError(f"{what}: max abs err {err} beyond atol = rtol "
                             f"= {SCAN_TOL}")
    return err


def _scan_inputs(torch, gen, shapes, scales):
    """Normal draws on the card, scaled: a positive scale takes |N|, a
    negative one -|N| (decays), None plain N(0, 1)."""
    out = []
    for shape, sc in zip(shapes, scales):
        x = torch.randn(shape, generator=gen, device="cuda")
        out.append(x if sc is None else x.abs() * sc)
    return out


def phase_scans(torch):
    """Both scan kernels against their plain versions at the serving
    paths' shapes, a 2048-step prompt and ragged widths (the Mamba1 scan
    N = 5 and 12, the SSD scan D = 7 and N = 5); returns {kernel: {"long":
    {...}, "long_cold": {...}}} at a 300- and a 2048-step prompt.  A Mamba1
    call split in two and carried must give one call's bits; two SSD calls
    on the same inputs must give equal bits."""
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    # the long prompt and the ragged widths draw from a generator of their
    # own, so the serving shapes and the SSD scan's keep their inputs
    extra = torch.Generator(device="cuda")
    extra.manual_seed(8)
    out = {}
    # falcon-mamba-7b: d_inner 8192, N 16; decode B=4, prefill B=1, and a
    # 2048-step prompt (201 MB of dt, x and y: four times the L2); then
    # ragged widths with N = 5 (the scalar state path) and 12 (padding lanes)
    out["mamba_scan"] = {}
    for b, s, d, n, g in ((4, 1, 8192, 16, gen), (1, 1, 8192, 16, gen),
                          (1, 37, 8192, 16, gen), (1, 128, 8192, 16, gen),
                          (1, 300, 8192, 16, gen), (1, 2048, 8192, 16, extra),
                          (2, 33, 130, 5, extra), (2, 33, 130, 12, extra)):
        dt, x, bm, cm, a, h0 = _scan_inputs(
            torch, g, [(b, s, d), (b, s, d), (b, s, n), (b, s, n), (d, n),
                       (b, d, n)], [0.1, None, None, None, -1.0, None])
        got = mamba_scan_cuda(dt, x, bm, cm, a, h0)
        want = mamba_scan_ref(dt, x, bm, cm, a, h0)
        torch.cuda.synchronize()
        err = _scan_err(torch, got, want, f"mamba_scan B={b} S={s}")
        cont = ""
        if s > 1:
            c = s // 2
            y1, h1 = mamba_scan_cuda(*[t[:, :c].contiguous()
                                       for t in (dt, x, bm, cm)], a, h0)
            y2, h2 = mamba_scan_cuda(*[t[:, c:].contiguous()
                                       for t in (dt, x, bm, cm)], a, h1)
            torch.cuda.synchronize()
            if not (torch.equal(torch.cat([y1, y2], 1), got[0])
                    and torch.equal(h2, got[1])):
                raise AssertionError(f"mamba_scan B={b} S={s} d={d} N={n}: "
                                     f"{c}+{s - c} steps carried differ "
                                     "from one call")
            cont = f", {c}+{s - c} steps carried bitwise equal to one call"
        if d != 8192:
            log(f"[scan] mamba_scan B={b} S={s} d={d} N={n}, nonzero h0: "
                f"err {err:.2e} (tol {SCAN_TOL}){cont}")
            continue
        k_ms = time_ms(torch, lambda: mamba_scan_cuda(dt, x, bm, cm, a, h0),
                       n=20 if s > 300 else 50)
        p_ms = time_ms(torch, lambda: mamba_scan_ref(dt, x, bm, cm, a, h0),
                       n=3 if s > 300 else 5 if s > 1 else 50)
        bnd, by = _mamba_bound(dt, n)
        log(f"[scan] mamba_scan B={b} S={s} d={d} N={n}, nonzero h0: err "
            f"{err:.2e} (tol {SCAN_TOL}){cont}; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {bnd:.5f} ms by {by}")
        key = {300: "long", 2048: "long_cold"}.get(s)
        if key:
            out["mamba_scan"][key] = {
                "shape": f"B={b} S={s} d={d} N={n}", "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": bnd}
    # zamba2-1.2b: 64 heads of 64, N 64; decode B=4, prefill B=1, and a
    # 2048-step prompt (71 MB of operands, above the L2); then 3 heads of
    # D = 7 with N = 5 (scalar staging, a ragged last chunk)
    out["ssd_scan"] = {}
    for b, s, h, hd, n, g in ((4, 1, 64, 64, 64, gen), (1, 37, 64, 64, 64, gen),
                              (1, 128, 64, 64, 64, gen),
                              (1, 300, 64, 64, 64, gen),
                              (1, 2048, 64, 64, 64, extra),
                              (2, 129, 3, 7, 5, extra)):
        x, bm, cm, ld, dt, h0 = _scan_inputs(
            torch, g, [(b, s, h, hd), (b, s, n), (b, s, n), (b, s, h),
                       (b, s, h), (b, h, hd, n)],
            [None, None, None, -0.3, 0.2, None])
        chunk = min(128, s)
        got = ssd_scan_cuda(x, bm, cm, ld, dt, h0)
        again = ssd_scan_cuda(x, bm, cm, ld, dt, h0)
        want = ssd_scan_ref(x, bm, cm, ld, dt, h0, chunk=chunk)
        torch.cuda.synchronize()
        what = f"ssd_scan B={b} S={s} H={h} D={hd} N={n}"
        err = _scan_err(torch, got, want, what)
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"{what}: two calls differ")
        cont = ""
        if s > 1:
            c = s // 2
            y1, h1 = ssd_scan_cuda(*[t[:, :c].contiguous()
                                     for t in (x, bm, cm, ld, dt)], h0)
            y2, h2 = ssd_scan_cuda(*[t[:, c:].contiguous()
                                     for t in (x, bm, cm, ld, dt)], h1)
            torch.cuda.synchronize()
            e2 = _scan_err(torch, (torch.cat([y1, y2], 1), h2), got,
                           f"ssd_scan continuity B={b} S={s}")
            cont = f", {c}+{s - c} steps carried vs one call err {e2:.2e}"
        if hd != 64:
            log(f"[scan] {what}, nonzero h0: err {err:.2e} (tol {SCAN_TOL})"
                f"{cont}; two calls bitwise equal")
            continue
        k_ms = time_ms(torch, lambda: ssd_scan_cuda(x, bm, cm, ld, dt, h0),
                       n=20 if s > 300 else 50)
        p_ms = time_ms(torch, lambda: ssd_scan_ref(x, bm, cm, ld, dt, h0,
                                                   chunk=chunk),
                       n=3 if s > 300 else 10)
        bnd, by = _ssd_bound(x, n)
        log(f"[scan] {what}, nonzero h0: err {err:.2e} (tol {SCAN_TOL})"
            f"{cont}; two calls bitwise equal; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms (chunk {chunk}), bound {bnd:.5f} ms by {by}; "
            f"the recurrence at the float32 rate {_ssd_recurrence_ms(x, n):.5f}"
            " ms (computed)")
        key = {300: "long", 2048: "long_cold"}.get(s)
        if key:
            out["ssd_scan"][key] = {
                "shape": f"B={b} S={s} H={h} D={hd} N={n}", "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": bnd}
    return out


# -- phase 5 --------------------------------------------------------------------


class Recorder:
    """Keeps the inputs of the serving path's kernel calls (every
    ``keep_every``-th call, for timing and parity on exactly those inputs)
    while the call goes through the real wrapper, which does its own
    launch counting."""

    def __init__(self, module, name, keep_every=1):
        self.module, self.name, self.every = module, name, keep_every
        self.fn = getattr(module, name)
        self.calls = []
        self.n = 0

    def __enter__(self):
        def wrapped(*args, **kw):
            if self.n % self.every == 0:
                self.calls.append((args, kw))
            self.n += 1
            return self.fn(*args, **kw)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class PhaseTimer:
    """Host seconds spent in each phase of the scheduler's tick, summed over
    a run (a wrapper costs a few microseconds a call).  ``_run_decode`` is
    the forward, the mask builds overlapped with it, and the wait for it."""
    PHASES = ("_admit", "_ensure_pages", "_choose", "_commit_first",
              "_run_decode")

    def __init__(self, cls):
        self.cls = cls
        self.seconds = dict.fromkeys(self.PHASES, 0.0)

    def __enter__(self):
        self.orig = {n: getattr(self.cls, n) for n in self.PHASES}
        for name, fn in self.orig.items():
            def wrapped(*args, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    self.seconds[_name] += time.perf_counter() - t0
            setattr(self.cls, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.cls, name, fn)


def path_kernels(cfg):
    """The kernels a decode tick of ``cfg`` launches, each with its
    launches per decode forward and per admission prefill."""
    head, reps, group, tail = cfg.layer_program
    blocks = list(head) + list(group) * reps + list(tail)
    mla = [b == "mla" or (b == "moe" and cfg.mla is not None)
           for b in blocks]
    n_attn = sum(b in ("attn", "shared_attn", "moe") and not m
                 for b, m in zip(blocks, mla))
    out = {"masked_argmax_packed": None}      # one a selection tick
    if n_attn:
        out["decode_attention"] = (n_attn, 0)  # prefill attends densely
    if sum(mla):                               # prefill runs full MLA
        out["decode_attention_split"] = (sum(mla), 0)
    if blocks.count("mamba1"):
        out["mamba_scan"] = (blocks.count("mamba1"),) * 2
    if blocks.count("mamba2") and cfg.ssm.n_groups == 1:
        out["ssd_scan"] = (blocks.count("mamba2"),) * 2
    return out


def check_launches(cfg, counts, stats, what):
    """Fail unless every kernel of the path launched, and the per-layer
    kernels exactly once a layer of every forward."""
    n_dec = stats["n_decode"]
    n_pre = stats["n_fwd"] - n_dec
    for name, per in path_kernels(cfg).items():
        if counts[name] == 0:
            raise AssertionError(f"{what}: {name} never launched")
        if per is not None and counts[name] != per[0] * n_dec + per[1] * n_pre:
            raise AssertionError(
                f"{what}: {name} launched {counts[name]} times, expected "
                f"{per[0]} a decode x {n_dec} + {per[1]} a prefill x {n_pre}")
    off_path = [k for k, v in counts.items()
                if v and k not in path_kernels(cfg)]
    if off_path:
        raise AssertionError(f"{what}: {off_path} launched off the path")


def describe(cfg) -> str:
    head, reps, group, tail = cfg.layer_program
    prog = (f"{' '.join(head) + ' + ' if head else ''}{reps} x "
            f"({' '.join(group)}){' + ' + ' '.join(tail) if tail else ''}")
    s = (f"{cfg.arch_id}: {cfg.n_layers} layers [{prog}], d_model "
         f"{cfg.d_model}, vocab {cfg.vocab_size}")
    if cfg.ssm is not None:
        sc = cfg.ssm
        d_in = sc.expand * cfg.d_model
        s += (f", d_inner {d_in}, d_state {sc.d_state}, d_conv {sc.d_conv}"
              + (f", {d_in // sc.head_dim} SSM heads of {sc.head_dim}, "
                 f"{sc.n_groups} group(s)" if sc.version == 2 else
                 f", dt_rank {max(1, cfg.d_model // 16)}"))
    if cfg.mla is not None:
        m = cfg.mla
        s += (f", MLA {cfg.n_heads} heads, q_lora {m.q_lora_rank}, kv_lora "
              f"{m.kv_lora_rank}, nope/rope {m.qk_nope_head_dim}/"
              f"{m.qk_rope_head_dim}, v_head {m.v_head_dim}")
    elif any(b in ("attn", "shared_attn", "moe")
             for b in group + head + tail):
        s += (f", attention {cfg.n_heads} heads ({cfg.n_kv_heads} kv) of "
              f"{cfg.d_head}, d_ff {cfg.d_ff}")
    if cfg.moe is not None:
        mo = cfg.moe
        s += (f", MoE {mo.n_experts} experts top-{mo.top_k} of d_ff "
              f"{mo.d_ff_expert}, {mo.n_shared_experts} shared, capacity "
              f"factor {mo.capacity_factor}")
    return s


def phase_serve(torch, arch, shared):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.domino import DominoDecoder
    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.mamba_scan import ops as mamba_ops
    from repro_torch.kernels.masked_sample import ops as mask_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build_model, kvcache
    from repro_torch.models import layers as layers_mod
    from repro_torch.serving import (ConstraintSpec, DecodeParams, Request,
                                     ServingEngine)
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    tok, json_g = shared["tok"], shared["grammar"]
    base = get_config(arch)
    paged = kvcache.pageable(base)

    def cfg_for(dtype, kernels=True):
        depth = DEPTH.get(arch, {}).get(dtype)
        cut = {} if depth is None else {"n_layers": depth}
        return dataclasses.replace(base, dtype=dtype,
                                   use_pallas_kernels=kernels, **cut)

    log(f"[serve] {describe(base)} (logits sliced to the tokenizer's "
        f"{tok.vocab_size}); {'paged KV pool' if paged else 'dense rows'}"
        + (f"; depth cut to {DEPTH[arch]}" if arch in DEPTH else ""))
    requests = [Request(PROMPTS[i % len(PROMPTS)],
                        ConstraintSpec(grammar="json", mode="domino"),
                        DecodeParams(max_tokens=MAX_TOKENS, seed=i))
                for i in range(N_REQUESTS)]

    def engine_for(dtype, kernels, params=None):
        model = build_model(cfg_for(dtype, kernels))
        if params is None:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            params = model.init(gen, device="cuda")
            torch.cuda.synchronize()
            n = sum(x.numel() for x in _leaves(params))
            log(f"[serve] {arch} {dtype} weights drawn on the card in "
                f"{time.perf_counter() - t0:.1f}s: "
                f"{model.cfg.n_layers} layers, {n / 1e9:.2f} B parameters, "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
                f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        eng = ServingEngine(model, params, tok, max_len=MAX_LEN,
                            device="cuda")
        shared["trees"] = eng.register_grammar("json", json_g,
                                               tree_cache=shared["trees"])
        return eng

    def serve(eng):
        return eng.generate_batch(requests, max_batch=N_REQUESTS,
                                  page_size=PAGE_SIZE)

    def check_valid(results, what):
        for i, r in enumerate(results):
            if r.status not in ("ok", "dead_end"):
                raise AssertionError(f"{what}: request {i} ended "
                                     f"{r.status}: {r.error}")
            d = DominoDecoder(json_g, list(tok.vocab), tok.eos_id)
            if not all(d.advance(t) for t in r.token_ids):
                raise AssertionError(f"{what}: request {i} output leaves "
                                     "the JSON grammar")

    # (a) float32: kernel path vs plain path, same weights and requests
    cfg32 = cfg_for("float32")
    eng_k = engine_for("float32", True)
    if not shared.get("precomputed"):
        t0 = time.perf_counter()
        eng_k.precompute()
        shared["precomputed"] = True
        log(f"[serve] grammar trees precomputed in "
            f"{time.perf_counter() - t0:.1f}s")
    eng_p = engine_for("float32", False, params=eng_k.params)
    reset_counts()
    res_k = serve(eng_k)
    torch.cuda.synchronize()
    counts = read_counts()
    stats = dict(eng_k.last_batch_stats)
    res_p = serve(eng_p)
    check_valid(res_k, f"{arch} f32 kernel run")
    check_valid(res_p, f"{arch} f32 plain run")
    log(f"[serve] {arch} f32 kernel run: launches "
        + ", ".join(f"{k} {counts[k]}" for k in path_kernels(cfg32))
        + f"; {stats['n_decode']} decode ticks, "
        f"{stats['n_fwd'] - stats['n_decode']} admissions, layout "
        f"{'paged' if stats['paged'] else 'dense'}")
    if stats["paged"] != paged:
        raise AssertionError(f"{arch}: the scheduler chose the wrong layout")
    check_launches(cfg32, counts, stats, f"{arch} f32 kernel run")
    for i, (a, b) in enumerate(zip(res_k, res_p)):
        log(f"[serve] {arch} f32 request {i}: status {a.status}, "
            f"{a.n_tokens} tokens, {a.n_interventions} interventions: "
            f"{a.text[:60]!r}")
        if a.token_ids != b.token_ids or a.status != b.status:
            k = next((j for j, (x, y) in enumerate(zip(a.token_ids,
                                                       b.token_ids))
                      if x != y), min(len(a.token_ids), len(b.token_ids)))
            ids = eng_p.tok.encode(requests[i].prompt) + b.token_ids[:k]
            cache = eng_p.model.init_cache(1, MAX_LEN, device="cuda")
            lg, _ = eng_p.model.prefill(
                eng_p.params, {"tokens": torch.tensor([ids], device="cuda")},
                cache)
            top = torch.topk(lg[0, -1, :tok.vocab_size].float(), 2).values
            raise AssertionError(
                f"{arch} f32 request {i}: kernel and plain paths diverge at "
                f"step {k} (top-2 logit margin there "
                f"{(top[0] - top[1]).item():.3e})")
    log(f"[serve] {arch} f32: kernel path == plain path for every request")
    # the single-request path (dense B=1 cache, the attention kernel's
    # contiguous mode); its prefill and batch shapes differ from the
    # scheduler's, so equal ids are expected but not required bit for bit
    single = eng_k.generate(requests[0])
    log(f"[serve] {arch} f32 generate, request 0: {single.status}, ids "
        f"{'equal to' if single.token_ids == res_k[0].token_ids else 'DIFFERENT from'}"
        f" generate_batch")
    del eng_k, eng_p, res_p, single
    torch.cuda.empty_cache()

    # (b) bfloat16, the published dtype, through the kernels
    cfg16 = cfg_for("bfloat16")
    eng = engine_for("bfloat16", True)
    serve(eng)                                    # warm-up
    torch.cuda.synchronize()
    head, reps, group, tail = cfg16.layer_program
    blocks = list(head) + list(group) * reps + list(tail)
    recs = {
        "decode_attention": Recorder(attn_ops, "decode_attention_cuda"),
        "decode_attention_split": Recorder(attn_ops,
                                           "decode_attention_split_cuda"),
        "masked_argmax_packed": Recorder(mask_ops, "masked_argmax_packed"),
        "mamba_scan": Recorder(mamba_ops, "mamba_scan_cuda",
                               max(1, blocks.count("mamba1"))),
        "ssd_scan": Recorder(ssd_ops, "ssd_scan_cuda",
                             max(1, blocks.count("mamba2"))),
    }
    phases = PhaseTimer(ContinuousBatchingScheduler)
    with contextlib.ExitStack() as hooks:
        for r in (*recs.values(), phases):
            hooks.enter_context(r)
        reset_counts()
        t0 = time.perf_counter()
        res = serve(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    stats = dict(eng.last_batch_stats)
    ticks = stats["n_decode"]
    check_valid(res, f"{arch} bf16 run")
    check_launches(cfg16, counts, stats, f"{arch} bf16 run")
    n_tok = sum(r.n_tokens for r in res)
    log(f"[serve] {arch} bf16: {n_tok} tokens in {wall:.3f}s = "
        f"{n_tok / wall:.1f} tok/s; {ticks} decode ticks, "
        f"{stats['n_fwd'] - ticks} admissions; statuses "
        f"{[r.status for r in res]}")
    n_pre = stats["n_fwd"] - ticks
    log(f"[serve] {arch} bf16 launches: "
        + "; ".join(f"{k} {counts[k]}" + (
            f" = {per[0]} a decode forward x {ticks} + {per[1]} an "
            f"admission x {n_pre}" if per else f" ({counts[k] / ticks:.2f} "
            "a tick)") for k, per in path_kernels(cfg16).items()))
    attn = [recs[k] for k in ("decode_attention", "decode_attention_split")
            if k in path_kernels(cfg16)]
    if attn:
        (q, *_, ln), kw = attn[0].calls[len(attn[0].calls) // 2]
        lengths, table = (ln - 1).clone(), kw.get("block_tables")
    else:
        # lengths do not change the work of an attention-free forward
        lengths = torch.tensor(
            [len(tok.encode(PROMPTS[i % len(PROMPTS)])) + MAX_TOKENS // 2
             for i in range(N_REQUESTS)], dtype=torch.int32, device="cuda")
        table = None
    _tick_breakdown(torch, eng, arch, res, wall, ticks, phases.seconds,
                    lengths, table, layers_mod)
    out = {"counts": counts,
           "calls": {k: r.calls for k, r in recs.items() if r.calls}}
    del eng, res
    torch.cuda.empty_cache()
    log(f"[serve] {arch} weights freed: {torch.cuda.memory_allocated() / 1e9:.2f}"
        " GB still allocated")
    return out


def _leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _device_ms(torch, fn, n=5):
    """Device time of one call of ``fn`` in ms, summed over the kernels
    the profiler saw in ``n`` calls, and the five kernels that took the
    most.  None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # device-side events only: a host op also reports its kernels' time
    ev = [(e.key, e.self_device_time_total / 1e3 / n)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not ev:
        return None, []
    return sum(t for _, t in ev), sorted(ev, key=lambda x: -x[1])[:5]


def _forward_ms(torch, model, params, cache, feed, n=10):
    """One decode forward: (host wall ms of a forward that ends in a
    synchronise, as a tick waits for it; device ms; top kernels)."""
    def fwd():
        model.decode_step(params, dict(cache), feed)   # same slots each call
    fwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fwd()
        torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / n * 1e3,) + _device_ms(torch, fwd)


def _tick_breakdown(torch, eng, arch, results, wall, ticks, phases, lengths,
                    table, layers_mod):
    """Where a bf16 decode tick's time goes: the scheduler's phases on the
    host clock, and the decode forward alone at the main path's mid-run
    lengths (and block table, when paged), through the kernels and through
    the plain path, on the host clock and on the card, beside its
    weight-read bound (for an MoE model twice: every expert read, as the
    dispatch does, and only the experts the batch routes to)."""
    import dataclasses

    from repro_torch.models import build_model
    per_tick = {k.strip("_"): v / ticks * 1e3 for k, v in phases.items()}
    tick_ms = wall / ticks * 1e3
    log(f"[serve] {arch} bf16 tick, host ms per decode tick: wall "
        f"{tick_ms:.2f} = "
        + " + ".join(f"{k} {v:.2f}" for k, v in per_tick.items())
        + f" + other {tick_ms - sum(per_tick.values()):.2f}")
    mask_crit = sum(r.mask_time_s - r.mask_overlap_s for r in results)
    mask_hid = sum(r.mask_overlap_s for r in results)
    st = eng.last_batch_stats
    log(f"[serve] {arch} bf16 host mask builds per tick: "
        f"{mask_crit / ticks * 1e3:.3f} ms on the critical path, "
        f"{mask_hid / ticks * 1e3:.3f} ms hidden under the forward; "
        f"mask_cache_hits {st['mask_cache_hits']}, premask_hits "
        f"{st['premask_hits']}")

    b = lengths.shape[0]
    if table is None:
        cache = eng.model.init_cache(b, eng.max_len, device="cuda")
    else:
        cache = eng.model.init_cache(b, eng.max_len, page_size=PAGE_SIZE,
                                     device="cuda")
        cache["pages"] = table.clone()
    cache["len"] = lengths.to(torch.int32).clone()
    feed = torch.zeros((b, 1), dtype=torch.int64, device="cuda")
    cfg = eng.model.cfg
    plain = build_model(dataclasses.replace(cfg, use_pallas_kernels=False))
    # a B-row forward reads every weight once (the embedding only B rows)
    w_bytes = sum(x.numel() * x.element_size() for x in _leaves(eng.params))
    emb = eng.params["embed"]
    w_bytes -= emb[b:].numel() * emb.element_size()
    bounds = [("", w_bytes)]
    if cfg.moe is not None:
        # the experts this forward's batch routes to, layer by layer
        with Recorder(layers_mod, "_top_k") as rec:
            eng.model.decode_step(eng.params, dict(cache), feed)
        routed = [int(layers_mod._top_k(*a)[1].unique().numel())
                  for a, _ in rec.calls]
        mo = cfg.moe
        expert = 3 * cfg.d_model * mo.d_ff_expert * \
            torch.tensor([], dtype=layers_mod.torch_dtype(cfg)).element_size()
        r_bytes = w_bytes - sum(mo.n_experts - n for n in routed) * expert
        bounds = [(" all experts", w_bytes),
                  (f" routed experts only ({routed} a layer)", r_bytes)]
    bound_txt = ", ".join(
        f"weight-read bound{name} {bound_ms(n, 0, 'bfloat16')[0]:.3f} ms "
        f"({n / 1e9:.2f} GB)" for name, n in bounds)
    for name, model in (("kernels", eng.model), ("plain", plain)):
        f_wall, f_dev, top = _forward_ms(torch, model, eng.params, cache,
                                         feed)
        dev = "not measured" if f_dev is None else f"{f_dev:.3f} ms"
        log(f"[serve] {arch} bf16 decode forward ({name}) at B={b} lengths "
            f"{lengths.tolist()}: host wall {f_wall:.2f} ms, device {dev} "
            f"(profiler), {bound_txt}")
        if top:
            log(f"[serve]   top kernels ({name}), ms per forward: "
                + "; ".join(f"{k[:60]} {t:.3f}" for k, t in top))


# -- phase 6 --------------------------------------------------------------------


MASK_OP_PATH = "masked_argmax op"


def phase_mask_op(torch, path):
    """The public ``masked_argmax`` op with byte masks -- the entry point of
    the byte-mask kernel, as the JAX package's mask tests and mask bench
    call it -- on every tick a serving run selected: that tick's logits
    and its mask unpacked to one bool a token.  Counters are set to 0 just
    before the replay and read just after; the results must equal the
    packed kernel's on the same tick, bit for bit."""
    from repro_torch.kernels.masked_sample.kernel import masked_argmax_packed
    from repro_torch.kernels.masked_sample.ops import masked_argmax
    from repro_torch.kernels.masked_sample.ref import unpack_bits
    ticks = []
    for (logits, bits), _ in path["calls"]["masked_argmax_packed"]:
        mask = unpack_bits(bits, logits.shape[1])
        ticks.append((logits, mask, masked_argmax_packed(logits, bits)))
    torch.cuda.synchronize()
    reset_counts()
    got = [masked_argmax(logits, mask) for logits, mask, _ in ticks]
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["masked_argmax_bytes"] != len(ticks) or \
            sum(counts.values()) != len(ticks):
        raise AssertionError(f"masked_argmax op path: launches {counts} for "
                             f"{len(ticks)} ticks")
    for (_, _, (i2, v2)), (i1, v1) in zip(ticks, got):
        if not (torch.equal(i1, i2) and torch.equal(v1, v2)):
            raise AssertionError("masked_argmax op path: the byte-mask "
                                 "kernel differs from the packed kernel")
    b, v = ticks[0][0].shape
    log(f"[mask op] {len(ticks)} ticks of B={b} V={v} through the op with "
        f"byte masks: masked_argmax_bytes {counts['masked_argmax_bytes']} "
        "launches, every result bitwise equal to the packed kernel's")
    return {"counts": counts,
            "calls": {"masked_argmax_bytes": [((lg, m), {})
                                              for lg, m, _ in ticks]}}


# -- phase 7 --------------------------------------------------------------------


def _mid_decode_call(calls, seq_axis):
    """A mid-run decode call (S=1 on ``seq_axis`` of the first operand)
    of a recorded list, else the middle call."""
    dec = [c for c in calls if c[0][0].shape[seq_axis] == 1]
    pick = dec or calls
    return pick[len(pick) // 2]


def phase_kernels(torch, paths, scans, attn_long, split_long, argmax_long):
    """Each kernel on the inputs of a mid-run call of a serving path."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, decode_attention_split_cuda)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.kernels.masked_sample.kernel import (masked_argmax_bytes,
                                                          masked_argmax_packed)
    from repro_torch.kernels.masked_sample.ref import masked_argmax_ref
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    def launches(name):
        by = {arch: p["counts"][name] for arch, p in paths.items()
              if p["counts"][name]}
        return sum(by.values()), by

    out = []
    n, by = launches("masked_argmax_packed")
    # a mid-run tick's logits view (row stride = padded vocab) and words;
    # the scheduler replaces both tensors every tick, so they still hold
    # that tick's values
    calls = paths["stablelm-1.6b"]["calls"]["masked_argmax_packed"]
    (logits, bits), _ = calls[len(calls) // 2]
    i1, v1 = masked_argmax_packed(logits, bits)
    i2, v2 = masked_argmax_ref(logits, bits)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i2) and torch.equal(v1, v2)):
        raise AssertionError("masked argmax differs on main-path inputs")
    b, v = logits.shape
    bnd, bnd_by = bound_ms(b * v * 4 + bits.numel() * 4 + b * 8, b * v,
                           "float32")
    out.append({
        "name": "masked_argmax_packed", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_argmax.cu",
        "replaces": "src/repro/kernels/masked_sample/kernel.py:156",
        "launches": n, "launches_by_path": by, "parity": "bitwise",
        "max_abs_err": (v1 - v2).abs().max().item(),
        "shape": f"B={b} V={v} row stride {logits.stride(0)} (stablelm-1.6b)",
        "ms": time_ms(torch, lambda: masked_argmax_packed(logits, bits)),
        "plain_ms": time_ms(torch, lambda: masked_argmax_ref(logits, bits)),
        "bound_ms": bnd, "bound_by": bnd_by, "library_ms": None,
        **argmax_long["packed"]})

    def attn_entry(arch):
        calls = paths[arch]["calls"]["decode_attention"]
        (q, kp, vp, ln), kw = calls[len(calls) // 2]
        tbl = kw.get("block_tables")
        got = decode_attention_cuda(q, kp, vp, ln, block_tables=tbl)
        want = decode_attention_ref(q, kp, vp, ln, block_tables=tbl)
        torch.cuda.synchronize()
        err = _check_attn(torch, got, want, q.dtype, f"{arch} inputs")
        bnd, bnd_by = _attn_bound(q, kp, ln, tbl, "bfloat16")
        return {
            "max_abs_err": err,
            "shape": (f"q {tuple(q.shape)} {'pool' if tbl is not None else 'stripes'} "
                      f"{tuple(kp.shape)} lengths {ln.tolist()} ({arch}, "
                      f"{'paged' if tbl is not None else 'contiguous'}; "
                      f"{_plan_text(q, kp, tbl)})"),
            "ms": time_ms(torch, lambda: decode_attention_cuda(
                q, kp, vp, ln, block_tables=tbl)),
            "plain_ms": time_ms(torch, lambda: decode_attention_ref(
                q, kp, vp, ln, block_tables=tbl)),
            "bound_ms": bnd, "bound_by": bnd_by,
            "library_ms": time_ms(torch, _sdpa_yardstick(torch, q, kp, vp,
                                                         ln, tbl))}

    n, by = launches("decode_attention")
    entry = {"name": "decode_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
             "replaces": "src/repro/kernels/decode_attention/kernel.py:121",
             "launches": n, "launches_by_path": by,
             "parity": "atol/rtol 2e-2 (bf16)"}
    entry.update(attn_entry("stablelm-1.6b"))
    entry["contiguous"] = attn_entry("zamba2-1.2b")
    entry["long"] = attn_long["long"]
    entry["long_cold"] = attn_long["long_cold"]
    out.append(entry)

    # the split score, at a mid-run decode call of deepseek-v3's bf16 run
    n, by = launches("decode_attention_split")
    calls = paths["deepseek-v3-671b"]["calls"]["decode_attention_split"]
    (q, lat, _, q2, rp, ln), kw = calls[len(calls) // 2]
    tbl, scale = kw.get("block_tables"), kw["scale"]
    got = decode_attention_split_cuda(q, lat, lat, q2, rp, ln, scale=scale,
                                      block_tables=tbl)
    want = decode_attention_ref(q, lat, lat, ln, scale=scale, q2=q2, k2=rp,
                                block_tables=tbl)
    torch.cuda.synchronize()
    bnd, bnd_by = _split_bound(q, q2, lat, ln, tbl, "bfloat16")
    out.append({
        "name": "decode_attention_split", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:121",
        "launches": n, "launches_by_path": by,
        "parity": "atol/rtol 2e-2 (bf16)",
        "max_abs_err": _check_split(torch, got, want, q.dtype,
                                    "deepseek-v3-671b inputs"),
        "shape": (f"q {tuple(q.shape)} q2 {tuple(q2.shape)} pools "
                  f"{tuple(lat.shape)} / {tuple(rp.shape)} lengths "
                  f"{ln.tolist()} (deepseek-v3-671b, paged; "
                  f"{_split_plan_text(q, q2, lat, tbl)})"),
        "ms": time_ms(torch, lambda: decode_attention_split_cuda(
            q, lat, lat, q2, rp, ln, scale=scale, block_tables=tbl)),
        "plain_ms": time_ms(torch, lambda: decode_attention_ref(
            q, lat, lat, ln, scale=scale, q2=q2, k2=rp, block_tables=tbl)),
        "bound_ms": bnd, "bound_by": bnd_by,
        "library_ms": time_ms(torch, _split_sdpa_yardstick(
            torch, q, q2, lat, rp, ln, tbl, scale)),
        "long": split_long["long"], "long_cold": split_long["long_cold"]})

    # the byte mask, at a mid-run tick of the op path's replay
    n, by = launches("masked_argmax_bytes")
    calls = paths[MASK_OP_PATH]["calls"]["masked_argmax_bytes"]
    (logits, mask), _ = calls[len(calls) // 2]
    i1, v1 = masked_argmax_bytes(logits, mask)
    i2, v2 = masked_argmax_ref(logits, mask)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i2) and torch.equal(v1, v2)):
        raise AssertionError("byte-mask argmax differs on op-path inputs")
    b, v = logits.shape
    bnd, bnd_by = bound_ms(b * v * 5 + b * 8, b * v, "float32")
    out.append({
        "name": "masked_argmax_bytes", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_argmax.cu",
        "replaces": "src/repro/kernels/masked_sample/kernel.py:85",
        "launches": n, "launches_by_path": by, "parity": "bitwise",
        "max_abs_err": (v1 - v2).abs().max().item(),
        "shape": (f"B={b} V={v} row stride {logits.stride(0)}, bool mask "
                  "(deepseek-v3-671b ticks)"),
        "ms": time_ms(torch, lambda: masked_argmax_bytes(logits, mask)),
        "plain_ms": time_ms(torch, lambda: masked_argmax_ref(logits, mask)),
        "bound_ms": bnd, "bound_by": bnd_by, "library_ms": None,
        **argmax_long["bytes"]})

    for name, arch, fn, ref, bound, shape_of in (
            ("mamba_scan", "falcon-mamba-7b", mamba_scan_cuda,
             mamba_scan_ref, lambda a: _mamba_bound(a[0], a[2].shape[-1]),
             lambda a: "B={} S={} d={} N={}".format(*a[0].shape,
                                                     a[2].shape[-1])),
            ("ssd_scan", "zamba2-1.2b", ssd_scan_cuda, ssd_scan_ref,
             lambda a: _ssd_bound(a[0], a[1].shape[-1]),
             lambda a: "B={} S={} H={} D={} N={}".format(*a[0].shape,
                                                         a[1].shape[-1]))):
        n, by = launches(name)
        args, _ = _mid_decode_call(paths[arch]["calls"][name], 1)
        got = fn(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        err = _scan_err(torch, got, want, f"{name} on {arch} inputs")
        bnd, bnd_by = bound(args)
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": ("src/repro/kernels/mamba_scan/kernel.py:62"
                         if name == "mamba_scan" else
                         "src/repro/kernels/ssd_scan/kernel.py:63"),
            "launches": n, "launches_by_path": by,
            "parity": f"atol/rtol {SCAN_TOL} (f32)", "max_abs_err": err,
            "shape": f"{shape_of(args)} ({arch} decode)",
            "ms": time_ms(torch, lambda: fn(*args)),
            "plain_ms": time_ms(torch, lambda: ref(*args)),
            "bound_ms": bnd, "bound_by": bnd_by, "library_ms": None}
        entry.update(scans[name])
        out.append(entry)
    for k in out:
        lib = ("" if k["library_ms"] is None
               else f", library {k['library_ms']:.4f} ms")
        log(f"[kernel] {k['name']}: {k['launches']} launches "
            f"{k['launches_by_path']}, {k['ms']:.4f} ms (plain "
            f"{k['plain_ms']:.4f} ms{lib}, bound {k['bound_ms']:.6f} ms by "
            f"{k['bound_by']}) at {k['shape']}")
        if "contiguous" in k:
            c = k["contiguous"]
            log(f"[kernel] {k['name']} contiguous: {c['ms']:.4f} ms (plain "
                f"{c['plain_ms']:.4f} ms, library {c['library_ms']:.4f} ms, "
                f"bound {c['bound_ms']:.6f} ms by {c['bound_by']}) at "
                f"{c['shape']}")
    return out


def _finite(k) -> bool:
    nums = [k[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                               "max_abs_err")]
    for sub in ("contiguous", "long", "long_cold"):
        if sub in k:
            nums += [k[sub].get(key) for key in ("ms", "plain_ms", "bound_ms",
                                                 "library_ms")]
    return all(x is None or math.isfinite(x) for x in nums)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on "
              "the card only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT / 'chip_smoke.py'}"
              "; run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f}s")
        return out

    try:
        card = timed("env and build", phase_env, torch)
        argmax_long = timed("masked argmax", phase_masked_argmax, torch)
        attn_long = timed("decode attention", phase_decode_attention, torch)
        split_long = timed("split-score attention", phase_split_attention,
                           torch)
        scans = timed("scans", phase_scans, torch)
        from repro_torch.core import grammars
        from repro_torch.core.sampling import GrammarSampler
        from repro_torch.tokenizer import train_bpe
        t0 = time.perf_counter()
        json_g = grammars.load("json")
        tok = train_bpe(GrammarSampler(json_g, seed=0).corpus(200),
                        vocab_size=400)
        log(f"[serve] tokenizer: {tok.vocab_size} tokens, trained in "
            f"{time.perf_counter() - t0:.1f}s")
        shared = {"tok": tok, "grammar": json_g, "trees": None}
        paths = {arch: timed(f"serve {arch}", phase_serve, torch, arch,
                             shared)
                 for arch in MODELS}
        paths[MASK_OP_PATH] = timed("masked_argmax op", phase_mask_op, torch,
                                    paths["deepseek-v3-671b"])
        kernels = timed("kernels", phase_kernels, torch, paths, scans,
                        attn_long, split_long, argmax_long)
    except Exception as e:  # every phase's failure fails the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f}s on {card}")
    for k in kernels:
        if not _finite(k):
            print(f"chip_smoke: {k['name']} has a number that is not finite",
                  file=sys.stderr)
            return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
