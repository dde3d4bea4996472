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
    kernels (tokens/s, the tick's breakdown, launches a tick), (c) float32
    speculative decoding (paper section 3.6: ``spec_s`` 8, threshold 0.4,
    the schema-heavy ``json_gsm8k`` grammar) through the kernels against
    the plain path, each engine's count model warmed by one speculative
    call of the single-request path: ids, statuses, proposals and
    acceptances equal, some proposals accepted and some rejected (so the
    per-row rollback, or the refeed of recurrent rows from the pre-verify
    state, ran), ids equal to the same requests decoded without
    speculation (deepseek-v3: printed, not required, as its MoE routes the
    window's pads with the real tokens), (d) bfloat16 speculative decoding
    beside the same requests decoded plainly, run plain, speculative,
    speculative, plain (tokens/s, forwards a token, accepted/proposed, the
    tick's breakdown: verify forward, host verification, refeed forwards;
    and the snapshot copy of the recurrent state, timed on the card), (e)
    float32 through the device loop (device grammar tables, ``sync_n`` 8)
    against (a)'s ids and statuses: stablelm-1.6b and deepseek-v3 decode in
    fused blocks replayed from one recorded CUDA graph (launches of #1 or
    #1b and #2 credited a replay), host syncs a token at most 1/8 + 0.1,
    every replayed block run under ``set_sync_debug_mode("error")`` with
    only its one readback exempted, and one block run eagerly and by replay
    on the same inputs, bitwise equal in outputs and cache; falcon and
    zamba2 keep the per-token path (refeed architectures) with their rows'
    masks gathered from the table, (f) bfloat16 for stablelm-1.6b and
    deepseek-v3, host loop, device loop, device loop, host loop on
    schedulers kept across runs: tok/s, host syncs a token, blocks, steps a
    block, recording time and the card's busy share of a block.  Every kernel counter is set to 0
    just before a run and read just after it, and the run's forwards are
    counted by wrapping the engine's prefill and decode steps; a kernel of
    the model's path that did not launch, or launched another number of
    times than its layers and the run's prefill, plain, verify and refeed
    forwards say, fails the phase;
 6. the public ``masked_argmax`` op on byte masks (the entry point that
    reaches the byte-mask kernel, which no serving path calls): the
    deepseek-v3 bf16 run's ticks replayed through it with their masks
    unpacked to bytes, counters reset just before and read just after;
 7. each kernel's launches on the serving paths, its parity, and its time
    beside its plain version, its bound and a library yardstick, on the
    inputs a serving path gave it; for #1 (paged and contiguous), #1b, #4
    and #5 also on a mid-run verify call (S = 1 + spec_s) of the bf16
    speculative runs, with that run's launches and the card's name and
    power limit (``verify``, ``verify_contiguous``);
 8. failure semantics and durability at full width in float32, every
    comparison bitwise, every run's launches checked as in phase 5: (a)
    stablelm-1.6b, 6 JSON requests of 32 tokens in 4 slots over a pool of
    64-token pages with one spare page, so the fault-free run preempts;
    then a seeded storm (mask_error, decode_nan, advance_error,
    prefill_nan, page_exhaustion) under the tick invariant audit
    (affected rows non-ok with a prefix of the fault-free output, or
    equal; the others equal; the pool and slots drained), a device_error
    storm (two engine resets, the ladder down to the dense level, which
    still selects through kernel #2, and back to level 0, peak memory
    against the fault-free run's), an
    alloc_fail shrink, and a cancellation beside an expired deadline;
    (c) a journaled run crashed after its 6th fsync and restored in
    process, then the serve CLI's SIGKILL drill (reference, crash and
    restore processes, ``IDS`` lines equal); (d) the device loop's fault
    sites on stablelm-1.6b (device_timeout, device_error, table_corrupt,
    decode_nan): affected rows a prefix of the fault-free output, the
    ladder from fused to host and back, a new recording after each reset;
    (b) zamba2-1.2b speculative
    on dense rows with a targeted advance_error, a targeted decode_nan
    and a device_error reset.  A fault-free run that degrades, retries,
    resets or selects through the plain version fails;
 9. the radix prefix cache (copy-on-write shared KV pages, admissions that
    prefill only their private tail as one decode of width S = the tail's
    bucket through #1, or #1b): (a) stablelm-1.6b in float32 on the
    reference serving bench's Zipf-preamble traffic (16 requests over
    three preambles, json, c and unconstrained rows, 4 tokens each,
    16-token pages, 160 pages, 4 slots, the invariant audit on), cold then
    warm through the kernels: ids and statuses equal (a divergence is a
    bug unless the top-2 legal logit margin where the runs part is below
    ``MARGIN_NOISE``, printed), at least 90% of the shareable prefill
    tokens skipped, the pool leak-free after the cache's reset, #1's
    launches counted with cached prefills as decode forwards of width S;
    warm through the kernels equal to warm through the plain path; (b)
    bfloat16 cold, warm, warm, cold (tok/s, admission to first token, a
    cached prefill's host wall against a full one's) and #1's ``prefix``
    entry on a mid-run cached prefill; deepseek-v3's part runs inside
    phase 5's float32 serve (the Zipf trace warm, kernels against plain,
    warm against cold printed: its MoE routes a bucket's pads) and gives
    #1b's ``prefix`` entry; (c) the device loop with the cache, float32, 4
    certified JSON requests sharing a preamble in 2 slots, cold and warm:
    ids equal, one graph recording across the cached admissions, every
    replayed block under ``set_sync_debug_mode("error")``; (d) a journaled
    warm run crashed and restored with the cache (checker clones, admit
    records with cached pages, ids equal), then the serve CLI's SIGKILL
    drill with ``--prefix-cache --page-size 8 --prompts 5``;
10. training: (a) stablelm-1.6b at its published width and depth (1.2 B
    parameters with the trainer's ~512-token vocabulary) trained 20 AdamW
    steps in float32 through ``repro_torch.launch.train`` on JSON LM rows at
    batch 8 x seq 128: the losses finite and falling; the median step time
    against its bound (6 x params x tokens at 67 TFLOP/s), tokens/s and
    peak memory printed; its params saved to a temporary checkpoint,
    removed at the end of the phase; (b) that checkpoint served by
    ``python -m repro_torch.launch.serve --no-smoke --checkpoint DIR
    --kernels`` with the DOMINO JSON grammar (every output advances a fresh
    ``DominoDecoder``), then in process in float32 through #1 paged and #2
    against the plain path (ids equal under the margin rule, launches
    checked as in phase 5); (c) the paper's ``bench-2l`` model trained to
    ``benchmarks/common.py``'s recipe (500 steps, two task batches to one
    JSON batch) and held to ``tests/test_system.py``'s bars: the loss below
    0.7 of the first, a valid constrained output, speculative ids equal to
    plain ids in no more forwards; accepted proposals and the task accuracy
    of constrained against unconstrained decoding printed; (d)
    ``blocked_attention``'s backward at S = T = 2048 against naive autograd
    (atol 2e-4, rtol 1e-3; both peaks printed), every kernel wrapper
    refusing an operand that requires grad, and the falcon-mamba-7b and
    zamba2-1.2b smoke configs refusing to train through the scans, then
    taking a step without them;
11. other architectures, run after phase 6 so that phase 7 reads their
    launches, at their published widths with random weights, 4 DOMINO
    JSON requests of 32 tokens in 4 dense slots, each request with its
    seeded extra inputs: gemma3-27b (groups of 5 sliding-window ``swa``
    layers + 1 global ``attn``, 262144-token vocabulary; max_len 2048, one
    prompt of about 1010 tokens so that its row passes the 1024-slot ring
    and the ring wraps), llava-next-mistral-7b (all ``swa``, a (1, 2880,
    4096) patch prefix a request; max_len 4096) and whisper-tiny (the
    ``xattn`` decoder over a 4-layer encoder, (1, 1500, 384) frames a
    request).  A ring decodes on the plain path and the cross-attention
    runs ``attention_any``, as in the JAX package, so #1 runs only on the
    ``attn`` and ``xattn`` self-attention layers (Dk 128 with Qh 2, and Dk
    64 with Qh 1), #2 on every selection.  For each: (a) float32 through
    the kernels against the plain path, ids and statuses equal under the
    margin rule (gemma3 with its depth cut to 8 layers, the group once and
    the tail: 4.71 B parameters); (b) bfloat16 through the kernels, full
    depth: tok/s, the tick's breakdown, #1 and #2 launches a tick; (c)
    gemma3 (8 layers, float32) with ``kv_cache_dtype="int8"``, kernels
    against plain, the cache's bytes beside the native cache's; (d)
    whisper through the device loop (``sync_n`` 8) against its host loop,
    ids equal, at most 1/8 + 0.1 host syncs a token.  Launches are checked
    as in phase 5; phase 7 adds #1 on a mid-run call of whisper's,
    gemma3's and the int8 run's (``whisper``, ``gemma3``, ``int8``) and #2
    on a mid-run tick of each bf16 run (``gemma3``, ``llava``,
    ``whisper``);
12. scale-out and the serve flags: (a) ``repro_torch.launch.train --mesh
    1x1`` (an NCCL world of one rank over a file store, the params and
    AdamW moments DTensors on a 1 x 1 ``DeviceMesh``, the same program the
    CPU tests run on 2 x 2 gloo meshes) on phase 10 (a)'s flags for 2
    steps: its losses and grad norms held to phase 10 (a)'s first two
    (relative 1e-4), its step times beside the unsharded ones; (b) the
    serve CLI in process at full width, ``--kernels --dtype float32 --k 2
    --analyze warn --print-ids``, with and without ``--opportunistic``:
    ``IDS`` lines equal, the ``[analysis]`` lines and #1/#2 launches of
    each printed.  No run here spans more than one card.

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
# speculation (paper section 3.6) over the schema-heavy grammar, with the
# knobs of the reference's speculation tests
SPEC_PROMPTS = ["Q: compute 1 + 2\nA: ", "A: ", "Q: what is 3 * 4?\nA: ",
                "Solve it, answer as JSON: "]
SPEC = dict(speculative=True, spec_s=8, spec_threshold=0.4)
VERIFY_WIDTH = 1 + SPEC["spec_s"]
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
    if q.dtype != lat.dtype or str(q.dtype) == "torch.float32":
        return "float32: CUDA cores, one split"
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
    """Each visible key's K and V rows read once, q read and the output
    written once; 4 D flops a (key, query row) pair, the window's causal
    pairs counted exactly."""
    b, s_win, g, qh, d = q.shape
    cap = kp.shape[1] if tbl is None else tbl.shape[1] * kp.shape[1]
    keys = sum(max(0, min(int(x) + s_win - 1, cap)) for x in ln.tolist())
    pairs = sum(max(0, min(int(x) + s, cap)) for x in ln.tolist()
                for s in range(s_win)) * g * qh
    esize = q.element_size()
    n_bytes = (keys * g * 2 * d * esize + 2 * q.numel() * esize
               + ln.numel() * 4 + (0 if tbl is None else tbl.numel() * 4))
    n_ops = pairs * 4 * d
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
    ``keep_every``-th call, and with ``width`` only those whose first
    operand has that S on axis 1, for timing and parity on exactly those
    inputs) while the call goes through the real wrapper, which does its
    own launch counting.  A kept call keeps its operands alive: a refeed's
    gathered state among them, which ``width`` leaves out.  With
    ``min_width`` only calls of at least that S are kept (the cached
    prefills of the prefix cache)."""

    def __init__(self, module, name, keep_every=1, width=None,
                 min_width=None):
        self.module, self.name, self.every = module, name, keep_every
        self.width, self.min_width = width, min_width
        self.fn = getattr(module, name)
        self.calls = []
        self.n = 0

    def __enter__(self):
        def wrapped(*args, **kw):
            s = args[0].shape[1]
            if self.n % self.every == 0 and (
                    self.width is None or s == self.width) and (
                    self.min_width is None or s >= self.min_width):
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
    the forward (plain or verify), the mask builds overlapped with it, and
    the wait for it; ``_verify_row`` the host verification of a row's
    chain, ``_fixup_refeed`` the refeed forwards of recurrent rows and
    their gathers and scatters, ``_shrink_pages`` the pages returned after
    a rollback."""
    PHASES = ("_admit", "_ensure_pages", "_choose", "_commit_first",
              "_run_decode", "_verify_row", "_fixup_refeed",
              "_shrink_pages")

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


class ForwardCount:
    """Counts an engine's forwards by wrapping its prefill and decode steps:
    prefills, and decode forwards by their width S (plain 1, verify
    ``VERIFY_WIDTH``, a refeed 1 + accepted)."""

    def __init__(self, eng):
        self.eng = eng
        self.prefill = 0
        self.decode = {}

    @property
    def n_decode(self) -> int:
        return sum(self.decode.values())

    def __enter__(self):
        self.orig = (self.eng._prefill, self.eng._decode)

        def prefill(*args, **kw):
            self.prefill += 1
            return self.orig[0](*args, **kw)

        def decode(params, cache, tokens):
            s = tokens.shape[1]
            self.decode[s] = self.decode.get(s, 0) + 1
            return self.orig[1](params, cache, tokens)

        self.eng._prefill, self.eng._decode = prefill, decode
        return self

    def __exit__(self, *exc):
        self.eng._prefill, self.eng._decode = self.orig
        self.eng = self.orig = None      # the counts outlive the weights


def path_kernels(cfg):
    """The kernels a decode tick of ``cfg`` launches, each with its
    launches per decode forward and per admission prefill."""
    head, reps, group, tail = cfg.layer_program
    blocks = list(head) + list(group) * reps + list(tail)
    mla = [b == "mla" or (b == "moe" and cfg.mla is not None)
           for b in blocks]
    # a ring (swa) decodes on the plain path, as the JAX package's does
    n_attn = sum(b in ("attn", "shared_attn", "moe", "xattn") and not m
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


def check_launches(cfg, counts, fwd, what):
    """Fail unless every kernel of the path launched, and the per-layer
    kernels exactly once a layer of every forward that ``fwd`` (a
    ``ForwardCount``) counted: plain, verify and refeed decodes alike."""
    n_dec, n_pre = fwd.n_decode, fwd.prefill
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


class FusedAudit:
    """Instruments the fused path of every scheduler for one run.  Each
    ``_device_step`` that begins with its block's graph recorded runs under
    ``torch.cuda.set_sync_debug_mode("error")``, with only the block's
    readback exempted, and the readbacks are counted: a block that synced
    anywhere else raises.  With ``check_replay`` the first replayed block
    runs once eagerly and once by replay on the same inputs
    (``FusedBlock.replay_matches_eager``).  Also kept: the order of
    recordings, blocks and engine resets (``trail``), the host wall of each
    block (``block_s``, staging to readback; recording blocks apart), the
    launches a recording counted, and the calls of ``_gather_masks`` (rows
    tracked on the device table in per-token ticks)."""

    def __init__(self, torch, check_replay=False):
        self.torch = torch
        self.check_replay = check_replay
        self.strict = self.readbacks = self.gathers = 0
        self.replay_ok = None
        self.block_s, self.record_block_s, self.trail = [], [], []
        self.recorded = None

    def __enter__(self):
        from repro_torch.serving import fused, scheduler
        torch, a = self.torch, self
        sched_cls, block_cls = (scheduler.ContinuousBatchingScheduler,
                                fused.FusedBlock)
        orig = {n: getattr(sched_cls, n) for n in
                ("_device_step", "_gather_masks", "_engine_reset")}
        orig.update({n: getattr(block_cls, n) for n in
                     ("readback", "launch", "run")})

        def device_step(sched):
            fb = sched._fused
            strict = fb is not None and fb.graph is not None
            if strict:
                a.strict += 1
                torch.cuda.set_sync_debug_mode("error")
            try:
                return orig["_device_step"](sched)
            finally:
                if strict:
                    torch.cuda.set_sync_debug_mode(0)

        def gather_masks(sched, staged):
            a.gathers += 1
            return orig["_gather_masks"](sched, staged)

        def engine_reset(sched, reason):
            a.trail.append("reset")
            return orig["_engine_reset"](sched, reason)

        def readback(fb):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return orig["readback"](fb)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                a.readbacks += 1

        def launch(fb, cache, dts):
            if fb.graph is None:
                a.trail.append("record")
            a.trail.append("block")
            if a.check_replay and a.replay_ok is None \
                    and fb.graph is not None:
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode(0)
                try:
                    a.replay_ok = fb.replay_matches_eager(cache, dts)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            else:
                orig["launch"](fb, cache, dts)
            a.recorded = fb.graph.recorded

        def run(fb, *args):
            recording = fb.graph is None
            t0 = time.perf_counter()
            try:
                return orig["run"](fb, *args)
            finally:
                (a.record_block_s if recording else a.block_s).append(
                    time.perf_counter() - t0)

        self.orig = [(sched_cls, n, f) for n, f in orig.items()
                     if n.startswith("_")] + [
            (block_cls, n, f) for n, f in orig.items()
            if not n.startswith("_")]
        for cls, name, fn in ((sched_cls, "_device_step", device_step),
                              (sched_cls, "_gather_masks", gather_masks),
                              (sched_cls, "_engine_reset", engine_reset),
                              (block_cls, "readback", readback),
                              (block_cls, "launch", launch),
                              (block_cls, "run", run)):
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.orig:
            setattr(cls, name, fn)
        self.torch.cuda.set_sync_debug_mode(0)


def device_tables_for(eng, shared):
    """Build ``eng``'s device tables: the JSON grammar is analysed against
    the run's tokenizer once, and later engines are handed the stored
    report (``build_device_tables`` trusts it)."""
    report = shared.get("json_report")
    if report is not None:
        eng.analysis_reports["json"] = report
    t0 = time.perf_counter()
    eng.build_device_tables()
    if "json" not in eng.device_tables:
        raise AssertionError("the JSON grammar did not certify clean")
    if report is None:
        report = shared["json_report"] = eng.analysis_reports["json"]
        tbl = eng.device_tables["json"]
        log(f"[serve] device table: the JSON grammar certifies clean against "
            f"the {eng.tok.vocab_size}-token tokenizer "
            f"({report.n_mask_conflicts} conflicts, "
            f"{report.n_hyp_truncations} truncations): "
            f"{tbl.n_states} states, {tbl.n_bytes / 1e6:.2f} MB, analysed "
            f"and uploaded in {time.perf_counter() - t0:.1f}s")


def fused_run(torch, eng, reqs, sched=None, check_replay=False, sync_n=8,
              **kw):
    """One run of ``reqs`` through a device-loop scheduler (``sched``, or a
    new one of ``N_REQUESTS`` slots) with every counter set to 0 just
    before it and read just after, the run's forwards counted and its fused
    path audited.  Returns (results, scheduler, counts, forwards, audit,
    wall seconds)."""
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    with FusedAudit(torch, check_replay) as audit, \
            ForwardCount(eng) as fwd:
        reset_counts()
        t0 = time.perf_counter()
        if sched is None:
            sched = ContinuousBatchingScheduler(
                eng, capacity=N_REQUESTS, page_size=PAGE_SIZE,
                device_loop=True, sync_n=sync_n, **kw)
        sess = [sched.submit(r) for r in reqs]
        sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    return [s.result for s in sess], sched, counts, fwd, audit, wall


def check_fused(cfg, sched, counts, fwd, audit, what):
    """The fused path's accounting: blocks replayed from recorded graphs,
    one readback a block, no other host sync in a replayed block, each
    recording of the block counting ``sync_n`` launches of the path's
    attention kernel a layer and of #2, and #1/#1b launched exactly
    ``layers x`` (the eager forwards: host ticks, warm-ups before a
    recording, the replay check's eager block) ``+ replays x recorded``.
    Returns a summary line."""
    fb = sched._fused
    per = path_kernels(cfg)
    attn = next(k for k in ("decode_attention", "decode_attention_split")
                if k in per)
    layers, n = per[attn][0], sched.sync_n
    w = _wrappers()
    if fb is None or fb.n_replays == 0 or audit.recorded is None:
        raise AssertionError(f"{what}: no fused block was replayed")
    if sched.sup.n_degrades or sched.n_engine_resets:
        raise AssertionError(f"{what}: a fault-free run degraded "
                             f"({[e.error for e in sched.sup.events]})")
    rec = {name: audit.recorded.get(w[name], 0) for name in w}
    if rec[attn] != layers * n or rec["masked_argmax_packed"] != n \
            or sum(rec.values()) != (layers + 1) * n:
        raise AssertionError(f"{what}: a recording counted {rec}")
    if audit.readbacks != fb.n_blocks or audit.strict == 0:
        raise AssertionError(f"{what}: {audit.readbacks} readbacks for "
                             f"{fb.n_blocks} blocks, {audit.strict} audited")
    eager = fwd.n_decode - n * fb.n_records
    want = layers * eager + fb.n_replays * rec[attn]
    if counts[attn] != want \
            or counts["masked_argmax_packed"] < fb.n_replays * n:
        raise AssertionError(
            f"{what}: {attn} {counts[attn]} launches, expected {layers} x "
            f"{eager} eager forwards + {fb.n_replays} replays x {rec[attn]}; "
            f"#2 {counts['masked_argmax_packed']}")
    off_path = [k for k, v in counts.items() if v and k not in per]
    if off_path:
        raise AssertionError(f"{what}: {off_path} launched off the path")
    return (f"{fb.n_blocks} blocks ({fb.n_replays} graph replays, "
            f"{fb.n_records} recording(s) in {fb.record_s:.2f}s), "
            f"{audit.strict} replayed blocks under sync debug mode "
            f"'error' with {audit.readbacks} readbacks; launches {attn} "
            f"{counts[attn]} = {layers} x {eager} eager forwards + "
            f"{fb.n_replays} replays x {rec[attn]}, masked_argmax_packed "
            f"{counts['masked_argmax_packed']} ({fb.n_replays} replays x "
            f"{rec['masked_argmax_packed']} + eager)")


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

    tok, json_g, gsm_g = shared["tok"], shared["grammar"], shared["gsm8k"]
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
    # the same schema-heavy requests with and without speculation
    spec_reqs, gsm_reqs = (
        [Request(SPEC_PROMPTS[i % len(SPEC_PROMPTS)],
                 ConstraintSpec(grammar="gsm8k", mode="domino"),
                 DecodeParams(max_tokens=MAX_TOKENS, seed=i,
                              **(SPEC if spec else {})))
         for i in range(N_REQUESTS)] for spec in (True, False))

    def engine_for(dtype, kernels, params=None, device_tables=False):
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
                            device_tables=device_tables, device="cuda")
        for name, g in ((("json", json_g),) if device_tables else
                        (("json", json_g), ("gsm8k", gsm_g))):
            shared["trees"][name] = eng.register_grammar(
                name, g, tree_cache=shared["trees"].get(name))
        if device_tables:
            device_tables_for(eng, shared)
        return eng

    def serve(eng, reqs=requests):
        return eng.generate_batch(reqs, max_batch=N_REQUESTS,
                                  page_size=PAGE_SIZE)

    def check_valid(results, what, grammar=json_g):
        for i, r in enumerate(results):
            if r.status not in ("ok", "dead_end"):
                raise AssertionError(f"{what}: request {i} ended "
                                     f"{r.status}: {r.error}")
            d = DominoDecoder(grammar, list(tok.vocab), tok.eos_id)
            if not all(d.advance(t) for t in r.token_ids):
                raise AssertionError(f"{what}: request {i} output leaves "
                                     "its grammar")

    def counted_run(eng, reqs, cfg, what, hooks=()):
        """One ``generate_batch`` with every counter set to 0 just before
        it and read just after; the per-layer launches checked against
        the forwards it ran.  Returns (results, counts, forwards, stats,
        wall seconds)."""
        with contextlib.ExitStack() as stack:
            for h in hooks:
                stack.enter_context(h)
            fwd = stack.enter_context(ForwardCount(eng))
            reset_counts()
            t0 = time.perf_counter()
            res = serve(eng, reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        stats = dict(eng.last_batch_stats)
        # the scheduler's own counters agree with the wrapped steps: plain
        # and verify forwards are its decodes, the rest refeeds
        n_refeed = fwd.n_decode - stats["n_decode"]
        if stats["n_fwd"] != fwd.prefill + fwd.n_decode or n_refeed < 0:
            raise AssertionError(f"{what}: forwards {fwd.prefill} prefills "
                                 f"+ {fwd.decode} decodes, scheduler "
                                 f"{stats}")
        check_launches(cfg, counts, fwd, what)
        return res, counts, fwd, stats, wall

    def spec_summary(res, fwd, stats):
        prop = sum(r.n_spec_proposed for r in res)
        acc = sum(r.n_spec_accepted for r in res)
        n_verify = fwd.decode.get(VERIFY_WIDTH, 0)
        n_plain = stats["n_decode"] - n_verify
        # the scheduler's decodes are its plain and verify forwards; every
        # other decode is a refeed, S = 1 + accepted
        refeed = {s: n - (n_plain if s == 1 else 0)
                  for s, n in sorted(fwd.decode.items())
                  if s != VERIFY_WIDTH}
        refeed = {s: n for s, n in refeed.items() if n}
        return prop, acc, n_verify, sum(refeed.values()), (
            f"accepted/proposed {acc}/{prop}; forwards: {fwd.prefill} "
            f"prefills, {n_plain} plain, {n_verify} verify "
            f"(S={VERIFY_WIDTH}), {sum(refeed.values())} refeed (count by "
            f"S: {refeed})")

    # (a) float32: kernel path vs plain path, same weights and requests
    cfg32 = cfg_for("float32")
    eng_k = engine_for("float32", True)
    if not shared.get("precomputed"):
        t0 = time.perf_counter()
        eng_k.precompute()
        shared["precomputed"] = True
        log(f"[serve] grammar trees (json, json_gsm8k) precomputed in "
            f"{time.perf_counter() - t0:.1f}s")
    eng_p = engine_for("float32", False, params=eng_k.params)
    res_k, counts, fwd, stats, _ = counted_run(eng_k, requests, cfg32,
                                               f"{arch} f32 kernel run")
    res_p = serve(eng_p)
    check_valid(res_k, f"{arch} f32 kernel run")
    check_valid(res_p, f"{arch} f32 plain run")
    log(f"[serve] {arch} f32 kernel run: launches "
        + ", ".join(f"{k} {counts[k]}" for k in path_kernels(cfg32))
        + f"; {stats['n_decode']} decode ticks, {fwd.prefill} admissions, "
        f"layout {'paged' if stats['paged'] else 'dense'}")
    if stats["paged"] != paged:
        raise AssertionError(f"{arch}: the scheduler chose the wrong layout")
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
    pfx_entry = None
    if arch == "deepseek-v3-671b":
        # phase 9 (b)'s deepseek-v3 part, while its weights are on the card
        pfx_entry = prefix_mla(torch, shared["card"], eng_k, eng_p, cfg32,
                               shared)

    # (e) float32 through the device loop (sync_n 8) against (a)'s ids
    eng_d = engine_for("float32", True, params=eng_k.params,
                       device_tables=True)
    res_e, sched, counts, fwd, audit, wall = fused_run(
        torch, eng_d, requests, check_replay=True)
    check_valid(res_e, f"{arch} f32 device-loop run")
    st = sched.stats()
    n_tok = sum(r.n_tokens for r in res_e)
    for i, (a, b) in enumerate(zip(res_e, res_k)):
        if (a.token_ids, a.status) != (b.token_ids, b.status):
            k = next((j for j, (x, y) in enumerate(zip(a.token_ids,
                                                       b.token_ids))
                      if x != y), min(len(a.token_ids), len(b.token_ids)))
            raise AssertionError(
                f"{arch} f32 request {i}: the device loop ({a.status}, "
                f"{a.n_tokens} tokens) and the host loop ({b.status}, "
                f"{b.n_tokens}) diverge at step {k}; device tokens "
                f"{[r.n_device_tokens for r in res_e]}, trail {audit.trail}")
    text = (f"{n_tok} tokens, {st['n_device_tokens']} committed by fused "
            f"blocks, {st['n_host_syncs']} host syncs "
            f"({st['n_host_syncs'] / max(n_tok, 1):.3f} a token), "
            f"{st['n_quotient_escapes']} quotient escapes, "
            f"{st['n_table_rejects']} table rejects; {wall:.2f}s")
    if eng_d._needs_refeed:
        # the refeed architectures never fuse; certified rows still take
        # their mask from the table
        if st["n_device_tokens"] or audit.gathers == 0 \
                or sched._fused is not None:
            raise AssertionError(f"{arch} f32 device loop: {text}; "
                                 f"{audit.gathers} table gathers")
        log(f"[serve] {arch} f32 device loop: ids and statuses == (a); "
            f"per-token path, {audit.gathers} ticks gathered tracked rows' "
            f"masks from the device table; {text}")
    else:
        line = check_fused(cfg32, sched, counts, fwd, audit,
                           f"{arch} f32 device loop")
        if st["n_device_tokens"] == 0 \
                or st["n_host_syncs"] / n_tok > 1 / sched.sync_n + 0.1:
            raise AssertionError(f"{arch} f32 device loop: {text}")
        if audit.replay_ok is not True:
            raise AssertionError(f"{arch} f32 device loop: the replayed "
                                 "block differs from the eager block")
        log(f"[serve] {arch} f32 device loop: ids and statuses == (a); "
            f"{text}; a replayed block == the same block run eagerly "
            f"(outputs and every cache leaf, bitwise); {line}")
    del eng_d, sched, res_e
    # the single-request path (dense B=1 cache, the attention kernel's
    # contiguous mode); its prefill and batch shapes differ from the
    # scheduler's, so equal ids are expected but not required bit for bit
    single = eng_k.generate(requests[0])
    log(f"[serve] {arch} f32 generate, request 0: {single.status}, ids "
        f"{'equal to' if single.token_ids == res_k[0].token_ids else 'DIFFERENT from'}"
        f" generate_batch")
    del eng_p, res_p, single

    # (c) float32 speculation, through the kernels and through the plain
    # path: each engine's count model (and proposal memo) warmed by one
    # speculative call of the single-request path, which must agree
    eng_sp = engine_for("float32", False, params=eng_k.params)
    t0 = time.perf_counter()
    warm = [e.generate(spec_reqs[0]) for e in (eng_k, eng_sp)]
    log(f"[serve] {arch} f32 speculative generate (count model warm-up): "
        f"{warm[0].status}, {warm[0].n_tokens} tokens in "
        f"{warm[0].n_forward_passes} forwards, accepted/proposed "
        f"{warm[0].n_spec_accepted}/{warm[0].n_spec_proposed}; plain path "
        f"{'equal' if warm[0].token_ids == warm[1].token_ids else 'DIFFERENT'}"
        f"; {time.perf_counter() - t0:.1f}s")
    if warm[0].token_ids != warm[1].token_ids:
        raise AssertionError(f"{arch} f32 speculative generate: kernel and "
                             "plain paths differ")
    res_n = serve(eng_k, gsm_reqs)            # plain rows observe nothing
    res_sk, counts, fwd, stats, _ = counted_run(
        eng_k, spec_reqs, cfg32, f"{arch} f32 speculative kernel run")
    res_sp = serve(eng_sp, spec_reqs)
    for r, what in ((res_n, "plain"), (res_sk, "speculative kernel"),
                    (res_sp, "speculative plain")):
        check_valid(r, f"{arch} f32 {what} run", gsm_g)
    prop, acc, n_verify, n_refeed, text = spec_summary(res_sk, fwd, stats)
    log(f"[serve] {arch} f32 speculative kernel run: {text}; launches "
        + ", ".join(f"{k} {counts[k]}" for k in path_kernels(cfg32)))
    for i, (a, b) in enumerate(zip(res_sk, res_sp)):
        if (a.token_ids, a.status, a.n_spec_proposed, a.n_spec_accepted) \
                != (b.token_ids, b.status, b.n_spec_proposed,
                    b.n_spec_accepted):
            raise AssertionError(
                f"{arch} f32 speculative request {i}: kernel run "
                f"({a.status}, {a.n_spec_accepted}/{a.n_spec_proposed}) and "
                f"plain run ({b.status}, {b.n_spec_accepted}/"
                f"{b.n_spec_proposed}) differ")
    if acc == 0 or acc >= prop or n_verify == 0:
        raise AssertionError(
            f"{arch} f32 speculative run: accepted {acc} of {prop} "
            f"proposals in {n_verify} verify forwards; needs an acceptance "
            "and a rejection")
    if eng_k._needs_refeed != (n_refeed > 0):
        raise AssertionError(f"{arch}: {n_refeed} refeed forwards on a "
                             f"{'refeed' if eng_k._needs_refeed else 'rollback'}"
                             " architecture")
    same = [a.token_ids == b.token_ids for a, b in zip(res_sk, res_n)]
    log(f"[serve] {arch} f32 speculative: kernel path == plain path "
        f"(ids, statuses, accepted, proposed) for every request; ids equal "
        f"to the non-speculative run: {same}")
    # deepseek-v3's MoE routes the verify window's pads with the real
    # tokens, and its capacity drops depend on the batch: not required
    if not all(same) and arch != "deepseek-v3-671b":
        raise AssertionError(f"{arch} f32: speculation changed the ids")
    del eng_k, eng_sp, res_k, res_n, res_sk, res_sp, warm
    torch.cuda.empty_cache()

    # (b) bfloat16, the published dtype, through the kernels
    cfg16 = cfg_for("bfloat16")
    eng = engine_for("bfloat16", True)
    serve(eng)                                    # warm-up
    torch.cuda.synchronize()
    head, reps, group, tail = cfg16.layer_program
    blocks = list(head) + list(group) * reps + list(tail)
    per = {k: v for k, v in path_kernels(cfg16).items() if v}

    def recorders(verify=False):
        """Every attention and selection call and the first scan layer's
        of each forward; or (``verify``) the first layer's calls of each
        verify forward."""
        def every(name):
            return per[name][0] if verify and name in per else 1
        width = VERIFY_WIDTH if verify else None
        recs = {
            "decode_attention": Recorder(attn_ops, "decode_attention_cuda",
                                         every("decode_attention"), width),
            "decode_attention_split": Recorder(
                attn_ops, "decode_attention_split_cuda",
                every("decode_attention_split"), width),
            "mamba_scan": Recorder(mamba_ops, "mamba_scan_cuda",
                                   max(1, blocks.count("mamba1")), width),
            "ssd_scan": Recorder(ssd_ops, "ssd_scan_cuda",
                                 max(1, blocks.count("mamba2")), width),
        }
        if not verify:
            recs["masked_argmax_packed"] = Recorder(mask_ops,
                                                    "masked_argmax_packed")
        return recs

    recs = recorders()
    phases = PhaseTimer(ContinuousBatchingScheduler)
    res, counts, fwd, stats, wall = counted_run(
        eng, requests, cfg16, f"{arch} bf16 run",
        hooks=(*recs.values(), phases))
    ticks = stats["n_decode"]
    check_valid(res, f"{arch} bf16 run")
    n_tok = sum(r.n_tokens for r in res)
    log(f"[serve] {arch} bf16: {n_tok} tokens in {wall:.3f}s = "
        f"{n_tok / wall:.1f} tok/s; {ticks} decode ticks, "
        f"{fwd.prefill} admissions; statuses {[r.status for r in res]}")
    n_pre = fwd.prefill
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
    if pfx_entry is not None:
        out["prefix"] = pfx_entry
    del res, recs
    if not eng._needs_refeed:
        out["fused"] = _fused_bf16(torch, arch, engine_for("bfloat16", True,
                                                           params=eng.params,
                                                           device_tables=True),
                                   requests)

    # (d) bfloat16 speculation beside the same requests decoded plainly,
    # after a speculative warm-up run (shapes, count model), in the order
    # plain, speculative, speculative, plain: the host's clock drifts
    serve(eng, spec_reqs)
    runs = {}
    for what in ("plain 1", "speculative 1", "speculative 2", "plain 2"):
        reqs = spec_reqs if what.startswith("spec") else gsm_reqs
        recs = recorders(True) if what == "speculative 1" else {}
        phases = PhaseTimer(ContinuousBatchingScheduler)
        r, counts, fwd, stats, wall = counted_run(
            eng, reqs, cfg16, f"{arch} bf16 {what} run",
            hooks=(*recs.values(), phases))
        check_valid(r, f"{arch} bf16 {what} run", gsm_g)
        runs[what] = (r, counts, fwd, stats, wall, phases.seconds, recs)
    tok_s = {}
    for what, (r, counts, fwd, stats, wall, sec, _) in runs.items():
        n_tok = sum(x.n_tokens for x in r)
        n_fwd = fwd.prefill + fwd.n_decode
        ticks = stats["n_decode"]
        per_tick = {k.strip("_"): v / ticks * 1e3 for k, v in sec.items()
                    if v}
        row_fwd = sum(x.n_forward_passes for x in r)
        tok_s.setdefault(what.split()[0], []).append(n_tok / wall)
        log(f"[serve] {arch} bf16 {what} (json_gsm8k): {n_tok} tokens in "
            f"{wall:.3f}s = {n_tok / wall:.1f} tok/s; {n_fwd} batch "
            f"forwards = {n_fwd / n_tok:.3f} a token, a request's forwards "
            f"{row_fwd / n_tok:.3f} a token; {ticks} ticks; "
            + spec_summary(r, fwd, stats)[4])
        log(f"[serve] {arch} bf16 {what} tick, host ms per tick: wall "
            f"{wall / ticks * 1e3:.2f} = "
            + " + ".join(f"{k} {v:.2f}" for k, v in per_tick.items())
            + f" + other {wall / ticks * 1e3 - sum(per_tick.values()):.2f}")
    spec_counts = runs["speculative 1"][1]
    log(f"[serve] {arch} bf16 speculative 1 launches: "
        + ", ".join(f"{k} {spec_counts[k]}" for k in path_kernels(cfg16)))
    mean = {k: sum(v) / len(v) for k, v in tok_s.items()}
    log(f"[serve] {arch} bf16 tok/s, speculative over plain (means of two "
        f"runs each): {mean['speculative']:.1f} / {mean['plain']:.1f} = "
        f"{mean['speculative'] / mean['plain']:.3f}")
    if eng._needs_refeed:
        # the copy a verify tick makes of every row's recurrent state
        cache = eng.model.init_cache(N_REQUESTS, MAX_LEN, device="cuda")
        snap = kvcache.snapshot_state(cache)
        n_bytes = 2 * sum(v.numel() * v.element_size()
                          for blk in (cache["head"] + cache["tail"]
                                      + list(cache["group"].values()))
                          for k, v in blk.items()
                          if k in kvcache.RECURRENT_LEAVES)
        ms = time_ms(torch, lambda: kvcache.snapshot_state(cache, snap))
        log(f"[serve] {arch} bf16 snapshot of the recurrent state at "
            f"B={N_REQUESTS}: {n_bytes / 2e6:.1f} MB copied in {ms:.4f} ms "
            f"on the card (bound {bound_ms(n_bytes, 0, 'bfloat16')[0]:.4f} "
            "ms by bytes)")
        del cache, snap
    out["spec"] = {"counts": spec_counts,
                   "calls": {k: r.calls
                             for k, r in runs["speculative 1"][6].items()
                             if r.calls}}
    del eng, runs
    torch.cuda.empty_cache()
    log(f"[serve] {arch} weights freed: {torch.cuda.memory_allocated() / 1e9:.2f}"
        " GB still allocated")
    return out


def _fused_bf16(torch, arch, eng, requests):
    """Phase 5 (f): the same requests in bfloat16 through the host loop and
    the device loop, each on one scheduler kept across runs (the device
    loop's graph recorded in a warm-up run), in the order host, fused,
    fused, host; tok/s, host syncs a token, blocks and steps a block, and
    the card's busy share of a block: the profiler's device time of one
    replay over the host wall of a block (staging to readback)."""
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    scheds = {
        "host": ContinuousBatchingScheduler(eng, capacity=N_REQUESTS,
                                            page_size=PAGE_SIZE),
        "fused": ContinuousBatchingScheduler(
            eng, capacity=N_REQUESTS, page_size=PAGE_SIZE,
            device_loop=True, sync_n=8)}
    for sched in scheds.values():                   # warm-up runs
        for r in requests:
            sched.submit(r)
        sched.run()
    torch.cuda.synchronize()
    fb = scheds["fused"]._fused
    runs, audits, ids = {}, [], {}
    for what in ("host 1", "fused 1", "fused 2", "host 2"):
        sched = scheds[what.split()[0]]
        before = dict(syncs=sched.n_host_syncs, dev=sched.n_device_tokens,
                      blocks=fb.n_blocks, steps=sched.n_decode)
        res, _, counts, _, audit, wall = fused_run(torch, eng, requests,
                                                   sched=sched)
        audits.append(audit)
        n_tok = sum(r.n_tokens for r in res)
        ids[what] = [r.token_ids for r in res]
        runs[what] = dict(
            tok_s=n_tok / wall, n_tok=n_tok, wall=wall,
            syncs=sched.n_host_syncs - before["syncs"],
            dev=sched.n_device_tokens - before["dev"],
            blocks=fb.n_blocks - before["blocks"],
            steps=sched.n_decode - before["steps"], counts=counts)
    for name, sched in scheds.items():
        if sched.sup.n_degrades or sched.n_engine_resets:
            raise AssertionError(f"{arch} bf16 {name} loop degraded: "
                                 f"{[e.error for e in sched.sup.events]}")
    block_ms = sorted(t * 1e3 for a in audits for t in a.block_s)
    wall_ms = block_ms[len(block_ms) // 2]
    # the kernels' time in one replay, and the replay's span on the card
    # (the gaps between the graph's kernels included)
    dev_ms, top = _device_ms(torch, fb.graph.graph.replay)
    span_ms = time_ms(torch, fb.graph.graph.replay, n=10)
    # one replay from an idle card: the host's launch call, and the wall
    # until the card has finished it
    launch, alone = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fb.graph.graph.replay()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        launch.append((t1 - t0) * 1e3)
        alone.append((time.perf_counter() - t0) * 1e3)
    launch_ms, alone_ms = sorted(launch)[2], sorted(alone)[2]
    how = "profiler"
    if dev_ms is None:
        dev_ms, how = span_ms, "events"
    for what, r in runs.items():
        log(f"[serve] {arch} bf16 device loop, {what}: {r['n_tok']} tokens "
            f"in {r['wall']:.3f}s = {r['tok_s']:.1f} tok/s; {r['syncs']} "
            f"host syncs ({r['syncs'] / r['n_tok']:.3f} a token); "
            + (f"{r['blocks']} blocks, {r['dev']} tokens committed by them, "
               f"{r['steps'] / max(r['blocks'], 1):.2f} steps a block"
               if what.startswith("fused") else f"{r['steps']} ticks"))
    mean = {k: sum(r["tok_s"] for w, r in runs.items() if w.startswith(k))
            / 2 for k in ("host", "fused")}
    log(f"[serve] {arch} bf16 device loop: tok/s fused over host (means of "
        f"two runs each) {mean['fused']:.1f} / {mean['host']:.1f} = "
        f"{mean['fused'] / mean['host']:.3f}; ids equal to the host loop's: "
        f"{ids['fused 1'] == ids['host 1']}; graph recorded once in "
        f"{fb.record_s:.3f}s (in the warm-up run); a block: host wall "
        f"{wall_ms:.3f} ms (median of {len(block_ms)}), device "
        f"{dev_ms:.3f} ms ({how}, one replay) = busy {dev_ms / wall_ms:.3f} "
        f"of the block; a replay spans {span_ms:.3f} ms on the card (events, "
        f"back to back); one replay from an idle card: the host's launch "
        f"call {launch_ms:.3f} ms, done after {alone_ms:.3f} ms (medians "
        f"of 5)")
    if top:
        log(f"[serve]   top kernels of a replayed block, ms: "
            + "; ".join(f"{k[:60]} {t:.3f}" for k, t in top))
    counts = runs["fused 1"]["counts"]
    names = {w: name for name, w in _wrappers().items()}
    recorded = {names[w]: c for w, c in fb.graph.recorded.items()}
    replays = runs["fused 1"]["blocks"]
    if any(counts[name] < replays * c for name, c in recorded.items()):
        raise AssertionError(f"{arch} bf16 fused 1: launches {counts}, "
                             f"fewer than {replays} replays x {recorded}")
    return dict(runs=runs, block_wall_ms=wall_ms, block_dev_ms=dev_ms,
                block_span_ms=span_ms, launch_ms=launch_ms,
                alone_ms=alone_ms, record_s=fb.record_s,
                replays=replays, recorded=recorded,
                launches={name: replays * c
                          for name, c in recorded.items()})


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
    # a B-row forward reads every weight once (the embedding only B rows,
    # unless the head is tied to it; an encoder's weights not at all)
    w_bytes = sum(x.numel() * x.element_size() for k, v in eng.params.items()
                  if k != "encoder" for x in _leaves(v))
    emb = eng.params["embed"]
    if not eng.model.cfg.tie_embeddings:
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


def _attn_entry(torch, call, what, dtype="bfloat16"):
    """Kernel #1 on a recorded call's inputs: its error against the plain
    version, its time, the plain version's and a library call's, and its
    bound (peak rate of ``dtype``)."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    (q, kp, vp, ln), kw = call
    tbl = kw.get("block_tables")
    got = decode_attention_cuda(q, kp, vp, ln, block_tables=tbl)
    want = decode_attention_ref(q, kp, vp, ln, block_tables=tbl)
    torch.cuda.synchronize()
    err = _check_attn(torch, got, want, q.dtype, f"{what} inputs")
    bnd, bnd_by = _attn_bound(q, kp, ln, tbl, dtype)
    return {
        "max_abs_err": err,
        "shape": (f"q {tuple(q.shape)} "
                  f"{'pool' if tbl is not None else 'stripes'} "
                  f"{tuple(kp.shape)} lengths {ln.tolist()} ({what}, "
                  f"{'paged' if tbl is not None else 'contiguous'}; "
                  f"{_plan_text(q, kp, tbl)})"),
        "ms": time_ms(torch, lambda: decode_attention_cuda(
            q, kp, vp, ln, block_tables=tbl)),
        "plain_ms": time_ms(torch, lambda: decode_attention_ref(
            q, kp, vp, ln, block_tables=tbl)),
        "bound_ms": bnd, "bound_by": bnd_by,
        "library_ms": time_ms(torch, _sdpa_yardstick(torch, q, kp, vp, ln,
                                                     tbl))}


def _split_entry(torch, call, what, dtype="bfloat16"):
    """Kernel #1b on a recorded call's inputs, as ``_attn_entry``."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_split_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    (q, lat, _, q2, rp, ln), kw = call
    tbl, scale = kw.get("block_tables"), kw["scale"]
    got = decode_attention_split_cuda(q, lat, lat, q2, rp, ln, scale=scale,
                                      block_tables=tbl)
    want = decode_attention_ref(q, lat, lat, ln, scale=scale, q2=q2, k2=rp,
                                block_tables=tbl)
    torch.cuda.synchronize()
    bnd, bnd_by = _split_bound(q, q2, lat, ln, tbl, dtype)
    return {
        "max_abs_err": _check_split(torch, got, want, q.dtype,
                                    f"{what} inputs"),
        "shape": (f"q {tuple(q.shape)} q2 {tuple(q2.shape)} pools "
                  f"{tuple(lat.shape)} / {tuple(rp.shape)} lengths "
                  f"{ln.tolist()} ({what}, paged; "
                  f"{_split_plan_text(q, q2, lat, tbl)})"),
        "ms": time_ms(torch, lambda: decode_attention_split_cuda(
            q, lat, lat, q2, rp, ln, scale=scale, block_tables=tbl)),
        "plain_ms": time_ms(torch, lambda: decode_attention_ref(
            q, lat, lat, ln, scale=scale, q2=q2, k2=rp, block_tables=tbl)),
        "bound_ms": bnd, "bound_by": bnd_by,
        "library_ms": time_ms(torch, _split_sdpa_yardstick(
            torch, q, q2, lat, rp, ln, tbl, scale))}



def _mid_decode_call(calls, seq_axis):
    """A mid-run decode call (S=1 on ``seq_axis`` of the first operand)
    of a recorded list, else the middle call."""
    dec = [c for c in calls if c[0][0].shape[seq_axis] == 1]
    pick = dec or calls
    return pick[len(pick) // 2]


def _mid_verify_call(calls, what):
    """A mid-run verify call (S = ``VERIFY_WIDTH`` on axis 1 of the first
    operand) of a recorded list."""
    ver = [c for c in calls if c[0][0].shape[1] == VERIFY_WIDTH]
    if not ver:
        raise AssertionError(f"{what}: no call at the verify width "
                             f"S={VERIFY_WIDTH} was recorded")
    return ver[len(ver) // 2]


def phase_kernels(torch, card, paths, scans, attn_long, split_long,
                  argmax_long):
    """Each kernel on the inputs of a mid-run call of a serving path, and
    the attention and scan kernels also on a mid-run verify call (S =
    ``VERIFY_WIDTH``) of a bf16 speculative run."""
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

    def verify(entry_fn, name, arch):
        """``entry_fn`` on a mid-run verify call of ``arch``'s bf16
        speculative run, with that run's launches and the card."""
        spec = paths[arch]["spec"]
        call = _mid_verify_call(spec["calls"][name], f"{name} on {arch}")
        return dict(entry_fn(torch, call, f"{arch} verify"),
                    launches=spec["counts"][name], card=card)

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
    arch_entries = arch_kernel_entries(torch, card, paths)
    out[-1].update(arch_entries["masked_argmax_packed"])

    def mid(arch, name):
        calls = paths[arch]["calls"][name]
        return calls[len(calls) // 2]

    n, by = launches("decode_attention")
    entry = {"name": "decode_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
             "replaces": "src/repro/kernels/decode_attention/kernel.py:121",
             "launches": n, "launches_by_path": by,
             "parity": "atol/rtol 2e-2 (bf16)"}
    entry.update(_attn_entry(torch, mid("stablelm-1.6b", "decode_attention"),
                             "stablelm-1.6b"))
    entry["contiguous"] = _attn_entry(
        torch, mid("zamba2-1.2b", "decode_attention"), "zamba2-1.2b")
    entry["long"] = attn_long["long"]
    entry["long_cold"] = attn_long["long_cold"]
    entry["verify"] = verify(_attn_entry, "decode_attention",
                             "stablelm-1.6b")
    entry["verify_contiguous"] = verify(_attn_entry, "decode_attention",
                                        "zamba2-1.2b")
    entry.update(arch_entries["decode_attention"])
    out.append(entry)

    # the split score, at a mid-run decode call of deepseek-v3's bf16 run
    n, by = launches("decode_attention_split")
    entry = {
        "name": "decode_attention_split", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:121",
        "launches": n, "launches_by_path": by,
        "parity": "atol/rtol 2e-2 (bf16)"}
    entry.update(_split_entry(torch, mid("deepseek-v3-671b",
                                         "decode_attention_split"),
                              "deepseek-v3-671b"))
    entry["long"] = split_long["long"]
    entry["long_cold"] = split_long["long_cold"]
    entry["verify"] = verify(_split_entry, "decode_attention_split",
                             "deepseek-v3-671b")
    out.append(entry)

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
        def scan_entry(torch, call, what, fn=fn, ref=ref, bound=bound,
                       shape_of=shape_of, name=name):
            args, _ = call
            got = fn(*args)
            want = ref(*args)
            torch.cuda.synchronize()
            err = _scan_err(torch, got, want, f"{name} on {what} inputs")
            bnd, bnd_by = bound(args)
            return {
                "max_abs_err": err, "shape": f"{shape_of(args)} ({what})",
                "ms": time_ms(torch, lambda: fn(*args)),
                "plain_ms": time_ms(torch, lambda: ref(*args)),
                "bound_ms": bnd, "bound_by": bnd_by, "library_ms": None}

        n, by = launches(name)
        entry = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": ("src/repro/kernels/mamba_scan/kernel.py:62"
                         if name == "mamba_scan" else
                         "src/repro/kernels/ssd_scan/kernel.py:63"),
            "launches": n, "launches_by_path": by,
            "parity": f"atol/rtol {SCAN_TOL} (f32)"}
        entry.update(scan_entry(torch,
                                _mid_decode_call(paths[arch]["calls"][name],
                                                 1), f"{arch} decode"))
        entry.update(scans[name])
        entry["verify"] = verify(scan_entry, name, arch)
        out.append(entry)
    # the fused path (phase 5 (f), bf16 "fused 1"): graph replays times the
    # launches one recording counted
    for k in out:
        fused = {arch: p["fused"] for arch, p in paths.items()
                 if "fused" in p and p["fused"]["recorded"].get(k["name"])}
        if fused:
            k["fused_launches"] = {
                arch: {"replays": f["replays"],
                       "recorded": f["recorded"][k["name"]],
                       "launches": f["launches"][k["name"]]}
                for arch, f in fused.items()}
    for k in out:
        lib = ("" if k["library_ms"] is None
               else f", library {k['library_ms']:.4f} ms")
        log(f"[kernel] {k['name']}: {k['launches']} launches "
            f"{k['launches_by_path']}, {k['ms']:.4f} ms (plain "
            f"{k['plain_ms']:.4f} ms{lib}, bound {k['bound_ms']:.6f} ms by "
            f"{k['bound_by']}) at {k['shape']}")
        for sub in ("contiguous", "verify", "verify_contiguous") + ARCH_SUBS:
            if sub not in k:
                continue
            c = k[sub]
            lib = ("" if c["library_ms"] is None
                   else f", library {c['library_ms']:.4f} ms")
            run = "the speculative" if sub.startswith("verify") else "its"
            log(f"[kernel] {k['name']} {sub}"
                + (f" ({c['launches']} launches in {run} run, "
                   f"{c['card']})" if "launches" in c else "")
                + f": {c['ms']:.4f} ms (plain {c['plain_ms']:.4f} ms{lib}, "
                f"bound {c['bound_ms']:.6f} ms by {c['bound_by']}) at "
                f"{c['shape']}")
        for arch, f in k.get("fused_launches", {}).items():
            log(f"[kernel] {k['name']} on {arch}'s fused path (bf16 device "
                f"loop): {f['launches']} launches = {f['replays']} graph "
                f"replays x {f['recorded']} recorded")
    return out


# -- phase 8 --------------------------------------------------------------------


# long enough (56-62 tokens) that a row outgrows its first 64-token page a
# few tokens into its output: with one spare page in the pool, the
# fault-free run recompute-preempts
FAULT_PROMPTS = ["The results of the last three runs, as a JSON list of "
                 "numbers: ",
                 "The service configuration as one JSON object of settings: ",
                 "One data record of the survey, written as a JSON object: ",
                 "A JSON array of the measured values, one number for each "
                 "day: ",
                 "An inventory item as a JSON object with its name and "
                 "price: ",
                 "The settings of the test machine, as one JSON object: "]
N_FAULT_REQUESTS = 6
STORM = {"mask_error": 0.08, "decode_nan": 0.08, "advance_error": 0.08,
         "prefill_nan": 0.05, "page_exhaustion": 0.25}
ROW_SITES = ("mask_error", "decode_nan", "advance_error", "prefill_nan")
# the fused path's sites (phase 8 (d)); the row sites target rids 1 and 2.
# With seed 17 the first tick's consultations (32 decode_nan draws of the
# block's plan, device_timeout, device_error at the block's readback) do
# not depend on the outputs: the first block's readback fails, so the
# ladder steps down from fused at once
FUSED_STORM = {"device_timeout": 0.3, "device_error": 0.3,
               "table_corrupt": 1.0, "decode_nan": 0.04}
FUSED_STORM_SEED = 17
# the SIGKILL drill: three runs of the serve CLI (reference, crashed after
# its K-th journal fsync, restored); ``--no-smoke`` serves the published
# width
DRILL_CRASH_AFTER = 6
DRILL_ARGS = ["--arch", "stablelm-1.6b", "--no-smoke", "--kernels",
              "--dtype", "float32", "--prompts", "4", "--slots", "4",
              "--max-tokens", "32", "--print-ids"]


class CrashHook(Exception):
    """Raised by the journal's crash hook in place of SIGKILL: the file is
    left as a kill just after that fsync would leave it."""


def _crash_hook():
    raise CrashHook()


def phase_faults(torch, card, shared):
    """Failure semantics and durability at full width in float32 (every
    comparison bitwise): (a) stablelm-1.6b over a paged pool that preempts,
    fault-free, then a seeded storm under the invariant audit, a
    ``device_error`` storm down the degradation ladder and back, an
    ``alloc_fail`` shrink, and a cancellation beside an expired deadline;
    (b) zamba2-1.2b speculative on dense rows, with a targeted
    ``advance_error``, a targeted ``decode_nan`` and a ``device_error``
    reset; (c) a journaled stablelm run crashed after its 6th fsync and
    restored, then the serve CLI's SIGKILL drill in three processes.
    Every run's counters are set to 0 just before it and checked by
    ``check_launches`` just after."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import (ConstraintSpec, DecodeParams,
                                     DegradationSupervisor, FaultInjector,
                                     Request, ServingEngine, TokenJournal)
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    tok = shared["tok"]

    def build(arch):
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  use_pallas_kernels=True)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = model.init(gen, device="cuda")
        return cfg, model, params

    def engine(model, params):
        eng = ServingEngine(model, params, tok, max_len=MAX_LEN,
                            device="cuda")
        for name, g in (("json", shared["grammar"]),
                        ("gsm8k", shared["gsm8k"])):
            eng.register_grammar(name, g, tree_cache=shared["trees"][name])
        return eng

    def run(eng, cfg, reqs, what, inj=None, sup=None, drive=None, **kw):
        """One scheduler run with every counter set to 0 just before it;
        its launches checked against its forwards.  ``drive(sched,
        sessions)`` steps it before ``run()``.  Returns (results,
        scheduler, injector, stats line)."""
        with ForwardCount(eng) as fwd:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            reset_counts()
            t0 = time.perf_counter()
            sched = ContinuousBatchingScheduler(
                eng, fault_injector=inj, supervisor=sup, **kw)
            sess = [sched.submit(r) for r in reqs]
            if drive is not None:
                drive(sched, sess)
            # sched.run(), counting kernel #2's launches in the ticks that
            # begin at the ladder's dense level (2)
            dense = 0
            while sched.waiting or any(s is not None for s in sched.slots):
                level = sched.sup.level
                n = read_counts()["masked_argmax_packed"]
                sched.step()
                if level >= 2:
                    dense += read_counts()["masked_argmax_packed"] - n
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        st = sched.stats()
        if st["n_fwd"] != fwd.prefill + fwd.n_decode:
            raise AssertionError(f"{what}: forwards {fwd.prefill} prefills "
                                 f"+ {fwd.decode} decodes, scheduler {st}")
        check_launches(cfg, counts, fwd, what)
        # the peak above what was allocated when the run began (the weights,
        # and a caller's earlier scheduler still held)
        peak = torch.cuda.max_memory_allocated() - start
        line = (f"{wall:.1f}s on {card}; statuses "
                f"{dict(sched.status_counts)}; {st['n_decode']} decode "
                f"ticks, {fwd.prefill} prefills, {st['n_preempt']} "
                f"preemptions; resets {st['n_engine_resets']}, ladder "
                f"level {st['level']} ({st['n_degrades']} down, "
                f"{st['n_recovers']} up, {st['n_retries']} retries), "
                f"kernel #2 launches at the dense level {dense}; peak "
                f"{peak / 1e6:.1f} MB "
                f"above the run's start; launches "
                + ", ".join(f"{k} {counts[k]}" for k in path_kernels(cfg)))
        log(f"[faults] {what}: {line}")
        return [s.result for s in sess], sched, inj, dict(
            st, dense=dense, peak=peak, wall=wall)

    def clean(res, st, what):
        """A fault-free run: every request ends ok or dead_end, with no
        degrade, retry or reset."""
        bad = [(i, r.status) for i, r in enumerate(res)
               if r.status not in ("ok", "dead_end")]
        if bad or st["n_degrades"] or st["n_retries"] \
                or st["n_engine_resets"]:
            raise AssertionError(f"{what} is not clean: {bad}, {st}")

    def same(got, want, what, rows=None):
        for i in (range(len(want)) if rows is None else rows):
            if (got[i].status, got[i].token_ids) != \
                    (want[i].status, want[i].token_ids):
                raise AssertionError(
                    f"{what}: request {i} {got[i].status} "
                    f"{got[i].token_ids} != fault-free {want[i].status} "
                    f"{want[i].token_ids}")

    def drained(sched, what):
        if any(s is not None for s in sched.slots) or sched.waiting or (
                sched.paged and (sched.pool.available != sched.n_pages - 1
                                 or sched._page_tbl.any())):
            raise AssertionError(f"{what}: slots, queue or pool not drained")

    # (a) stablelm-1.6b at full width over a pool that preempts
    cfg, model, params = build("stablelm-1.6b")
    eng = engine(model, params)
    reqs = [Request(FAULT_PROMPTS[i % len(FAULT_PROMPTS)],
                    ConstraintSpec(grammar="json", mode="domino"),
                    DecodeParams(max_tokens=MAX_TOKENS, seed=i))
            for i in range(N_FAULT_REQUESTS)]
    n_pages = 1 + N_REQUESTS + 1       # the trash page, 4 rows, one spare
    pool = dict(capacity=N_REQUESTS, paged=True, page_size=PAGE_SIZE,
                n_pages=n_pages)
    log(f"[faults] (a) {describe(cfg)}, float32; {N_FAULT_REQUESTS} JSON "
        f"requests of {MAX_TOKENS} tokens (prompts of "
        f"{[len(tok.encode(r.prompt)) for r in reqs]} tokens) in "
        f"{N_REQUESTS} slots, a pool of n_pages={n_pages} "
        f"{PAGE_SIZE}-token pages")
    base, sched, _, st0 = run(eng, cfg, reqs, "(a) fault-free", **pool)
    clean(base, st0, "(a) fault-free run")
    if st0["n_preempt"] < 1:
        raise AssertionError("(a) the fault-free run did not preempt")

    inj = FaultInjector(seed=0, rates=STORM, max_faults=25)
    res, sched, inj, _ = run(eng, cfg, reqs, "(a) storm", inj=inj,
                             debug_invariants=True, **pool)
    sites = sorted({r.site for r in inj.log})
    affected = inj.faulted_rids(*ROW_SITES)
    log(f"[faults] (a) storm fired {len(inj.log)} faults at {sites} on "
        f"rids {sorted(affected)}: "
        + ", ".join(f"{r.site}@{r.tick}/{r.rid}" for r in inj.log))
    if len(sites) < 3:
        raise AssertionError(f"(a) the storm touched {sites} only")
    drained(sched, "(a) storm")
    for i, (r, b) in enumerate(zip(res, base)):
        if i in affected:
            if not ((r.status != "ok" and r.error)
                    or r.token_ids == b.token_ids) \
                    or r.token_ids != b.token_ids[:r.n_tokens]:
                raise AssertionError(f"(a) storm: affected request {i} "
                                     f"{r.status} {r.token_ids} against "
                                     f"{b.token_ids}")
        else:
            same(res, base, "(a) storm", rows=[i])

    # one retry a guard: four faults are two failed readbacks, two resets
    # and the ladder down to level 2; four clean ticks climb one level
    sup = DegradationSupervisor(max_retries=1, backoff_s=0.0,
                                recover_after=4)
    res, sched, inj, st = run(
        eng, cfg, reqs, "(a) device_error",
        inj=FaultInjector(seed=2, rates={"device_error": 1.0},
                          max_faults=4), sup=sup, debug_invariants=True,
        **pool)
    log("[faults] (a) device_error ladder: " + ", ".join(
        f"{e.kind}->{e.level} ({e.what})" for e in sup.events)
        + f"; final level {sup.level}; peak {st['peak'] / 1e6:.1f} MB "
        f"above the run's start against the fault-free run's "
        f"{st0['peak'] / 1e6:.1f} MB; wall {st['wall']:.1f}s against "
        f"{st0['wall']:.1f}s")
    same(res, base, "(a) device_error")
    if st["n_engine_resets"] < 1 or sup.level != 0 \
            or sup.n_degrades != 2 or st["dense"] < 1:
        raise AssertionError(f"(a) device_error: {st}")
    drained(sched, "(a) device_error")

    res, sched, inj, st = run(
        eng, cfg, reqs, "(a) alloc_fail",
        inj=FaultInjector(seed=5, rates={"alloc_fail": 1.0},
                          max_faults=2), debug_invariants=True, **pool)
    same(res, base, "(a) alloc_fail")
    if st["n_capacity_shrinks"] < 1:
        raise AssertionError("(a) alloc_fail shrank nothing")
    log(f"[faults] (a) alloc_fail: {st['n_capacity_shrinks']} capacity "
        f"shrinks, cap_eff back to {st['cap_eff']}")

    # the longest fault-free request (it cannot end in two ticks) is
    # cancelled after two ticks; request 0 carries an expired deadline
    victim = max(range(1, N_FAULT_REQUESTS), key=lambda i: base[i].n_tokens)

    def cancel_victim(sched, sess):
        sched.step()
        sched.step()
        if not sched.cancel(sess[victim].rid):
            raise AssertionError(f"(a) request {victim} ended before its "
                                 "cancel")

    late = list(reqs)
    late[0] = dataclasses.replace(
        reqs[0], decode=dataclasses.replace(reqs[0].decode, deadline_s=0.0))
    res, sched, _, _ = run(eng, cfg, late, "(a) cancel and deadline",
                           drive=cancel_victim, debug_invariants=True,
                           **pool)
    if (res[victim].status, res[0].status) != ("cancelled",
                                               "deadline_exceeded"):
        raise AssertionError(f"(a) cancel/deadline: {res[victim].status}, "
                             f"{res[0].status}")
    same(res, base, "(a) cancel and deadline",
         rows=[i for i in range(1, N_FAULT_REQUESTS) if i != victim])
    drained(sched, "(a) cancel and deadline")

    # (c) durability on the same engine: a journaled run crashed after its
    # 6th fsync, restored in this process
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "journal")
        journal = TokenJournal(path, crash_after_syncs=6,
                               crash_hook=_crash_hook)
        sched = ContinuousBatchingScheduler(eng, journal=journal, **pool)
        for r in reqs:
            sched.submit(r)
        try:
            sched.run()
            raise AssertionError("(c) the journaled run did not crash")
        except CrashHook:
            journal.dead = True        # the process is gone
        with ForwardCount(eng) as fwd:
            reset_counts()
            t0 = time.perf_counter()
            sched = eng.restore(path, debug_invariants=True, **pool)
            n_live = len(sched.waiting)
            got = sched.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        check_launches(cfg, counts, fwd, "(c) restore")
    same(got, base, "(c) restore")
    if sched.n_replayed_tokens < 1:
        raise AssertionError("(c) restore replayed no token")
    log(f"[faults] (c) crash after 6 fsyncs, restore: {n_live} of "
        f"{len(got)} requests resumed live, {sched.n_replayed_tokens} "
        f"tokens replayed, ids bitwise equal to the uninterrupted run; "
        f"{wall:.1f}s on {card}; launches "
        + ", ".join(f"{k} {counts[k]}" for k in path_kernels(cfg)))
    _fused_faults(torch, card, shared, eng, cfg, model, params, reqs, run,
                  same, drained)
    del eng, model, params, sched
    torch.cuda.empty_cache()

    # (c) the serve CLI's SIGKILL drill, three processes
    t0 = time.perf_counter()
    drill = _sigkill_drill()
    log(f"[faults] (c) SIGKILL drill ({' '.join(DRILL_ARGS)}): the crashed "
        f"run died by SIGKILL after {DRILL_CRASH_AFTER} fsyncs; "
        f"{drill} requests restored with IDS lines equal to the reference "
        f"run's; three processes in {time.perf_counter() - t0:.1f}s on "
        f"{card}")

    # (b) zamba2-1.2b, speculative on dense rows of recurrent state
    cfg, model, params = build("zamba2-1.2b")
    spec_reqs = [Request(SPEC_PROMPTS[i % len(SPEC_PROMPTS)],
                         ConstraintSpec(grammar="gsm8k", mode="domino"),
                         DecodeParams(max_tokens=MAX_TOKENS, seed=i, **SPEC))
                 for i in range(N_REQUESTS)]
    log(f"[faults] (b) {describe(cfg)}, float32, speculative (spec_s "
        f"{SPEC['spec_s']}, json_gsm8k), {N_REQUESTS} requests in "
        f"{N_REQUESTS} slots on dense rows")

    def spec_engine():
        # a fresh count model a run, warmed by the same call, so every run
        # starts from the same proposals
        e = engine(model, params)
        e.generate(spec_reqs[0])
        return e

    dense = dict(capacity=N_REQUESTS)
    sbase, _, _, st = run(spec_engine(), cfg, spec_reqs, "(b) fault-free",
                          **dense)
    clean(sbase, st, "(b) fault-free run")
    # the two longest fault-free requests take the targeted faults
    longest = sorted(range(N_REQUESTS), key=lambda i: -sbase[i].n_tokens)
    for site, rid in zip(("advance_error", "decode_nan"), longest):
        res, sched, inj, _ = run(
            spec_engine(), cfg, spec_reqs, f"(b) {site} on request {rid}",
            inj=FaultInjector(seed=0, rates={site: 1.0}, targets={rid},
                              max_faults=1), debug_invariants=True, **dense)
        if inj.n_fired(site) != 1 or res[rid].status != "internal_error" \
                or res[rid].token_ids != \
                sbase[rid].token_ids[:res[rid].n_tokens]:
            raise AssertionError(f"(b) {site}: {inj.log}, request {rid} "
                                 f"{res[rid].status} {res[rid].error}")
        same(res, sbase, f"(b) {site}",
             rows=[i for i in range(N_REQUESTS) if i != rid])
        log(f"[faults] (b) {site} fired at tick {inj.log[0].tick} on "
            f"request {rid}: {res[rid].error}")
    sup = DegradationSupervisor(max_retries=1, backoff_s=0.0,
                                recover_after=4)
    res, sched, _, st = run(
        spec_engine(), cfg, spec_reqs, "(b) device_error",
        inj=FaultInjector(seed=2, rates={"device_error": 1.0},
                          max_faults=2), sup=sup, debug_invariants=True,
        **dense)
    same(res, sbase, "(b) device_error")
    if st["n_engine_resets"] != 1 or sup.level != 0:
        raise AssertionError(f"(b) device_error: {st}")
    drained(sched, "(b) device_error")
    del model, params
    torch.cuda.empty_cache()


def _fused_faults(torch, card, shared, eng, cfg, model, params, reqs, run,
                  same, drained):
    """Phase 8 (d): the fused path's fault sites on stablelm-1.6b in
    float32, device loop with sync_n 8: the fault-free device-loop run
    against the host loop, then a seeded storm of ``device_timeout``
    (before dispatch), ``device_error`` (at the block's readback and the
    host path's), ``table_corrupt`` (the mask-row audit) and
    ``decode_nan`` (planned for each block), in two waves of requests on
    one scheduler: affected rows end non-ok with a prefix of the fault-free
    output or equal to it, the others equal, the pool drains, the ladder
    steps down from fused and climbs back, and every reset is followed by
    a new recording before the next block."""
    from repro_torch.serving import (DegradationSupervisor, FaultInjector,
                                     ServingEngine)
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    deng = ServingEngine(model, params, shared["tok"], max_len=MAX_LEN,
                         device_tables=True, device="cuda")
    deng.register_grammar("json", shared["grammar"],
                          tree_cache=shared["trees"]["json"])
    device_tables_for(deng, shared)
    dreqs = reqs[:N_REQUESTS]
    pool = dict(capacity=N_REQUESTS, page_size=PAGE_SIZE)
    host, _, _, _ = run(eng, cfg, dreqs, "(d) host loop", **pool)
    base, sched, counts, fwd, audit, wall = fused_run(
        torch, deng, dreqs, debug_invariants=True)
    same(base, host, "(d) fault-free device loop")
    line = check_fused(cfg, sched, counts, fwd, audit, "(d) fault-free")
    log(f"[faults] (d) fault-free device loop == host loop: "
        f"{sched.n_device_tokens} of {sum(r.n_tokens for r in base)} tokens "
        f"in fused blocks, {wall:.1f}s on {card}; {line}")
    inj = FaultInjector(seed=FUSED_STORM_SEED, rates=FUSED_STORM,
                        targets={1, 2}, max_faults=10)
    sup = DegradationSupervisor(max_retries=1, backoff_s=0.0,
                                recover_after=2)
    t0 = time.perf_counter()
    with FusedAudit(torch) as audit:
        sched = ContinuousBatchingScheduler(
            deng, device_loop=True, sync_n=8, fault_injector=inj,
            supervisor=sup, debug_invariants=True, **pool)
        sess = []
        for _ in range(2):            # the second wave follows the storm
            sess += [sched.submit(r) for r in dreqs]
            sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = [s.result for s in sess]
    sites = sorted({r.site for r in inj.log})
    affected = inj.faulted_rids("decode_nan")
    events = [(e.kind, e.level, e.what) for e in sup.events]
    log(f"[faults] (d) fused storm fired {len(inj.log)} faults at {sites}: "
        + ", ".join(f"{r.site}@{r.tick}/{r.rid}" for r in inj.log)
        + f"; ladder {', '.join(f'{k}->{lv} ({w})' for k, lv, w in events)}"
        f"; final level {sup.level}; {sched.n_engine_resets} resets; trail "
        f"{' '.join(audit.trail)}; {sched.n_device_tokens} device tokens, "
        f"{sched.n_quotient_escapes} quotient escapes; statuses "
        f"{[r.status for r in res]}; {wall:.1f}s on {card}")
    drained(sched, "(d) fused storm")
    for i, r in enumerate(res):
        b = base[i % N_REQUESTS]
        if sess[i].rid in affected:
            if not ((r.status != "ok" and r.error)
                    or r.token_ids == b.token_ids) \
                    or r.token_ids != b.token_ids[:r.n_tokens]:
                raise AssertionError(f"(d) storm: affected request {i} "
                                     f"{r.status} {r.token_ids} against "
                                     f"{b.token_ids}")
        elif (r.status, r.token_ids) != (b.status, b.token_ids):
            raise AssertionError(f"(d) storm: request {i} {r.status} "
                                 f"{r.token_ids} != {b.token_ids}")
    down = [e for e in events if e[0] == "degrade" and e[1] == 1]
    trail = audit.trail
    rerecorded = all("record" in trail[i:trail.index("block", i)]
                     for i, x in enumerate(trail)
                     if x == "reset" and "block" in trail[i:])
    last_reset = max((i for i, x in enumerate(trail) if x == "reset"),
                     default=-1)
    if len(sites) < 3 or not down or ("recover", 0, "clean-ticks") \
            not in events or sup.level != 0 or sched.n_engine_resets < 1 \
            or not rerecorded or "block" not in trail[last_reset + 1:] \
            or sched.n_device_tokens == 0:
        raise AssertionError(f"(d) fused storm: sites {sites}, ladder "
                             f"{events}, level {sup.level}, resets "
                             f"{sched.n_engine_resets}, trail {trail}")
    log(f"[faults] (d) the ladder stepped down from fused "
        f"({', '.join(w for _, _, w in down)}) and climbed back; "
        f"{sched._fused.n_records} recordings for {sched.n_engine_resets} "
        f"resets, each reset followed by a new recording before the next "
        f"block; fused blocks ran after the last reset")
    del deng, sched


def _sigkill_drill(extra=(), tag="[faults] (c) drill") -> int:
    """Reference, crash and restore runs of ``repro_torch.launch.serve``
    (``DRILL_ARGS`` and then ``extra``: argparse keeps an option's last
    value); fails unless the crashed run dies by SIGKILL and the restored
    run's ``IDS`` lines equal the reference run's.  Returns the request
    count."""
    import os
    import signal
    import tempfile

    extra_args = list(extra)

    def serve(*extra):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                            *DRILL_ARGS, *extra_args, *extra], cwd=ROOT,
                           env=env,
                           capture_output=True, text=True, timeout=300)
        return p, [ln for ln in p.stdout.splitlines()
                   if ln.startswith("IDS ")]

    ref, want = serve()
    if ref.returncode != 0 or not want:
        raise AssertionError(f"drill reference run: rc {ref.returncode}\n"
                             f"{ref.stderr[-2000:]}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "journal")
        crash, _ = serve("--journal", path, "--crash-after-syncs",
                         str(DRILL_CRASH_AFTER))
        if crash.returncode != -signal.SIGKILL:
            raise AssertionError(f"drill crash run: rc {crash.returncode}, "
                                 f"not SIGKILL\n{crash.stderr[-2000:]}")
        rest, got = serve("--journal", path, "--restore")
    if rest.returncode != 0 or got != want:
        raise AssertionError(f"drill restore run: rc {rest.returncode}, "
                             f"IDS {got} against {want}\n"
                             f"{rest.stderr[-2000:]}")
    for ln in ref.stdout.splitlines() + rest.stdout.splitlines():
        if ln.startswith(("[restore]", "[prefix cache")):
            log(f"{tag}: {ln[:160]}")
    return len(want)


# -- phase 9 --------------------------------------------------------------------


# the reference serving bench's Zipf-preamble traffic, copied from
# benchmarks/serving_bench.py: 16 requests, each one of three long preambles
# picked by Zipf(1.4) from seed 42 and a unique short suffix, the grammar
# turning through json, c and unconstrained, 4 tokens each (prefill-bound),
# 16-token pages, a pool of 160 pages, 4 slots
PFX_PREAMBLES = [
    "You are a strict data formatter; always answer with one value and "
    "nothing else. The schema below is authoritative and versioned. " * 2,
    "System: the following conversation extracts configuration records "
    "from logs; keep keys stable across turns and quote every string. ",
    "Common few-shot preamble: {\"a\": 1} {\"b\": [2, 3]} now continue "
    "in exactly the same style for the next record. ",
]
PFX_N_REQUESTS = 16
PFX_MAX_TOKENS = 4
PFX_PAGE_SIZE = 16
PFX_N_PAGES = 160
PFX_SLOTS = 4
# phase 9 (c) and (d): one preamble of several pages shared by every request
PFX_SHARED = ("Instructions shared by every request of this deployment: "
              "answer with exactly one JSON value that follows the schema "
              "of the record, and write nothing else. Record: ")
# two float32 runs that diverge are wrong unless the top-2 legal logit
# margin at the step where they part is below this (float32 noise of a
# full-width forward: the cached prefill reads the prefix through #1 where
# the cold prefill attends densely)
MARGIN_NOISE = 1e-3
# the serve CLI's SIGKILL drill through the cache, as the reference's
# restart drill runs it (a repeated prompt, 8-token pages)
DRILL_PFX = ["--prompts", "5", "--page-size", "8", "--prefix-cache"]


def _zipf_trace():
    import numpy as np

    from repro_torch.serving import ConstraintSpec, DecodeParams, Request
    rng = np.random.default_rng(42)
    picks = np.minimum(rng.zipf(1.4, size=PFX_N_REQUESTS),
                       len(PFX_PREAMBLES)) - 1
    specs = [ConstraintSpec(grammar="json", mode="domino"),
             ConstraintSpec(grammar="c", mode="domino"), ConstraintSpec()]
    return [Request(PFX_PREAMBLES[picks[i]] + f"q{i}: ", specs[i % 3],
                    DecodeParams(max_tokens=PFX_MAX_TOKENS, seed=i))
            for i in range(PFX_N_REQUESTS)]


def _shareable(sessions, page_size):
    """Prefill tokens the cache could skip: a request's longest common
    token prefix with any earlier request, floored to whole pages (the
    reference bench's ``_shareable_tokens``)."""
    ids = [s.prompt_ids for s in sorted(sessions, key=lambda s: s.rid)]
    total = 0
    for i in range(1, len(ids)):
        best = 0
        for j in range(i):
            n = 0
            for a, b in zip(ids[i], ids[j]):
                if a != b:
                    break
                n += 1
            best = max(best, n)
        total += best // page_size * page_size
    return total


def register_grammars(eng, shared, names):
    """Register ``names`` on ``eng`` over the run's shared tree caches; a
    grammar met for the first time is precomputed once."""
    fresh = False
    for name in names:
        fresh |= name not in shared["trees"]
        shared["trees"][name] = eng.register_grammar(
            name, shared["grammars"][name],
            tree_cache=shared["trees"].get(name))
    if fresh:
        t0 = time.perf_counter()
        eng.precompute()
        log(f"[prefix] grammar trees ({', '.join(names)}) precomputed in "
            f"{time.perf_counter() - t0:.1f}s")


def pfx_run(torch, eng, reqs, prefix_cache, **kw):
    """One scheduler run of ``reqs`` through the Zipf cell's pool; returns
    (results, scheduler)."""
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    kw = dict(dict(capacity=PFX_SLOTS, page_size=PFX_PAGE_SIZE,
                   n_pages=PFX_N_PAGES, debug_invariants=True), **kw)
    sched = ContinuousBatchingScheduler(eng, prefix_cache=prefix_cache, **kw)
    sess = [sched.submit(r) for r in reqs]
    sched.run()
    torch.cuda.synchronize()
    return [s.result for s in sess], sched


def _legal_margin(torch, eng, req, ids):
    """Top-2 logit margin among the tokens ``req``'s constraint allows after
    ``ids``, from a plain float32 prefill of prompt + ``ids``."""
    sess = eng.make_session(0, req)
    for t in ids:
        if sess.checker is not None:
            sess.checker.advance(int(t))
    full = list(sess.prompt_ids) + list(ids)
    cache = eng.model.init_cache(1, eng.max_len, device="cuda")
    inputs = dict(req.extra_inputs or {})
    inputs["tokens"] = torch.tensor([full], device="cuda")
    lg, _ = eng.model.prefill(eng.params, inputs, cache)
    row = lg[0, -1, :eng.tok.vocab_size].float()
    if sess.checker is not None:
        legal = torch.as_tensor(sess.checker.mask(), device="cuda")
        row = torch.where(legal, row, torch.tensor(float("-inf"),
                                                   device="cuda"))
    top = torch.topk(row, 2).values
    return (top[0] - top[1]).item()


def same_ids(torch, eng, reqs, got, want, what, tag="[prefix]"):
    """Ids and statuses equal, or parted at a step whose top-2 legal margin
    (printed after ``tag``) is below ``MARGIN_NOISE``.  ``eng`` is a
    float32 engine.  Returns the number of such near-tie divergences."""
    n = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if (a.token_ids, a.status) == (b.token_ids, b.status):
            continue
        k = next((j for j, (x, y) in enumerate(zip(a.token_ids,
                                                   b.token_ids))
                  if x != y), min(len(a.token_ids), len(b.token_ids)))
        m = _legal_margin(torch, eng, reqs[i], a.token_ids[:k])
        log(f"{tag} {what}: request {i} parts at step {k} ({a.status} "
            f"{a.n_tokens} tokens against {b.status} {b.n_tokens}); top-2 "
            f"legal logit margin there {m:.3e}")
        if m >= MARGIN_NOISE:
            raise AssertionError(f"{what}: request {i} diverges at step {k} "
                                 f"with a top-2 margin of {m:.3e}")
        n += 1
    return n


def _drained_after_reset(sched, what):
    """Leak-free: every page but the cache's is free, and all of them once
    the cache lets go."""
    held = sched.prefix_cache.n_pages
    if sched.pool.available != sched.n_pages - 1 - held:
        raise AssertionError(f"{what}: {sched.pool.available} pages free, "
                             f"{held} held by the cache, of {sched.n_pages}")
    sched.prefix_cache.reset()
    if sched.pool.available != sched.n_pages - 1:
        raise AssertionError(f"{what}: pages leaked after the cache's reset")


def prefix_mla(torch, card, eng_k, eng_p, cfg, shared):
    """Phase 9 (b), deepseek-v3's part, run inside phase 5's float32 serve
    while its weights are on the card: the Zipf trace warm (prefix cache)
    through the kernels, its cached prefills on #1b at S > 1, against the
    same through the plain path (ids equal under the margin rule), and
    warm against cold printed (its capacity-bound MoE routes a tail
    bucket's pads with the real tokens, so warm may differ from cold).
    Returns #1b's ``prefix`` entry, on a mid-run cached-prefill call."""
    from repro_torch.kernels.decode_attention import ops as attn_ops
    for e in (eng_k, eng_p):
        register_grammars(e, shared, ("c",))
    reqs = _zipf_trace()
    rec = Recorder(attn_ops, "decode_attention_split_cuda", min_width=2)
    with rec, ForwardCount(eng_k) as fwd:
        reset_counts()
        t0 = time.perf_counter()
        warm, sched = pfx_run(torch, eng_k, reqs, True)
        wall = time.perf_counter() - t0
        counts = read_counts()
    check_launches(cfg, counts, fwd, "deepseek-v3 f32 warm kernel run")
    st = sched.stats()
    tails = {s: n for s, n in sorted(fwd.decode.items()) if s > 1}
    if st["n_prefix_hits"] == 0 or sum(tails.values()) != \
            st["n_prefix_hits"] or not rec.calls:
        raise AssertionError(f"deepseek-v3 f32 warm run: {st['n_prefix_hits']}"
                             f" hits, cached-prefill widths {tails}")
    _drained_after_reset(sched, "deepseek-v3 f32 warm run")
    warm_p, _ = pfx_run(torch, eng_p, reqs, True)
    cold, _ = pfx_run(torch, eng_k, reqs, False)
    flips = same_ids(torch, eng_p, reqs, warm, warm_p,
                     "deepseek-v3 f32 warm, kernels against plain")
    same_cold = sum(a.token_ids == b.token_ids for a, b in zip(warm, cold))
    log(f"[prefix] (b) deepseek-v3-671b f32 (depth {cfg.n_layers}) Zipf "
        f"trace warm: {st['n_prefix_hits']} hits, {st['n_prefix_tokens']} "
        f"prefill tokens skipped, {st['prefix_n_evicted']} evictions; "
        f"cached prefills by S {tails}; launches decode_attention_split "
        f"{counts['decode_attention_split']} = {cfg.n_layers} x "
        f"{fwd.n_decode} decode forwards; kernels == plain ({flips} "
        f"near-tie divergences); warm ids equal to cold for {same_cold} of "
        f"{len(reqs)} requests (printed, not required); {wall:.1f}s on "
        f"{card}")
    call = rec.calls[len(rec.calls) // 2]
    return dict(_split_entry(torch, call, "deepseek-v3-671b f32 cached "
                             "prefill", dtype="float32"),
                launches=counts["decode_attention_split"],
                prefill_launches=len(rec.calls), dtype="float32", card=card)


class PrefillTimer:
    """Host wall of each admission prefill, cached (``_cached_prefill``:
    the tail as one decode) and full (``_full_prefill``), the card
    synchronised before and after each; and the width each fed."""

    def __init__(self, torch):
        self.torch = torch
        self.cached, self.full = [], []

    def __enter__(self):
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler
        cls, torch, t = ContinuousBatchingScheduler, self.torch, self
        self.orig = (cls._cached_prefill, cls._full_prefill)

        def cached(sched, slot, ids, page_ids, n_cached):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = t.orig[0](sched, slot, ids, page_ids, n_cached)
            torch.cuda.synchronize()
            t.cached.append((time.perf_counter() - t0,
                             len(ids) - n_cached * sched.page_size))
            return out

        def full(sched, sess, slot, ids, page_ids):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = t.orig[1](sched, sess, slot, ids, page_ids)
            torch.cuda.synchronize()
            t.full.append((time.perf_counter() - t0, len(ids)))
            return out
        cls._cached_prefill, cls._full_prefill = cached, full
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler
        (ContinuousBatchingScheduler._cached_prefill,
         ContinuousBatchingScheduler._full_prefill) = self.orig

    @staticmethod
    def mean(rows):
        if not rows:
            return "none"
        return (f"{sum(r[0] for r in rows) / len(rows) * 1e3:.2f} ms a call "
                f"over {len(rows)}, {sum(r[1] for r in rows) / len(rows):.1f}"
                " tokens fed")


def _timed_pfx(torch, eng, reqs, prefix_cache):
    """A timed run of the Zipf cell without the invariant audit: (results,
    scheduler, wall seconds, mean seconds from admission to the end of the
    tick that committed a request's first token)."""
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    sched = ContinuousBatchingScheduler(
        eng, capacity=PFX_SLOTS, page_size=PFX_PAGE_SIZE,
        n_pages=PFX_N_PAGES, prefix_cache=prefix_cache)
    sess = [sched.submit(r) for r in reqs]
    first = {}
    t0 = time.perf_counter()
    while sched.waiting or any(s is not None for s in sched.slots):
        sched.step()
        now = time.perf_counter()
        for s in sess:
            if s.rid not in first and s.out_ids:
                first[s.rid] = now - s.t_admit
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = sum(first.values()) / max(len(first), 1)
    return [s.result for s in sess], sched, wall, ttft


def phase_prefix(torch, card, shared):
    """Phase 9, the radix prefix cache at stablelm-1.6b's published width:
    (a) the bench's Zipf-preamble trace in float32 cold, then warm through
    the kernels (ids equal under the margin rule, >= 90% of the shareable
    prefill tokens skipped, the pool leak-free after the cache's reset,
    launches of #1 counted with cached prefills as decode forwards of
    width S), and warm through the plain path; (b) bfloat16 cold, warm,
    warm, cold (tok/s, admission to first token, cached against full
    prefill walls) and #1's ``prefix`` entry on a mid-run cached-prefill
    call; (c) the device loop with the cache, float32, cold and warm, one
    recording across the cached admissions; (d) a journaled warm run
    crashed and restored with the cache (checker clones, cached admit
    records), then the serve CLI's SIGKILL drill with ``--prefix-cache``.
    Returns #1's ``prefix`` entry."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.models import build_model
    from repro_torch.serving import (ConstraintSpec, DecodeParams, Request,
                                     ServingEngine, TokenJournal,
                                     read_records)
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    tok = shared["tok"]
    base = get_config("stablelm-1.6b")

    def engine(dtype, kernels, params=None, names=("json", "c"),
               device_tables=False):
        model = build_model(dataclasses.replace(
            base, dtype=dtype, use_pallas_kernels=kernels))
        if params is None:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            params = model.init(gen, device="cuda")
        eng = ServingEngine(model, params, tok, max_len=MAX_LEN,
                            device_tables=device_tables, device="cuda")
        register_grammars(eng, shared, names)
        return eng

    # (a) float32 through the kernels, cold then warm, and warm plain
    reqs = _zipf_trace()
    eng_k = engine("float32", True)
    cfg = eng_k.model.cfg
    log(f"[prefix] (a) {describe(cfg)}, float32; the bench's Zipf trace: "
        f"{PFX_N_REQUESTS} requests over preambles of "
        f"{[len(tok.encode(p)) for p in PFX_PREAMBLES]} tokens, "
        f"{PFX_MAX_TOKENS} tokens each, {PFX_PAGE_SIZE}-token pages, "
        f"{PFX_N_PAGES} pages, {PFX_SLOTS} slots")
    t0 = time.perf_counter()
    cold, _ = pfx_run(torch, eng_k, reqs, False)
    t_cold = time.perf_counter() - t0
    with ForwardCount(eng_k) as fwd:
        reset_counts()
        t0 = time.perf_counter()
        warm, sched = pfx_run(torch, eng_k, reqs, True)
        t_warm = time.perf_counter() - t0
        counts = read_counts()
    check_launches(cfg, counts, fwd, "(a) warm kernel run")
    st = sched.stats()
    tails = {s: n for s, n in sorted(fwd.decode.items()) if s > 1}
    shareable = _shareable(sched.finished, PFX_PAGE_SIZE)
    flips = same_ids(torch, eng_k, reqs, warm, cold, "(a) warm against cold")
    n_argmax = counts["masked_argmax_packed"]
    if st["n_prefix_tokens"] < 0.9 * shareable \
            or sum(tails.values()) != st["n_prefix_hits"] \
            or not 0 < n_argmax <= st["n_host_syncs"]:
        raise AssertionError(f"(a) warm run: {st['n_prefix_tokens']} of "
                             f"{shareable} shareable tokens skipped, "
                             f"{st['n_prefix_hits']} hits, cached-prefill "
                             f"widths {tails}, #2 {n_argmax} launches for "
                             f"{st['n_host_syncs']} selection ticks")
    _drained_after_reset(sched, "(a) warm run")
    log(f"[prefix] (a) warm == cold ({flips} near-tie divergences): "
        f"{st['n_prefix_hits']} hits, {st['n_prefix_tokens']} of "
        f"{shareable} shareable prefill tokens skipped "
        f"({st['n_prefix_tokens'] / max(shareable, 1):.3f}), "
        f"{st['prefix_n_evicted']} evictions, {st['prefix_n_inserted']} "
        f"nodes inserted; launches decode_attention "
        f"{counts['decode_attention']} = {cfg.n_layers} x {fwd.n_decode} "
        f"decode forwards ({sum(tails.values())} of them cached prefills, "
        f"by S {tails}) + 0 x {fwd.prefill} full prefills, "
        f"masked_argmax_packed {n_argmax} for {st['n_host_syncs']} "
        f"selection ticks; pool leak-free after the cache's reset; cold "
        f"{t_cold:.1f}s, warm {t_warm:.1f}s (audited) on {card}")
    eng_p = engine("float32", False, params=eng_k.params)
    warm_p, _ = pfx_run(torch, eng_p, reqs, True)
    flips = same_ids(torch, eng_k, reqs, warm, warm_p,
                     "(a) warm, kernels against plain")
    log(f"[prefix] (a) warm through the kernels == warm through the plain "
        f"path ({flips} near-tie divergences)")
    del eng_p, warm_p

    # (c) the device loop with the cache: certified JSON rows sharing a
    # preamble, 2 slots, so admissions arrive between fused blocks
    reqs_c = [Request(PFX_SHARED + f"r{i}: ",
                      ConstraintSpec(grammar="json", mode="domino"),
                      DecodeParams(max_tokens=MAX_TOKENS))
              for i in range(4)]
    eng_d = engine("float32", True, params=eng_k.params, names=("json",),
                   device_tables=True)
    device_tables_for(eng_d, shared)
    loop = dict(capacity=2, device_loop=True, sync_n=8)
    cold_c, _ = pfx_run(torch, eng_d, reqs_c, False, **loop)
    after = []
    orig = ContinuousBatchingScheduler._cached_prefill

    def cached_prefill(sched, *args):
        after.append(sched._fused is not None
                     and sched._fused.graph is not None)
        return orig(sched, *args)
    ContinuousBatchingScheduler._cached_prefill = cached_prefill
    try:
        with FusedAudit(torch) as audit, ForwardCount(eng_d) as fwd:
            reset_counts()
            warm_c, sched = pfx_run(torch, eng_d, reqs_c, True, **loop)
            counts = read_counts()
    finally:
        ContinuousBatchingScheduler._cached_prefill = orig
    flips = same_ids(torch, eng_d, reqs_c, warm_c, cold_c,
                     "(c) device loop warm against cold")
    line = check_fused(cfg, sched, counts, fwd, audit, "(c) warm device loop")
    if sched._fused.n_records != 1 or not any(after) \
            or sched.n_device_tokens == 0 or sched.n_prefix_hits == 0:
        raise AssertionError(f"(c) warm device loop: {sched._fused.n_records}"
                             f" recordings, cached admissions after the "
                             f"recording {after}, {sched.n_device_tokens} "
                             f"device tokens, {sched.n_prefix_hits} hits")
    _drained_after_reset(sched, "(c) warm device loop")
    log(f"[prefix] (c) device loop, sync_n 8, 2 slots: warm == cold "
        f"({flips} near-tie divergences); {sched.n_prefix_hits} hits, "
        f"{sum(after)} of {len(after)} cached admissions after the graph "
        f"was recorded, one recording; {sched.n_device_tokens} of "
        f"{sum(r.n_tokens for r in warm_c)} tokens in fused blocks; {line}")
    del eng_d

    # (d) durability: identical requests (identical outputs), so a
    # restored entry clones the checker snapshot of the one before it
    reqs_d = [Request(PFX_SHARED, ConstraintSpec(grammar="json",
                                                 mode="domino"),
                      DecodeParams(max_tokens=MAX_TOKENS))
              for _ in range(3)]
    dur = dict(capacity=2, page_size=PFX_PAGE_SIZE, n_pages=None)
    ref, _ = pfx_run(torch, eng_k, reqs_d, True, **dur)
    crash_after = max(1, min(r.n_tokens for r in ref[:2]) // 2)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "journal")
        journal = TokenJournal(path, crash_after_syncs=crash_after,
                               crash_hook=_crash_hook)
        sched = ContinuousBatchingScheduler(eng_k, journal=journal,
                                            prefix_cache=True, **dur)
        for r in reqs_d:
            sched.submit(r)
        try:
            sched.run()
            raise AssertionError("(d) the journaled run did not crash")
        except CrashHook:
            journal.dead = True        # the process is gone
        admits = [r for r in read_records(path) if r["kind"] == "admit"]
        with ForwardCount(eng_k) as fwd:
            reset_counts()
            t0 = time.perf_counter()
            rest = eng_k.restore(path, prefix_cache=True,
                                 debug_invariants=True, **dur)
            n_live, clones = len(rest.waiting), rest.n_checker_clones
            got = rest.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
    check_launches(cfg, counts, fwd, "(d) restore")
    flips = same_ids(torch, eng_k, reqs_d, got, ref,
                     "(d) restored against uninterrupted")
    cached = [a["cached_pages"] for a in admits]
    if clones == 0 or not any(cached):
        raise AssertionError(f"(d) restore: {clones} checker clones, admit "
                             f"records' cached pages {cached}")
    _drained_after_reset(rest, "(d) restore")
    log(f"[prefix] (d) crash after {crash_after} fsyncs, restore with the "
        f"cache: {n_live} of {len(got)} requests resumed live, {clones} "
        f"checker clones, admit records' cached pages {cached}; ids == the "
        f"uninterrupted run ({flips} near-tie divergences); {wall:.1f}s on "
        f"{card}")
    del eng_k
    torch.cuda.empty_cache()

    # (b) bfloat16: cold, warm, warm, cold on one engine; #1's entry on a
    # mid-run cached prefill of "warm 1"
    eng = engine("bfloat16", True)
    for pc in (False, True):                  # warm-up: shapes, allocator
        _timed_pfx(torch, eng, reqs, pc)
    runs = {}
    for what in ("cold 1", "warm 1", "warm 2", "cold 2"):
        rec = Recorder(attn_ops, "decode_attention_cuda", min_width=2)
        with rec, PrefillTimer(torch) as pt:
            reset_counts()
            res, sched, wall, ttft = _timed_pfx(torch, eng, reqs,
                                                what.startswith("warm"))
            counts = read_counts()
        n_tok = sum(r.n_tokens for r in res)
        runs[what] = (n_tok / wall, ttft, pt, rec, counts, sched)
        log(f"[prefix] (b) stablelm-1.6b bf16 {what}: {n_tok} tokens in "
            f"{wall:.3f}s = {n_tok / wall:.1f} tok/s; admission to first "
            f"token {ttft * 1e3:.1f} ms (mean); {sched.n_prefix_hits} hits, "
            f"{sched.n_prefix_tokens} prefill tokens skipped; cached "
            f"prefill {pt.mean(pt.cached)}; full prefill "
            f"{pt.mean(pt.full)}; on {card}")
    mean = {m: [sum(runs[f"{m} {i}"][j] for i in (1, 2)) / 2
                for j in (0, 1)] for m in ("cold", "warm")}
    log(f"[prefix] (b) bf16 warm over cold (means of two runs each): tok/s "
        f"{mean['warm'][0]:.1f} / {mean['cold'][0]:.1f} = "
        f"{mean['warm'][0] / mean['cold'][0]:.3f}; admission to first "
        f"token {mean['warm'][1] * 1e3:.1f} / {mean['cold'][1] * 1e3:.1f} ms")
    _, _, _, rec, counts, _ = runs["warm 1"]
    if not rec.calls:
        raise AssertionError("(b) warm 1 recorded no cached prefill")
    call = rec.calls[len(rec.calls) // 2]
    entry = dict(_attn_entry(torch, call, "stablelm-1.6b bf16 cached "
                             "prefill"),
                 launches=counts["decode_attention"],
                 prefill_launches=len(rec.calls), dtype="bfloat16",
                 card=card)
    del eng, runs, rec, call
    torch.cuda.empty_cache()

    # (d) the serve CLI's SIGKILL drill through the cache, three processes
    t0 = time.perf_counter()
    drill = _sigkill_drill(DRILL_PFX, tag="[prefix] (d) drill")
    log(f"[prefix] (d) SIGKILL drill ({' '.join(DRILL_ARGS + DRILL_PFX)}): "
        f"the crashed run died by SIGKILL after {DRILL_CRASH_AFTER} fsyncs; "
        f"{drill} requests restored with IDS lines equal to the reference "
        f"run's; three processes in {time.perf_counter() - t0:.1f}s on "
        f"{card}")
    return entry


# -- phase 10: training ---------------------------------------------------------

TRAIN_ARCH = "stablelm-1.6b"
TRAIN_STEPS = 20
TRAIN_WARMUP = 2                 # steps left out of the median step time
TRAIN_BATCH, TRAIN_SEQ = 8, 128
# the JAX package's trainer default of 3e-3 is tuned for the smoke configs;
# at 1.2 B parameters AdamW's first steps move every weight by ~lr
TRAIN_LR = 3e-4
# the paper's bench model and recipe, as ``benchmarks/common.py`` trains it
# (that module imports jax, which the card's machine does not have)
BENCH_CFG = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
                 dtype="float32", max_seq_len=1024)
BENCH_STEPS, BENCH_SEQ, BENCH_BATCH = 500, 192, 8
BENCH_EVAL = 32                  # easy task prompts for the accuracy print
FLASH_S = 2048                   # above attention_any's 1024^2 threshold
FLASH_TOL = dict(atol=2e-4, rtol=1e-3)   # tests/test_models.py's


def _train_full_width(torch, card, ckpt):
    """(a): the trainer CLI's ``main`` at stablelm-1.6b's published width
    and depth in float32 on JSON LM rows; params saved to ``ckpt``."""
    import shutil
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = train.main(["--arch", TRAIN_ARCH, "--dtype", "float32",
                      "--steps", str(TRAIN_STEPS),
                      "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                      "--lr", str(TRAIN_LR), "--save", str(ckpt)])
    peak = torch.cuda.max_memory_allocated() - base
    losses, cfg = out["losses"], out["cfg"]
    grad_norms, step_s = out["grad_norms"], out["step_s"]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"(a) losses not finite and falling: {losses}")
    steps = sorted(out["step_s"][TRAIN_WARMUP:])
    med_ms = steps[len(steps) // 2] * 1e3
    tokens = out["tokens_per_step"]
    n = out["n_params"]
    bound, _ = bound_ms(0, 6 * n * tokens, "float32")
    free = shutil.disk_usage(ckpt).free
    log(f"[train] (a) {describe(cfg)}: {n / 1e9:.3f} B parameters, "
        f"{TRAIN_STEPS} AdamW steps (wsd, lr {TRAIN_LR:g}, warmup "
        f"{max(1, TRAIN_STEPS // 10)}) at batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ} of JSON LM rows in {cfg.dtype}, the group "
        f"rematerialized, TF32 off; "
        f"no depth cut")
    log(f"[train] (a) loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{med_ms:.1f} ms (median of steps {TRAIN_WARMUP}..{TRAIN_STEPS - 1}"
        f"; min {steps[0] * 1e3:.1f}, max {steps[-1] * 1e3:.1f}) against a "
        f"bound of {bound:.1f} ms (6 x params x tokens at 67 TFLOP/s f32); "
        f"{tokens / (med_ms / 1e3):.0f} tokens/s; peak "
        f"{peak / 1e9:.2f} GB allocated above the phase's start; on {card}")
    ck_bytes = sum(p.stat().st_size for p in pathlib.Path(ckpt).iterdir())
    log(f"[train] (a) checkpoint {ck_bytes / 1e9:.2f} GB written "
        f"({free / 1e9:.0f} GB free after it)")
    del out
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": med_ms, "bound_ms": bound,
            "tokens_per_s": tokens / (med_ms / 1e3), "peak_gb": peak / 1e9,
            "n_params": n, "grad_norms": grad_norms, "step_s": step_s}


def _serve_checkpoint(torch, card, ckpt):
    """(b): the serve CLI on the checkpoint through the kernels, then in
    process in float32 through the kernels against the plain path."""
    import dataclasses
    import os

    from repro_torch.configs import get_config
    from repro_torch.core import grammars
    from repro_torch.core.domino import DominoDecoder
    from repro_torch.models import build_model
    from repro_torch.serving import (ConstraintSpec, DecodeParams, Request,
                                     ServingEngine)
    from repro_torch.tokenizer import BPETokenizer
    from repro_torch.training import checkpoint

    tok = BPETokenizer.load(os.path.join(ckpt, "tokenizer.json"))
    json_g = grammars.load("json")

    def check_valid(ids_list, what):
        for i, ids in enumerate(ids_list):
            d = DominoDecoder(json_g, list(tok.vocab), tok.eos_id)
            if not all(d.advance(t) for t in ids):
                raise AssertionError(f"{what}: request {i} leaves the JSON "
                                     "grammar")

    argv = ["--arch", TRAIN_ARCH, "--no-smoke", "--checkpoint", str(ckpt),
            "--kernels", "--grammar", "json", "--mode", "domino",
            "--prompts", str(N_REQUESTS), "--slots", str(N_REQUESTS),
            "--max-tokens", str(MAX_TOKENS), "--print-ids"]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"]
                         + argv, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ,
                                               PYTHONPATH=str(ROOT / "src")))
    if out.returncode != 0:
        raise AssertionError(f"(b) serve CLI failed: {out.stderr[-2000:]}")
    cli_ids = [[int(t) for t in ln.split()[2:]]
               for ln in out.stdout.splitlines() if ln.startswith("IDS ")]
    if len(cli_ids) != N_REQUESTS:
        raise AssertionError(f"(b) serve CLI printed {len(cli_ids)} IDS "
                             f"lines: {out.stdout[-2000:]}")
    check_valid(cli_ids, "(b) serve CLI")
    outs = [ln for ln in out.stdout.splitlines() if "out[" in ln]
    log(f"[train] (b) python -m repro_torch.launch.serve {' '.join(argv)}: "
        f"{len(cli_ids)} outputs valid under a fresh DominoDecoder, "
        f"{sum(map(len, cli_ids))} tokens, {time.perf_counter() - t0:.1f}s "
        f"for the process; first: {outs[0].strip()[:160] if outs else ''}")

    # in process, float32: kernels against plain on the same params
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              vocab_size=tok.vocab_size, dtype="float32",
                              use_pallas_kernels=True)
    model_k = build_model(cfg)
    params, _, meta = checkpoint.load(ckpt, model_k, "cuda")
    model_p = build_model(dataclasses.replace(cfg, use_pallas_kernels=False))
    reqs = [Request(PROMPTS[i % len(PROMPTS)],
                    ConstraintSpec(grammar="json", mode="domino"),
                    DecodeParams(max_tokens=MAX_TOKENS, seed=i))
            for i in range(N_REQUESTS)]
    engines = []
    trees = None
    for model in (model_k, model_p):
        eng = ServingEngine(model, params, tok, max_len=MAX_LEN,
                            device="cuda")
        trees = eng.register_grammar("json", json_g, tree_cache=trees)
        engines.append(eng)
    eng_k, eng_p = engines
    with ForwardCount(eng_k) as fwd:
        reset_counts()
        got = eng_k.generate_batch(reqs, max_batch=N_REQUESTS,
                                   page_size=PAGE_SIZE)
        torch.cuda.synchronize()
        counts = read_counts()
    check_launches(cfg, counts, fwd, "(b) kernels")
    reset_counts()
    want = eng_p.generate_batch(reqs, max_batch=N_REQUESTS,
                                page_size=PAGE_SIZE)
    if read_counts()["decode_attention"]:
        raise AssertionError(f"(b) the plain path launched {read_counts()}")
    check_valid([r.token_ids for r in got], "(b) kernels")
    n_tie = same_ids(torch, eng_p, reqs, got, want, "(b) kernels vs plain")
    log(f"[train] (b) in process, float32, meta {meta}: kernels == plain "
        f"({n_tie} near-tie divergences); statuses "
        f"{[r.status for r in got]}; launches decode_attention "
        f"{counts['decode_attention']} (paged), masked_argmax_packed "
        f"{counts['masked_argmax_packed']} over {fwd.prefill} prefills and "
        f"{fwd.n_decode} decode forwards; on {card}")
    del engines, eng_k, eng_p, params
    torch.cuda.empty_cache()
    return counts


def _bench_tokenizer():
    """``benchmarks/common.py:get_tokenizer``'s recipe."""
    import random

    from repro_torch.core import grammars
    from repro_torch.core.sampling import GrammarSampler
    from repro_torch.tokenizer import train_bpe
    from repro_torch.training.data import few_shot_prefix
    corpus = b""
    for name in ("json", "json_gsm8k", "c", "xml_schema"):
        corpus += GrammarSampler(grammars.load(name), seed=13).corpus(250)
        corpus += b"\n"
    corpus += few_shot_prefix(random.Random(0), 60, easy=True).encode()
    return train_bpe(corpus, vocab_size=600)


def _bench_model(torch, card):
    """(c): ``bench-2l`` trained to ``benchmarks/common.py``'s recipe, then
    ``tests/test_system.py``'s three bars on the card."""
    import random

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import grammars
    from repro_torch.core.domino import DominoDecoder
    from repro_torch.models import build_model
    from repro_torch.serving import (ConstraintSpec, DecodeParams,
                                     EngineConfig, Request, ServingEngine)
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import (GrammarLMDataset, TaskDataset,
                                           evaluate_answer, few_shot_prefix,
                                           make_task_example)
    from repro_torch.training.train_loop import (detached, make_train_step,
                                                 to_device)

    t0 = time.perf_counter()
    tok = _bench_tokenizer()
    cfg = ModelConfig(arch_id="bench-2l", family="dense",
                      vocab_size=tok.vocab_size, **BENCH_CFG)
    model = build_model(cfg)
    params = model.init(device="cuda")
    step = make_train_step(model, opt.AdamWConfig(
        lr=3e-3, schedule="wsd", warmup_steps=10, total_steps=BENCH_STEPS))
    state = opt.init_state(params)
    task = TaskDataset(tok, seq_len=BENCH_SEQ, few_shot=1,
                       easy=True).batches(BENCH_BATCH)
    lm = GrammarLMDataset(tok, "json", seq_len=BENCH_SEQ).batches(BENCH_BATCH)
    losses = []
    for i in range(BENCH_STEPS):
        src = task if i % 3 else lm     # 2/3 task, 1/3 free-form JSON
        params, state, metrics = step(params, state,
                                      to_device(next(src), "cuda"))
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    params = detached(params)
    train_s = time.perf_counter() - t0
    if not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"(c) loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                             "not below 0.7 of the first")
    gsm = grammars.load("json_gsm8k")
    eng = ServingEngine(model, params, tok, gsm,
                        EngineConfig(mode="domino", max_tokens=48),
                        max_len=512, device="cuda")
    r = eng.generate('Q: compute 3 + 4\nA: ')
    d = DominoDecoder(gsm, list(tok.vocab), tok.eos_id)
    if not all(d.advance(t) for t in r.token_ids) \
            or (r.finished and not d.eos_legal()):
        raise AssertionError(f"(c) constrained output invalid: {r.text!r}")
    plain = ServingEngine(model, params, tok, gsm,
                          EngineConfig(mode="domino", max_tokens=40),
                          max_len=512, device="cuda")
    r0 = plain.generate('Q: compute 5 + 2\nA: ')
    spec = ServingEngine(model, params, tok, gsm,
                         EngineConfig(mode="domino", speculative=True,
                                      spec_s=8, spec_threshold=0.4,
                                      max_tokens=40),
                         max_len=512, device="cuda")
    spec.generate('Q: compute 5 + 2\nA: ')     # prior formation
    r1 = spec.generate('Q: compute 5 + 2\nA: ')
    if r1.token_ids != r0.token_ids \
            or r1.n_forward_passes > r0.n_forward_passes:
        raise AssertionError(f"(c) speculation: ids equal "
                             f"{r1.token_ids == r0.token_ids}, forwards "
                             f"{r1.n_forward_passes} vs {r0.n_forward_passes}")
    n_verify = max(1, r1.n_forward_passes - 1)      # after the prefill
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[train] (c) bench-2l ({n_params / 1e6:.2f} M parameters, vocab "
        f"{tok.vocab_size}): {BENCH_STEPS} steps in "
        f"{train_s:.1f}s, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({losses[-1] / losses[0]:.3f} of the first); constrained output "
        f"valid ({r.n_tokens} tokens, {r.text[:60]!r}); speculative ids == "
        f"plain in {r1.n_forward_passes} forwards against "
        f"{r0.n_forward_passes}, {r1.n_spec_accepted}/{r1.n_spec_proposed} "
        f"proposals accepted, {r1.n_tokens / n_verify:.2f} tokens a forward "
        f"after the prefill "
        f"({r0.n_tokens / max(1, r0.n_forward_passes - 1):.2f} plain); on "
        f"{card}")

    # task accuracy, constrained against unconstrained (no bar)
    rng = random.Random(1)
    exs = []
    for _ in range(BENCH_EVAL):
        ex = make_task_example(rng, easy=True)
        exs.append((few_shot_prefix(rng, 1, easy=True) + ex.prompt,
                    ex.answer_value))
    acc = {}
    for mode in ("domino", "unconstrained"):
        e = ServingEngine(model, params, tok, gsm, max_len=512, device="cuda")
        spec_c = ConstraintSpec() if mode == "unconstrained" else \
            ConstraintSpec(grammar="default", mode="domino")
        res = e.generate_batch([Request(p, spec_c,
                                        DecodeParams(max_tokens=96))
                                for p, _ in exs], max_batch=8)
        acc[mode] = (sum(evaluate_answer(r.text) == v
                         for r, (_, v) in zip(res, exs)),
                     sum(evaluate_answer(r.text) is not None for r in res))
    log(f"[train] (c) task accuracy over {BENCH_EVAL} easy prompts "
        f"(few-shot 1): constrained {acc['domino'][0]}/{BENCH_EVAL} "
        f"({acc['domino'][1]} parsable), unconstrained "
        f"{acc['unconstrained'][0]}/{BENCH_EVAL} "
        f"({acc['unconstrained'][1]} parsable)")
    return {"losses": (losses[0], losses[-1]),
            "forwards": (r1.n_forward_passes, r0.n_forward_passes),
            "accepted": (r1.n_spec_accepted, r1.n_spec_proposed),
            "accuracy": acc}


def _guard_calls(torch):
    """Each kernel wrapper with small valid operands on the card, the first
    float operand requiring grad."""
    w = _wrappers()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def f(*shape, grad=False):
        return torch.randn(shape, generator=gen,
                           device="cuda").requires_grad_(grad)

    lens = torch.tensor([4], dtype=torch.int32, device="cuda")
    lat = f(1, 8, 1, 16)
    return {
        "decode_attention": (f(1, 1, 1, 1, 16, grad=True), f(1, 8, 1, 16),
                             f(1, 8, 1, 16), lens),
        "decode_attention_split": (f(1, 1, 1, 2, 16, grad=True), lat, lat,
                                   f(1, 1, 1, 2, 8), f(1, 8, 1, 8), lens),
        "masked_argmax_packed": (f(1, 64, grad=True), torch.full(
            (1, 2), -1, dtype=torch.int32, device="cuda")),
        "masked_argmax_bytes": (f(1, 64, grad=True), torch.ones(
            (1, 64), dtype=torch.bool, device="cuda")),
        "mamba_scan": (f(1, 2, 4, grad=True), f(1, 2, 4), f(1, 2, 4),
                       f(1, 2, 4), -f(4, 4).abs(), f(1, 4, 4)),
        "ssd_scan": (f(1, 2, 1, 8, grad=True), f(1, 2, 8), f(1, 2, 8),
                     -f(1, 2, 1).abs(), f(1, 2, 1).abs(), f(1, 1, 8, 8)),
    }, w


def _flash_and_guards(torch, card):
    """(d): the flash backward at S = T = 2048 against naive autograd; the
    grad guard of every wrapper; SSM training with the kernels refused."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.flash import blocked_attention, naive_attention
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step, to_device

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    b, g, qh, d = 1, 4, 2, 64
    q = torch.randn((b, FLASH_S, g, qh, d), generator=gen, device="cuda")
    k = torch.randn((b, FLASH_S, g, d), generator=gen, device="cuda")
    v = torch.randn((b, FLASH_S, g, d), generator=gen, device="cuda")
    pos = torch.arange(FLASH_S, dtype=torch.int32, device="cuda").expand(
        b, FLASH_S)
    grads, peaks = [], []
    for fn in (blocked_attention, naive_attention):
        qq, kk, vv = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(qq, kk, vv, pos, pos)
        grads.append(torch.autograd.grad((out ** 2).sum(), (qq, kk, vv)))
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 1e6)
        del out
    err = 0.0
    for a, c in zip(*grads):
        bad = (a - c).abs() > FLASH_TOL["atol"] + FLASH_TOL["rtol"] * c.abs()
        if bool(bad.any()):
            raise AssertionError(f"(d) flash grads disagree at "
                                 f"{int(bad.sum())} elements")
        err = max(err, float((a - c).abs().max()))
    log(f"[train] (d) blocked_attention backward at S = T = {FLASH_S} "
        f"(B={b} G={g} Qh={qh} D={d} f32, tiles 512 x 1024) == naive "
        f"autograd within atol 2e-4 rtol 1e-3 (max abs err {err:.2e}); peak "
        f"above the inputs {peaks[0]:.1f} MB against {peaks[1]:.1f} MB; on "
        f"{card}")

    calls, wrappers = _guard_calls(torch)
    for name, args in calls.items():
        before = wrappers[name].launches
        try:
            wrappers[name](*args)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"(d) {name} launched on an operand that "
                                 "requires grad")
        if wrappers[name].launches != before:
            raise AssertionError(f"(d) {name} counted a refused launch")
    log(f"[train] (d) every kernel wrapper refuses an operand that requires "
        f"grad: {', '.join(calls)}")

    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  use_pallas_kernels=True)
        model = build_model(cfg)
        params = model.init(device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen,
                             device="cuda", dtype=torch.int32)
        try:
            model.loss(params, {"tokens": toks})
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"(d) {arch}: loss ran with the kernels")
        plain = build_model(dataclasses.replace(cfg, use_pallas_kernels=False))
        _, _, met = make_train_step(plain, opt.AdamWConfig())(
            params, opt.init_state(params), to_device(
                {"tokens": toks.cpu().numpy()}, "cuda"))
        if not math.isfinite(float(met["loss"])):
            raise AssertionError(f"(d) {arch}: step loss {met['loss']}")
        log(f"[train] (d) {arch} smoke: loss with use_pallas_kernels "
            f"refused; one step with it off, loss {float(met['loss']):.4f}")
    return {"flash_err": err, "flash_peak_mb": peaks}


def phase_training(torch, card):
    """Phase 10: (a) stablelm-1.6b trained at full width, (b) its checkpoint
    served, (c) the bench model, (d) the flash backward and the guards."""
    import shutil
    import tempfile
    ckpt = pathlib.Path(tempfile.mkdtemp(prefix="ck-"))
    try:
        t0 = time.perf_counter()
        a = _train_full_width(torch, card, ckpt)
        log(f"[train] (a) {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        _serve_checkpoint(torch, card, ckpt)
        log(f"[train] (b) {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    c = _bench_model(torch, card)
    log(f"[train] (c) {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    d = _flash_and_guards(torch, card)
    log(f"[train] (d) {time.perf_counter() - t0:.1f}s")
    return {"a": a, "c": c, "d": d}


# -- phase 12: scale-out and the serve flags ------------------------------------

MESH_STEPS = 2          # the mesh trainer's steps, held to phase 10 (a)'s
MESH_TOL = 1e-4         # relative, as the CPU tests' step parity
# the serve CLI's flags of phase 12 (b), with and without --opportunistic
FLAG_ARGV = ["--arch", TRAIN_ARCH, "--no-smoke", "--kernels", "--dtype",
             "float32", "--k", "2", "--analyze", "warn", "--print-ids",
             "--prompts", str(N_REQUESTS), "--slots", str(N_REQUESTS),
             "--max-tokens", str(MAX_TOKENS)]


def _mesh_train(torch, card, plain):
    """(a): the trainer CLI's ``--mesh 1x1`` (an NCCL world of one rank
    over a file store, the params and moments DTensors on a 1 x 1
    DeviceMesh) at stablelm-1.6b's published width in float32, 2 steps on
    phase 10 (a)'s flags; its first two steps' losses and grad norms (the
    schedule reaches step 2's learning rate only after them) held to phase
    10 (a)'s."""
    from repro_torch.launch import train
    out = train.main(["--arch", TRAIN_ARCH, "--dtype", "float32",
                      "--steps", str(MESH_STEPS), "--batch", str(TRAIN_BATCH),
                      "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
                      "--mesh", "1x1"])
    import torch.distributed as dist
    if dist.is_initialized():
        raise AssertionError("(a) the mesh trainer left its world up")
    pairs = {"loss": (out["losses"], plain["losses"][:MESH_STEPS]),
             "grad norm": (out["grad_norms"],
                           plain["grad_norms"][:MESH_STEPS])}
    diffs = {}
    for what, (got, want) in pairs.items():
        if not all(math.isfinite(x) for x in got):
            raise AssertionError(f"(a) mesh {what}es not finite: {got}")
        rel = max(abs(g - w) / max(abs(w), 1e-12) for g, w in zip(got, want))
        if rel > MESH_TOL:
            raise AssertionError(f"(a) mesh {what}es {got} against the "
                                 f"unsharded {want}: rel {rel:.3g}")
        diffs[what] = (got, want, rel)
    for what, (got, want, rel) in diffs.items():
        log(f"[scaleout] (a) {what} on the 1x1 mesh {got} against phase 10 "
            f"(a)'s unsharded {want}: largest relative difference "
            f"{rel:.3g} (limit {MESH_TOL:g})")
    ms = [x * 1e3 for x in out["step_s"]]
    plain_ms = [x * 1e3 for x in plain["step_s"][:MESH_STEPS]]
    log(f"[scaleout] (a) step times on the 1x1 mesh "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms (the first builds "
        f"DTensor's sharding plans) against the unsharded "
        f"{', '.join(f'{x:.1f}' for x in plain_ms)} ms (phase 10 (a)'s "
        f"median {plain['step_ms']:.1f} ms) at batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, float32; on {card}")
    torch.cuda.empty_cache()
    return {"losses": out["losses"], "grad_norms": out["grad_norms"],
            "step_ms": ms, "plain_step_ms": plain_ms,
            "rel": {k: v[2] for k, v in diffs.items()}}


def _serve_flags(torch, card):
    """(b): the serve CLI in process at full width through the kernels with
    ``--k 2 --analyze warn`` and ``--opportunistic``, against the same run
    without it: equal ids, the [analysis] lines, #1/#2 launches of each."""
    import contextlib
    import io

    from repro_torch.launch import serve
    runs = {}
    for name, extra in (("opportunistic", ["--opportunistic"]),
                        ("masked", [])):
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(FLAG_ARGV + extra)
        torch.cuda.synchronize()
        counts = read_counts()
        text = buf.getvalue()
        ids = [ln for ln in text.splitlines() if ln.startswith("IDS ")]
        analysis = [ln for ln in text.splitlines()
                    if ln.startswith("[analysis] ")]
        if len(ids) != N_REQUESTS or not analysis:
            raise AssertionError(f"(b) {name}: {len(ids)} IDS lines, "
                                 f"{len(analysis)} [analysis] lines: "
                                 f"{text[-2000:]}")
        runs[name] = (ids, analysis, counts, time.perf_counter() - t0,
                      [ln.strip() for ln in text.splitlines()
                       if "out[" in ln])
    # the masked run selects through #2 (one launch a tick for the batch;
    # an opportunistic row masks only where its unconstrained choice is
    # illegal, so that run may launch none), and decodes through #1
    counts, outs = runs["masked"][2], runs["masked"][4]
    n_tok = sum(len(x.split()) - 2 for x in runs["masked"][0])
    if not counts["masked_argmax_packed"] or (
            n_tok > N_REQUESTS and not counts["decode_attention"]):
        raise AssertionError(f"(b) masked run: {n_tok} tokens but launches "
                             f"{counts}: {outs}")
    if runs["opportunistic"][0] != runs["masked"][0]:
        raise AssertionError(f"(b) ids differ: {runs['opportunistic'][0]} "
                             f"against {runs['masked'][0]}")
    for line in runs["masked"][1]:
        log(f"[scaleout] (b) {line}")
    for name, (ids, _, counts, sec, outs) in runs.items():
        log(f"[scaleout] (b) serve {' '.join(FLAG_ARGV)}"
            f"{' --opportunistic' if name == 'opportunistic' else ''}: "
            f"{sum(len(x.split()) - 2 for x in ids)} tokens, launches "
            f"decode_attention {counts['decode_attention']}, "
            f"masked_argmax_packed {counts['masked_argmax_packed']}; "
            f"{sec:.1f}s; on {card}; first: {outs[0][:120] if outs else ''}")
    log("[scaleout] (b) ids with --opportunistic equal the ids without it")
    torch.cuda.empty_cache()
    return {name: run[2] for name, run in runs.items()}


def phase_scaleout(torch, card, train_out):
    """Phase 12: (a) the trainer's mesh path on the card, (b) the serve
    CLI's --k, --opportunistic and --analyze."""
    t0 = time.perf_counter()
    a = _mesh_train(torch, card, train_out["a"])
    log(f"[scaleout] (a) {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    b = _serve_flags(torch, card)
    log(f"[scaleout] (b) {time.perf_counter() - t0:.1f}s")
    return {"a": a, "b": b}


# -- phase 11 -------------------------------------------------------------------


ARCH_MODELS = ("gemma3-27b", "llava-next-mistral-7b", "whisper-tiny")
# gemma3-27b in float32 is 108 GB at full depth: the 6-layer group once plus
# the 2-layer tail (4.71 B parameters); bfloat16 runs all 62 layers
ARCH_DEPTH = {"gemma3-27b": {"float32": 8}}
# gemma3: one prompt of more than the 1024-token window, so the ring wraps;
# llava: the 2880-token patch prefix before every prompt
ARCH_MAX_LEN = {"gemma3-27b": 2048, "llava-next-mistral-7b": 4096,
                "whisper-tiny": MAX_LEN}
LONG_PROMPT_TOKENS = 1010
ARCH_TAG = "[archs]"
# phase 7's sub-entries of the kernels on phase 11's paths
ARCH_SUBS = ("whisper", "gemma3", "llava", "int8")


def _long_prompt(tok, n):
    """A prompt of about ``n`` tokens (at least n - 8) for the tokenizer."""
    unit = ("A log of the sensor readings, each a JSON record of its name, "
            "time and value, sorted by time and checked twice. ")
    text = unit
    while len(tok.encode(text)) < n:
        text += unit
    words = text.split(" ")
    while len(tok.encode(" ".join(words))) > n:
        words.pop()
    return " ".join(words) + ": "


def _arch_requests(torch, tok, cfg, long_prompt=None):
    """4 DOMINO JSON requests of ``MAX_TOKENS`` tokens, each with its
    seeded extra inputs on the card: a VLM's (1, P, d_model) patch prefix,
    an encoder-decoder's (1, T_enc, d_model) frames."""
    from repro_torch.serving import ConstraintSpec, DecodeParams, Request
    reqs = []
    for i in range(N_REQUESTS):
        extra = None
        gen = torch.Generator(device="cuda")
        gen.manual_seed(100 + i)
        if cfg.family == "vlm":
            extra = {"prefix": torch.randn((1, cfg.n_prefix_tokens,
                                            cfg.d_model), generator=gen,
                                           device="cuda")}
        elif cfg.is_encoder_decoder:
            extra = {"frames": torch.randn((1, cfg.encoder_seq_len,
                                            cfg.d_model), generator=gen,
                                           device="cuda")}
        prompt = (long_prompt if long_prompt is not None and i == 0
                  else PROMPTS[i % len(PROMPTS)])
        reqs.append(Request(prompt,
                            ConstraintSpec(grammar="json", mode="domino"),
                            DecodeParams(max_tokens=MAX_TOKENS, seed=i),
                            extra_inputs=extra))
    return reqs


def _cache_bytes(cache) -> int:
    return sum(v.numel() * v.element_size() for v in _leaves(
        {k: cache[k] for k in ("head", "tail", "group")}))


def _argmax_entry(torch, call, what):
    """Kernel #2 on a recorded call's logits and packed words: bitwise
    against the plain version, its time, the plain version's and its
    bound."""
    from repro_torch.kernels.masked_sample.kernel import masked_argmax_packed
    from repro_torch.kernels.masked_sample.ref import masked_argmax_ref
    (logits, bits), _ = call
    i1, v1 = masked_argmax_packed(logits, bits)
    i2, v2 = masked_argmax_ref(logits, bits)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i2) and torch.equal(v1, v2)):
        raise AssertionError(f"masked argmax differs on {what} inputs")
    b, v = logits.shape
    bnd, bnd_by = bound_ms(b * v * logits.element_size() + bits.numel() * 4
                           + b * 8, b * v, "float32")
    return {"max_abs_err": (v1 - v2).abs().max().item(),
            "shape": f"B={b} V={v} row stride {logits.stride(0)} ({what})",
            "ms": time_ms(torch, lambda: masked_argmax_packed(logits, bits)),
            "plain_ms": time_ms(torch, lambda: masked_argmax_ref(logits,
                                                                 bits)),
            "bound_ms": bnd, "bound_by": bnd_by, "library_ms": None}


def arch_kernel_entries(torch, card, paths):
    """Phase 7's sub-entries on phase 11's paths, by kernel: #1 on a
    mid-run decode call of whisper's and gemma3's bf16 runs and of gemma3's
    f32 run over the dequantized int8 cache; #2 on a mid-run tick of each
    architecture's bf16 run.  Each with that run's launches and the
    card."""
    out = {"decode_attention": {}, "masked_argmax_packed": {}}
    for sub, path, dtype in (("whisper", "whisper-tiny", "bfloat16"),
                             ("gemma3", "gemma3-27b", "bfloat16"),
                             ("int8", "gemma3-27b int8", "float32")):
        if path in paths:
            out["decode_attention"][sub] = dict(_attn_entry(
                torch, _mid_decode_call(
                    paths[path]["calls"]["decode_attention"], 1), path,
                dtype), launches=paths[path]["counts"]["decode_attention"],
                card=card)
    for sub, path in (("gemma3", "gemma3-27b"),
                      ("llava", "llava-next-mistral-7b"),
                      ("whisper", "whisper-tiny")):
        if path in paths:
            calls = paths[path]["calls"]["masked_argmax_packed"]
            out["masked_argmax_packed"][sub] = dict(
                _argmax_entry(torch, calls[len(calls) // 2], path),
                launches=paths[path]["counts"]["masked_argmax_packed"],
                card=card)
    return out


def phase_archs(torch, shared):
    """Phase 11: gemma3-27b, llava-next-mistral-7b and whisper-tiny served
    at their published widths; returns, by architecture, the bf16 run's
    launches and its recorded kernel calls (for phase 7), and the int8
    run's."""
    out = {}
    for arch in ARCH_MODELS:
        t0 = time.perf_counter()
        out.update(_arch_serve(torch, arch, shared))
        log(f"{ARCH_TAG} {arch}: {time.perf_counter() - t0:.1f}s")
    return out


def _arch_serve(torch, arch, shared):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.masked_sample import ops as mask_ops
    from repro_torch.models import build_model, kvcache
    from repro_torch.models import layers as layers_mod
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    tok, json_g = shared["tok"], shared["grammar"]
    base = get_config(arch)
    max_len = ARCH_MAX_LEN[arch]

    def cfg_for(dtype, kernels=True, **kw):
        depth = ARCH_DEPTH.get(arch, {}).get(dtype)
        cut = {} if depth is None else {"n_layers": depth}
        return dataclasses.replace(base, dtype=dtype,
                                   use_pallas_kernels=kernels, **cut, **kw)

    def engine_for(cfg, params=None, device_tables=False):
        model = build_model(cfg)
        if params is None:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            params = model.init(gen, device="cuda")
            torch.cuda.synchronize()
            n = sum(x.numel() for x in _leaves(params))
            log(f"{ARCH_TAG} {arch} {cfg.dtype} weights drawn on the card "
                f"in {time.perf_counter() - t0:.1f}s: {cfg.n_layers} layers, "
                f"{n / 1e9:.2f} B parameters, "
                f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
                f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        eng = ServingEngine(model, params, tok, max_len=max_len,
                            device_tables=device_tables, device="cuda")
        shared["trees"]["json"] = eng.register_grammar(
            "json", json_g, tree_cache=shared["trees"].get("json"))
        if device_tables:
            device_tables_for(eng, shared)
        return eng

    def counted_run(eng, reqs, cfg, what, hooks=()):
        with contextlib.ExitStack() as stack:
            for h in hooks:
                stack.enter_context(h)
            fwd = stack.enter_context(ForwardCount(eng))
            reset_counts()
            t0 = time.perf_counter()
            res = eng.generate_batch(reqs, max_batch=N_REQUESTS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        stats = dict(eng.last_batch_stats)
        if stats["paged"] or stats["n_fwd"] != fwd.prefill + fwd.n_decode:
            raise AssertionError(f"{what}: forwards {fwd.prefill} + "
                                 f"{fwd.decode}, scheduler {stats}")
        check_launches(cfg, counts, fwd, what)
        for i, r in enumerate(res):
            if r.status not in ("ok", "dead_end"):
                raise AssertionError(f"{what}: request {i} ended "
                                     f"{r.status}: {r.error}")
        return res, counts, fwd, stats, wall

    def launches_text(cfg, counts, fwd):
        return ", ".join(
            f"{k} {counts[k]}" + (f" = {per[0]} a decode forward x "
                                  f"{fwd.n_decode}" if per else
                                  f" ({counts[k] / fwd.n_decode:.2f} a tick)")
            for k, per in path_kernels(cfg).items())

    log(f"{ARCH_TAG} {describe(base)}, "
        + (f"sliding window {base.sliding_window}, " if base.sliding_window
           else "")
        + (f"{base.n_prefix_tokens}-token patch prefix, " if base.family ==
           "vlm" else "")
        + (f"{base.n_encoder_layers} encoder layers over "
           f"{base.encoder_seq_len} frames, " if base.is_encoder_decoder
           else "")
        + f"dense rows, max_len {max_len}"
        + (f"; depth cut to {ARCH_DEPTH[arch]}" if arch in ARCH_DEPTH
           else ""))
    long_prompt = None
    if arch == "gemma3-27b":
        long_prompt = _long_prompt(tok, LONG_PROMPT_TOKENS)
    requests = _arch_requests(torch, tok, base, long_prompt)
    n_pos = [len(tok.encode(r.prompt)) + (base.n_prefix_tokens
                                          if base.family == "vlm" else 0)
             for r in requests]

    # (a) float32 through the kernels against the plain path
    cfg32 = cfg_for("float32")
    eng_k = engine_for(cfg32)
    eng_p = engine_for(cfg_for("float32", False), params=eng_k.params)
    res_k, counts, fwd, stats, wall = counted_run(
        eng_k, requests, cfg32, f"{arch} f32 kernel run")
    res_p = eng_p.generate_batch(requests, max_batch=N_REQUESTS)
    n_near = same_ids(torch, eng_p, requests, res_k, res_p,
                      f"{arch} f32 kernels vs plain", tag=ARCH_TAG)
    top = max(n + r.n_tokens for n, r in zip(n_pos, res_k))
    w = base.sliding_window
    wraps = w is not None and w < max_len
    if wraps and top <= w:
        raise AssertionError(f"{arch}: no row passed the {w}-slot ring")
    log(f"{ARCH_TAG} {arch} f32: kernel path == plain path (ids, statuses) "
        f"for every request ({n_near} near-tie partings); launches "
        f"{launches_text(cfg32, counts, fwd)}; {fwd.prefill} admissions; "
        f"positions a row reached: {[n + r.n_tokens for n, r in zip(n_pos, res_k)]}"
        + (f" (the {w}-slot ring wrapped)" if wraps else "")
        + f"; tokens {[r.n_tokens for r in res_k]}; {wall:.2f}s")

    out = {}
    # (c) gemma3 with the int8 KV cache, kernels against plain
    if arch == "gemma3-27b":
        cfg8 = cfg_for("float32", kv_cache_dtype="int8")
        eng_k8 = engine_for(cfg8, params=eng_k.params)
        eng_p8 = engine_for(cfg_for("float32", False,
                                    kv_cache_dtype="int8"),
                            params=eng_k.params)
        # every 8th call: each keeps its dequantized f32 stripes alive
        rec8 = Recorder(attn_ops, "decode_attention_cuda",
                        8 * path_kernels(cfg8)["decode_attention"][0])
        res_k8, counts8, fwd8, _, wall8 = counted_run(
            eng_k8, requests, cfg8, f"{arch} f32 int8-KV kernel run",
            hooks=(rec8,))
        res_p8 = eng_p8.generate_batch(requests, max_batch=N_REQUESTS)
        n8 = same_ids(torch, eng_p8, requests, res_k8, res_p8,
                      f"{arch} f32 int8 KV kernels vs plain", tag=ARCH_TAG)
        same_native = [a.token_ids == b.token_ids
                       for a, b in zip(res_k8, res_k)]
        native = _cache_bytes(eng_k.model.init_cache(N_REQUESTS, max_len,
                                                     device="cuda"))
        quant = _cache_bytes(eng_k8.model.init_cache(N_REQUESTS, max_len,
                                                     device="cuda"))
        log(f"{ARCH_TAG} {arch} f32 int8 KV: kernel path == plain path for "
            f"every request ({n8} near-tie partings); launches "
            f"{launches_text(cfg8, counts8, fwd8)}; ids equal to the native "
            f"cache's: {same_native}; cache at B={N_REQUESTS} max_len "
            f"{max_len}: {quant / 1e6:.1f} MB int8 (values and bf16 scales) "
            f"against {native / 1e6:.1f} MB native float32 = "
            f"{quant / native:.3f}; {wall8:.2f}s")
        out["int8"] = {"counts": counts8,
                       "calls": {"decode_attention": rec8.calls}}
        del eng_k8, eng_p8, res_k8, res_p8

    # (d) whisper through the device loop against the host loop
    if arch == "whisper-tiny":
        eng_d = engine_for(cfg32, params=eng_k.params, device_tables=True)
        res_e, sched, counts_e, fwd_e, audit, wall_e = fused_run(
            torch, eng_d, requests, check_replay=True)
        st = sched.stats()
        n_tok = sum(r.n_tokens for r in res_e)
        for i, (a, b) in enumerate(zip(res_e, res_k)):
            if (a.token_ids, a.status) != (b.token_ids, b.status):
                raise AssertionError(
                    f"{arch} f32 request {i}: the device loop ({a.status}, "
                    f"{a.n_tokens} tokens) and the host loop ({b.status}, "
                    f"{b.n_tokens}) differ; trail {audit.trail}")
        line = check_fused(cfg32, sched, counts_e, fwd_e, audit,
                           f"{arch} f32 device loop")
        rate = st["n_host_syncs"] / max(n_tok, 1)
        if st["n_device_tokens"] == 0 or rate > 1 / sched.sync_n + 0.1 \
                or audit.replay_ok is not True:
            raise AssertionError(f"{arch} f32 device loop: {st}, replay "
                                 f"{audit.replay_ok}")
        log(f"{ARCH_TAG} {arch} f32 device loop (sync_n {sched.sync_n}): "
            f"ids and statuses == the host loop's; {n_tok} tokens, "
            f"{st['n_device_tokens']} committed by fused blocks, "
            f"{st['n_host_syncs']} host syncs ({rate:.3f} a token); a "
            f"replayed block == the same block run eagerly; {line}; "
            f"{wall_e:.2f}s")
        del eng_d, sched, res_e
    del eng_k, eng_p, res_k, res_p
    torch.cuda.empty_cache()

    # (b) bfloat16 through the kernels
    cfg16 = cfg_for("bfloat16")
    eng = engine_for(cfg16)
    eng.generate_batch(requests, max_batch=N_REQUESTS)        # warm-up
    torch.cuda.synchronize()
    per = path_kernels(cfg16)
    recs = {"masked_argmax_packed": Recorder(mask_ops,
                                             "masked_argmax_packed")}
    if "decode_attention" in per:
        recs["decode_attention"] = Recorder(attn_ops, "decode_attention_cuda",
                                            per["decode_attention"][0])
    phases = PhaseTimer(ContinuousBatchingScheduler)
    res, counts, fwd, stats, wall = counted_run(
        eng, requests, cfg16, f"{arch} bf16 run",
        hooks=(*recs.values(), phases))
    ticks = stats["n_decode"]
    n_tok = sum(r.n_tokens for r in res)
    log(f"{ARCH_TAG} {arch} bf16: {n_tok} tokens in {wall:.3f}s = "
        f"{n_tok / wall:.1f} tok/s; {ticks} decode ticks, {fwd.prefill} "
        f"admissions; statuses {[r.status for r in res]}; launches "
        f"{launches_text(cfg16, counts, fwd)}; a tick: "
        + ", ".join(f"{k} {counts[k] / ticks:.2f}" for k in per))
    if "decode_attention" in recs:
        (q, *_, ln), _ = _mid_decode_call(recs["decode_attention"].calls, 1)
        lengths = (ln - 1).clone()
    else:
        lengths = torch.tensor([min(n + MAX_TOKENS // 2, max_len - 1)
                                for n in n_pos], dtype=torch.int32,
                               device="cuda")
    _tick_breakdown(torch, eng, arch, res, wall, ticks, phases.seconds,
                    lengths, None, layers_mod)
    out[arch] = {"counts": counts,
                 "calls": {k: r.calls for k, r in recs.items() if r.calls}}
    del eng, res, recs
    torch.cuda.empty_cache()
    log(f"{ARCH_TAG} {arch} weights freed: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    return {(arch if k == arch else f"{arch} {k}"): v for k, v in out.items()}


def log_prefix_entry(name, e):
    log(f"[kernel] {name} prefix ({e['launches']} launches in the warm run, "
        f"{e['prefill_launches']} on cached prefills, {e['dtype']}, "
        f"{e['card']}): {e['ms']:.4f} ms (plain {e['plain_ms']:.4f} ms, "
        f"library {e['library_ms']:.4f} ms, bound {e['bound_ms']:.6f} ms by "
        f"{e['bound_by']}) at {e['shape']}")


def _finite(k) -> bool:
    nums = [k[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                               "max_abs_err")]
    for sub in ("contiguous", "long", "long_cold", "verify",
                "verify_contiguous", "prefix") + ARCH_SUBS:
        if sub in k:
            nums += [k[sub].get(key) for key in ("ms", "plain_ms", "bound_ms",
                                                 "library_ms", "max_abs_err")]
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
        shared = {"tok": tok, "grammar": json_g,
                  "gsm8k": grammars.load("json_gsm8k"), "trees": {},
                  "grammars": {"json": json_g, "c": grammars.load("c")},
                  "card": card}
        paths = {arch: timed(f"serve {arch}", phase_serve, torch, arch,
                             shared)
                 for arch in MODELS}
        paths[MASK_OP_PATH] = timed("masked_argmax op", phase_mask_op, torch,
                                    paths["deepseek-v3-671b"])
        paths.update(timed("other architectures", phase_archs, torch,
                           shared))
        kernels = timed("kernels", phase_kernels, torch, card, paths, scans,
                        attn_long, split_long, argmax_long)
        timed("faults and durability", phase_faults, torch, card, shared)
        prefix = timed("prefix cache", phase_prefix, torch, card, shared)
        train_out = timed("training", phase_training, torch, card)
        timed("scale-out and serve flags", phase_scaleout, torch, card,
              train_out)
        for k in kernels:
            if k["name"] == "decode_attention":
                k["prefix"] = prefix
            elif k["name"] == "decode_attention_split":
                k["prefix"] = paths["deepseek-v3-671b"]["prefix"]
            if "prefix" in k:
                log_prefix_entry(k["name"], k["prefix"])
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
