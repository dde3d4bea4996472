#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero without the
final result line):

 1. environment and kernel build: the card's name and power limit, torch
    and CUDA versions, the nvcc build of every kernel from ``csrc/``;
 2. packed masked argmax, kernel vs plain version on the card (bitwise);
 3. decode attention, kernel vs plain version on the card: paged
    (shuffled tables, -1 vacancies, foreign pages poisoned with NaN) and
    contiguous, S in {1, 3}, float32 (atol 1e-5: only the summation order
    differs) and bfloat16 (atol = rtol = 2e-2 in float32: about one bf16
    ulp of the output);
 4. serving stablelm-1.6b at its published width with random weights
    through ``ServingEngine.generate_batch`` over a paged KV pool, DOMINO
    JSON grammar, 4 requests in 4 slots: (a) float32 through the kernels
    against the same requests through the plain path (greedy ids and
    statuses equal), (b) bfloat16 through the kernels (tokens/s, decode
    ticks, launch counts);
 5. each kernel's launches on the main path, its parity, and its time
    beside its plain version, its bound and a library yardstick, on the
    inputs the main path gave it.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
ARCH = "stablelm-1.6b"
N_REQUESTS = 4
MAX_TOKENS = 32
PAGE_SIZE = 64
PROMPTS = ["A person encoded as a JSON object: ", "Results: ", "Config: ",
           "Data record: "]


def log(msg: str) -> None:
    print(msg, flush=True)


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
        if "registers" in line or line.startswith("=="):
            log(f"[build] {line.strip()}")
    return card


# -- phase 2 --------------------------------------------------------------------


def _mask_case(torch, gen, b, v, stride):
    """Strided logits (row stride > v, as the scheduler's padded view)
    and packed int32 words with an all-zero row, a one-legal row and
    rows with deliberate ties."""
    dev = "cuda"
    full = torch.randn((b, stride), generator=gen, device=dev)
    logits = full[:, :v]
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


def phase_masked_argmax(torch):
    from repro_torch.kernels.masked_sample.kernel import masked_argmax_packed
    from repro_torch.kernels.masked_sample.ref import masked_argmax_ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for b in (1, 4, 64):
        for v in (400, 100352, 1001):
            logits, bits = _mask_case(torch, gen, b, v, v + 96)
            i1, v1 = masked_argmax_packed(logits, bits)
            i2, v2 = masked_argmax_ref(logits, bits)
            torch.cuda.synchronize()
            if not (torch.equal(i1, i2) and torch.equal(v1, v2)):
                bad = (i1 != i2).nonzero().flatten()[:4].tolist()
                raise AssertionError(f"masked argmax B={b} V={v}: kernel "
                                     f"differs from plain at rows {bad}")
            log(f"[argmax] B={b} V={v}: bitwise equal")
    logits, bits = _mask_case(torch, gen, 4, 100352, 100352)
    k_ms = time_ms(torch, lambda: masked_argmax_packed(logits, bits))
    p_ms = time_ms(torch, lambda: masked_argmax_ref(logits, bits))
    bnd, _ = bound_ms(4 * 100352 * 4 + bits.numel() * 4 + 4 * 8,
                      4 * 100352, "float32")
    log(f"[argmax] B=4 V=100352: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"bound {bnd:.5f} ms")


# -- phase 3 --------------------------------------------------------------------


def _paged_case(torch, gen, dtype, s_win, qh, lens, poison):
    b, g, d, ps, mp = len(lens), 32, 64, PAGE_SIZE, 20
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
        for s_win, qh in ((1, 1), (3, 1), (3, 2)):
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
    gen.manual_seed(4)
    q, kp, vp, ln, tbl = _paged_case(torch, gen, torch.bfloat16, 1, 1,
                                     [1000] * 4, False)
    k_ms = time_ms(torch, lambda: decode_attention_cuda(
        q, kp, vp, ln, block_tables=tbl))
    p_ms = time_ms(torch, lambda: decode_attention_ref(
        q, kp, vp, ln, block_tables=tbl))
    lib_ms = time_ms(torch, _sdpa_yardstick(torch, q, kp, vp, ln, tbl))
    log(f"[attn] bf16 B=4 G=32 D=64 1000 keys/row: kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
        f"{_attn_bound(q, kp, ln, tbl, 'bfloat16')[0]:.5f} ms")


def _sdpa_yardstick(torch, q, kp, vp, ln, tbl):
    """One fused library attention call over the same rows as the kernel,
    pages gathered beforehand (the gather is not timed).  A yardstick
    only: the port never calls it."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ref import gather_pages
    bq, s_win, g, qh, d = q.shape
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
    cap = tbl.shape[1] * kp.shape[1]
    keys = sum(max(0, min(int(x) + s_win - 1, cap)) for x in ln.tolist())
    esize = q.element_size()
    n_bytes = (keys * g * 2 * d * esize + 2 * q.numel() * esize
               + ln.numel() * 4 + tbl.numel() * 4)
    n_ops = keys * g * qh * s_win * 4 * d
    return bound_ms(n_bytes, n_ops, dtype)


# -- phase 4 --------------------------------------------------------------------


class Recorder:
    """Keeps the inputs of the main path's kernel calls (for timing and
    parity on exactly those inputs) while the call goes through the real
    wrapper, which does its own launch counting."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def wrapped(*args, **kw):
            self.calls.append((args, kw))
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


def phase_serve(torch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import grammars
    from repro_torch.core.domino import DominoDecoder
    from repro_torch.core.sampling import GrammarSampler
    from repro_torch.kernels.decode_attention import kernel as attn_kernel
    from repro_torch.kernels.decode_attention import ops as attn_ops
    from repro_torch.kernels.masked_sample import kernel as mask_kernel
    from repro_torch.kernels.masked_sample import ops as mask_ops
    from repro_torch.models import build_model
    from repro_torch.serving import (ConstraintSpec, DecodeParams, Request,
                                     ServingEngine)
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    from repro_torch.tokenizer import train_bpe

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    json_g = grammars.load("json")
    tok = train_bpe(GrammarSampler(json_g, seed=0).corpus(200),
                    vocab_size=400)
    log(f"[serve] tokenizer: {tok.vocab_size} tokens, trained in "
        f"{time.perf_counter() - t0:.1f}s")
    base = get_config(ARCH)
    log(f"[serve] {ARCH}: {base.n_layers} layers, d_model {base.d_model}, "
        f"{base.n_heads} heads ({base.n_kv_heads} kv), d_head "
        f"{base.d_head}, d_ff {base.d_ff}, vocab {base.vocab_size} "
        f"(logits sliced to the tokenizer's {tok.vocab_size})")
    requests = [Request(PROMPTS[i % len(PROMPTS)],
                        ConstraintSpec(grammar="json", mode="domino"),
                        DecodeParams(max_tokens=MAX_TOKENS, seed=i))
                for i in range(N_REQUESTS)]
    tree_cache = None

    def engine_for(dtype, kernels, params=None):
        nonlocal tree_cache
        cfg = dataclasses.replace(base, dtype=dtype,
                                  use_pallas_kernels=kernels)
        model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            params = model.init(gen, device="cuda")
        eng = ServingEngine(model, params, tok, max_len=1024, device="cuda")
        tree_cache = eng.register_grammar("json", json_g,
                                          tree_cache=tree_cache)
        return eng

    def reset():
        attn_kernel.decode_attention_cuda.launches = 0
        mask_kernel.masked_argmax_packed.launches = 0

    def counts():
        return (attn_kernel.decode_attention_cuda.launches,
                mask_kernel.masked_argmax_packed.launches)

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
    eng_k = engine_for("float32", True)
    t0 = time.perf_counter()
    eng_k.precompute()
    log(f"[serve] grammar trees precomputed in "
        f"{time.perf_counter() - t0:.1f}s")
    eng_p = engine_for("float32", False, params=eng_k.params)
    reset()
    res_k = serve(eng_k)
    torch.cuda.synchronize()
    n_attn, n_mask = counts()
    ticks = eng_k.last_batch_stats["n_decode"]
    res_p = serve(eng_p)
    check_valid(res_k, "f32 kernel run")
    check_valid(res_p, "f32 plain run")
    log(f"[serve] f32 kernel run: launches decode_attention {n_attn}, "
        f"masked_argmax {n_mask}; {ticks} decode ticks")
    if n_attn == 0 or n_mask == 0 or n_attn != base.n_layers * ticks:
        raise AssertionError("f32 kernel run: launch counts off")
    for i, (a, b) in enumerate(zip(res_k, res_p)):
        log(f"[serve] f32 request {i}: status {a.status}, {a.n_tokens} "
            f"tokens, {a.n_interventions} interventions: {a.text[:60]!r}")
        if a.token_ids != b.token_ids or a.status != b.status:
            k = next((j for j, (x, y) in enumerate(zip(a.token_ids,
                                                       b.token_ids))
                      if x != y), min(len(a.token_ids), len(b.token_ids)))
            ids = eng_p.tok.encode(requests[i].prompt) + b.token_ids[:k]
            cache = eng_p.model.init_cache(1, 1024, device="cuda")
            lg, _ = eng_p.model.prefill(
                eng_p.params, {"tokens": torch.tensor([ids], device="cuda")},
                cache)
            top = torch.topk(lg[0, -1, :tok.vocab_size].float(), 2).values
            raise AssertionError(
                f"f32 request {i}: kernel and plain paths diverge at step "
                f"{k} (top-2 logit margin there "
                f"{(top[0] - top[1]).item():.3e})")
    log("[serve] f32: kernel path == plain path for every request")
    # the single-request path takes the kernel's contiguous mode; its
    # prefill and batch shapes differ from the scheduler's, so equal ids
    # are expected but not required bit for bit
    single = eng_k.generate(requests[0])
    log(f"[serve] f32 generate (contiguous kernel mode), request 0: "
        f"{single.status}, ids "
        f"{'equal to' if single.token_ids == res_k[0].token_ids else 'DIFFERENT from'}"
        f" generate_batch")
    del eng_k, eng_p, res_p
    torch.cuda.empty_cache()

    # (b) bfloat16, the published dtype, through the kernels
    eng = engine_for("bfloat16", True)
    serve(eng)                                    # warm-up
    torch.cuda.synchronize()
    rec_attn = Recorder(attn_ops, "decode_attention_cuda")
    rec_mask = Recorder(mask_ops, "masked_argmax_packed")
    phases = PhaseTimer(ContinuousBatchingScheduler)
    reset()
    with rec_attn, rec_mask, phases:
        t0 = time.perf_counter()
        res = serve(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_attn, n_mask = counts()
    ticks = eng.last_batch_stats["n_decode"]
    check_valid(res, "bf16 run")
    n_tok = sum(r.n_tokens for r in res)
    log(f"[serve] bf16: {n_tok} tokens in {wall:.3f}s = "
        f"{n_tok / wall:.1f} tok/s; {ticks} decode ticks; launches "
        f"decode_attention {n_attn}, masked_argmax {n_mask}; statuses "
        f"{[r.status for r in res]}")
    if n_attn == 0 or n_mask == 0 or n_attn != base.n_layers * ticks:
        raise AssertionError("bf16 run: launch counts off")
    _tick_breakdown(torch, eng, rec_attn.calls, res, wall, ticks,
                    phases.seconds)
    return {"decode_attention": (n_attn, rec_attn.calls),
            "masked_argmax_packed": (n_mask, rec_mask.calls)}


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


def _tick_breakdown(torch, eng, attn_calls, results, wall, ticks, phases):
    """Where a bf16 decode tick's time goes: the scheduler's phases on the
    host clock, and the decode forward alone at the main path's mid-run
    state (its block table and lengths), through the kernels and through
    the plain path, on the host clock and on the card."""
    import dataclasses

    from repro_torch.models import build_model
    per_tick = {k.strip("_"): v / ticks * 1e3 for k, v in phases.items()}
    tick_ms = wall / ticks * 1e3
    log(f"[serve] bf16 tick, host ms per decode tick: wall {tick_ms:.2f} = "
        + " + ".join(f"{k} {v:.2f}" for k, v in per_tick.items())
        + f" + other {tick_ms - sum(per_tick.values()):.2f}")
    mask_crit = sum(r.mask_time_s - r.mask_overlap_s for r in results)
    mask_hid = sum(r.mask_overlap_s for r in results)
    st = eng.last_batch_stats
    log(f"[serve] bf16 host mask builds per tick: "
        f"{mask_crit / ticks * 1e3:.3f} ms on the critical path, "
        f"{mask_hid / ticks * 1e3:.3f} ms hidden under the forward; "
        f"mask_cache_hits {st['mask_cache_hits']}, premask_hits "
        f"{st['premask_hits']}")

    (q, _, _, ln), kw = attn_calls[len(attn_calls) // 2]
    b = q.shape[0]
    cache = eng.model.init_cache(b, eng.max_len, page_size=PAGE_SIZE,
                                 device="cuda")
    cache["len"] = (ln - 1).clone()        # the wrapper got cache_len + 1
    cache["pages"] = kw["block_tables"].clone()
    feed = torch.zeros((b, 1), dtype=torch.int64, device="cuda")
    plain = build_model(dataclasses.replace(eng.model.cfg,
                                            use_pallas_kernels=False))

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]
    # a B-row forward reads every weight once (the embedding only B rows)
    w_bytes = sum(x.numel() * x.element_size() for x in leaves(eng.params))
    emb = eng.params["embed"]
    w_bytes -= emb[b:].numel() * emb.element_size()
    bnd, _ = bound_ms(w_bytes, 0, "bfloat16")
    for name, model in (("kernels", eng.model), ("plain", plain)):
        f_wall, f_dev, top = _forward_ms(torch, model, eng.params, cache,
                                         feed)
        dev = "not measured" if f_dev is None else f"{f_dev:.3f} ms"
        log(f"[serve] bf16 decode forward ({name}) at B={b} lengths "
            f"{ln.tolist()}: host wall {f_wall:.2f} ms, device {dev} "
            f"(profiler), weight-read bound {bnd:.3f} ms")
        if top:
            log(f"[serve]   top kernels ({name}), ms per forward: "
                + "; ".join(f"{k[:60]} {t:.3f}" for k, t in top))


# -- phase 5 --------------------------------------------------------------------


def phase_kernels(torch, main_path):
    """Each kernel on the inputs of a mid-run call of the main path."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.masked_sample.kernel import masked_argmax_packed
    from repro_torch.kernels.masked_sample.ref import masked_argmax_ref
    out = []

    n, calls = main_path["masked_argmax_packed"]
    # a mid-run tick's logits view (row stride = padded vocab) and words;
    # the scheduler replaces both tensors every tick, so they still hold
    # that tick's values
    (logits, bits), _ = calls[len(calls) // 2]
    i1, v1 = masked_argmax_packed(logits, bits)
    i2, v2 = masked_argmax_ref(logits, bits)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i2) and torch.equal(v1, v2)):
        raise AssertionError("masked argmax differs on main-path inputs")
    b, v = logits.shape
    bnd, by = bound_ms(b * v * 4 + bits.numel() * 4 + b * 8, b * v,
                       "float32")
    out.append({
        "name": "masked_argmax_packed", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_argmax.cu",
        "replaces": "src/repro/kernels/masked_sample/kernel.py:156",
        "launches": n, "parity": "bitwise",
        "max_abs_err": (v1 - v2).abs().max().item(),
        "shape": f"B={b} V={v} row stride {logits.stride(0)}",
        "ms": time_ms(torch, lambda: masked_argmax_packed(logits, bits)),
        "plain_ms": time_ms(torch, lambda: masked_argmax_ref(logits, bits)),
        "bound_ms": bnd, "bound_by": by, "library_ms": None})

    n, calls = main_path["decode_attention"]
    (q, kp, vp, ln), kw = calls[len(calls) // 2]
    tbl = kw.get("block_tables")
    got = decode_attention_cuda(q, kp, vp, ln, block_tables=tbl)
    want = decode_attention_ref(q, kp, vp, ln, block_tables=tbl)
    torch.cuda.synchronize()
    err = _check_attn(torch, got, want, q.dtype, "main-path inputs")
    bnd, by = _attn_bound(q, kp, ln, tbl, "bfloat16")
    lib_ms = time_ms(torch, _sdpa_yardstick(torch, q, kp, vp, ln, tbl))
    out.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:121",
        "launches": n, "parity": "atol/rtol 2e-2 (bf16)",
        "max_abs_err": err,
        "shape": (f"q {tuple(q.shape)} pool {tuple(kp.shape)} lengths "
                  f"{ln.tolist()}"),
        "ms": time_ms(torch, lambda: decode_attention_cuda(
            q, kp, vp, ln, block_tables=tbl)),
        "plain_ms": time_ms(torch, lambda: decode_attention_ref(
            q, kp, vp, ln, block_tables=tbl)),
        "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms})
    for k in out:
        log(f"[kernel] {k['name']}: {k['launches']} launches, "
            f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, bound "
            f"{k['bound_ms']:.6f} ms by {k['bound_by']}) at {k['shape']}")
    return out


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
    t_start = time.perf_counter()
    try:
        card = phase_env(torch)
        phase_masked_argmax(torch)
        phase_decode_attention(torch)
        main_path = phase_serve(torch)
        kernels = phase_kernels(torch, main_path)
    except Exception as e:  # every phase's failure fails the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f}s on {card}")
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                    "max_abs_err"):
            if k[key] is not None and not math.isfinite(k[key]):
                print(f"chip_smoke: {k['name']} {key} is not finite",
                      file=sys.stderr)
                return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
