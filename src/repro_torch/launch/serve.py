"""Constrained-serving driver of the port: builds a model with random
weights, trains a small BPE tokenizer on grammar-sampled text, and serves
batched requests through the per-request constraint API on the card.

``--grammar`` takes a comma-separated list ("none" = unconstrained rows)
cycled across the prompts.  ``--smoke`` (the default) serves the reduced
config of ``--arch``; ``--no-smoke`` serves its published width:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
      --no-smoke --grammar json --mode domino --prompts 4 --kernels

``--arch falcon-mamba-7b`` (Mamba1) and ``--arch zamba2-1.2b`` (Mamba2 with
a shared attention block) serve their recurrent state on the dense layout;
``--kernels`` then also routes their scans through the hand-written
kernels.  ``--arch deepseek-v3-671b`` (MLA + MoE) pages its latent cache,
and ``--kernels`` routes its decode read through the split-score kernel;
its published config (61 layers, 704 B parameters) does not fit one card,
so on the card it serves at ``--smoke`` size here, and ``chip_smoke.py``
serves it at full width with its depth cut.  The scheduler pages the
cache only where every block is attention (GQA or MLA), and the header
line says which layout it chose.  ``--speculative --spec-s 8`` turns on
speculative decoding; each result line then says ``spec accepted/proposed``.

Failure semantics and durability: ``--deadline-s`` and ``--queue-limit``
bound a request's wall time and the waiting queue; ``--journal PATH``
journals the run (fsynced at tick boundaries), ``--restore --journal
PATH`` resumes a crashed run from it, and ``--crash-after-syncs K`` kills
the process by SIGKILL after the journal's K-th fsync.  ``--print-ids``
prints one ``IDS <rid> <token ids...>`` line a request, so a restored run
can be held bitwise to an uninterrupted one (the same holds for
``--device-loop``, whose fused blocks commit the host path's tokens):

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --prompts 4 --slots 2 --max-tokens 16 --journal $TMPDIR/j \
      --crash-after-syncs 4          # dies by SIGKILL
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --prompts 4 --slots 2 --max-tokens 16 --journal $TMPDIR/j \
      --restore --print-ids

``--device-tables`` builds a device grammar table for every grammar that
certifies clean; ``--device-loop`` (which implies it) runs certified greedy
rows through the scheduler's fused block, ``--sync-n`` decode steps a host
sync, each block one CUDA graph replay on the card.

``--checkpoint DIR`` serves a trained model instead of random weights: the
tokenizer from ``DIR/tokenizer.json`` (the config's vocabulary follows it)
and the params from ``DIR``, written by ``repro_torch.launch.train --save``
or by the JAX package's trainer; ``--arch`` and ``--smoke`` must name the
config it was trained at (``meta.json``'s ``arch``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
      --smoke --checkpoint $TMPDIR/ck --kernels

``--k`` bounds DOMINO's lookahead (-1, the default, is unbounded),
``--opportunistic`` builds a row's mask only where its unconstrained choice
is illegal (the same greedy output), and ``--analyze warn|strict`` analyzes
each grammar as it is registered, prints an ``[analysis]`` line a grammar,
and under ``strict`` refuses a grammar with traps or alignment gaps.

``--prefix-cache`` (paged KV only) serves through the scheduler's radix
prefix cache: an admission whose prompt shares whole pages with an earlier
one maps them and prefills only its tail, and a restore with the flag
clones cached checker snapshots; ``--prompts 5 --page-size 8`` repeats a
prompt and makes whole-page hits certain.
"""
import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config (--no-smoke: the "
                         "published one)")
    ap.add_argument("--grammar", default="json",
                    help="comma-separated grammar names cycled across "
                         "prompts; 'none' entries serve unconstrained rows")
    ap.add_argument("--mode", default="domino",
                    choices=["unconstrained", "domino", "naive", "online"])
    ap.add_argument("--k", type=int, default=-1,
                    help="DOMINO lookahead (-1 = infinity)")
    ap.add_argument("--opportunistic", action="store_true",
                    help="opportunistic masking: a row's mask is built "
                         "only where its unconstrained choice is illegal")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative decoding (paper section 3.6): "
                         "count-model proposals verified in one forward")
    ap.add_argument("--spec-s", type=int, default=8,
                    help="longest proposal chain a step")
    ap.add_argument("--max-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="weight seed, and per-request sampling seed base "
                         "(request i uses seed+i)")
    ap.add_argument("--prompts", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous-batching decode slots")
    ap.add_argument("--kernels", action="store_true",
                    help="route decode attention (GQA and MLA's split "
                         "score) and the SSM scans through the "
                         "hand-written CUDA kernels")
    ap.add_argument("--page-size", type=int, default=64,
                    help="paged-KV pool page length in tokens")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="paged-KV pool size in pages (default: "
                         "capacity-equivalent slots*max_len/page_size)")
    ap.add_argument("--no-paged", action="store_true",
                    help="force contiguous per-slot KV stripes")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="weights' and activations' dtype (default: the "
                         "config's); float32 makes a restored run bitwise "
                         "comparable with an uninterrupted one")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline in seconds "
                         "(queue wait included); overdue requests end "
                         "with status deadline_exceeded")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound the waiting queue: overflow submissions "
                         "end at once with status rejected")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="crash-consistent token journal (write-ahead "
                         "log), fsynced at tick boundaries; restart with "
                         "--restore to resume")
    ap.add_argument("--journal-sync-every", type=int, default=1,
                    help="fsync the journal every N ticks")
    ap.add_argument("--restore", action="store_true",
                    help="replay --journal PATH instead of submitting "
                         "fresh prompts: live requests resume from their "
                         "validated committed prefix")
    ap.add_argument("--crash-after-syncs", type=int, default=None,
                    metavar="K",
                    help="fault drill: SIGKILL this process after the "
                         "journal's K-th fsync")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the paged KV pool: "
                         "admissions sharing a token prefix map the cached "
                         "pages copy-on-write and prefill only the tail "
                         "(the same output as a cold cache); needs paged "
                         "KV")
    ap.add_argument("--device-tables", action="store_true",
                    help="build device grammar tables at precompute for "
                         "every registered grammar that certifies clean "
                         "(finite closure, no mask conflicts/truncations)")
    ap.add_argument("--device-loop", action="store_true",
                    help="run certified greedy rows through the fused "
                         "device-resident decode block: one host sync a "
                         "--sync-n tokens instead of one a token "
                         "(implies --device-tables)")
    ap.add_argument("--sync-n", type=int, default=8,
                    help="fused block length: decode steps committed on "
                         "the device between host syncs")
    ap.add_argument("--analyze", default="off",
                    choices=["off", "warn", "strict"],
                    help="registration-time grammar analysis: 'warn' "
                         "reports traps and alignment gaps, 'strict' "
                         "refuses to serve a grammar with any")
    ap.add_argument("--print-ids", action="store_true",
                    help="print one 'IDS <rid> <token ids...>' line a "
                         "result")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="serve the params and tokenizer saved in DIR "
                         "(either package's trainer, --save DIR)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.restore and not args.journal:
        ap.error("--restore requires --journal PATH")
    return args


def build_engine(args):
    """(engine, requests, labels) for parsed ``args``."""
    import dataclasses
    import json
    import os
    import pathlib

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import grammars
    from repro_torch.core.sampling import GrammarSampler
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serving import (ConstraintSpec, DecodeParams, Request,
                                     ServingEngine)
    from repro_torch.tokenizer import BPETokenizer, train_bpe
    from repro_torch.training import checkpoint

    dev = resolve_device(args.device)
    gnames = [n.strip() for n in args.grammar.split(",") if n.strip()]
    loaded = {n: grammars.load(n) for n in gnames if n != "none"}
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.checkpoint:
        meta = json.loads(
            (pathlib.Path(args.checkpoint) / "meta.json").read_text())
        if meta.get("arch", cfg.arch_id) != cfg.arch_id:
            raise ValueError(
                f"--checkpoint {args.checkpoint} holds {meta['arch']}, not "
                f"{cfg.arch_id}: pass the --arch (and --smoke or "
                "--no-smoke) it was trained at")
        tok = BPETokenizer.load(
            os.path.join(args.checkpoint, "tokenizer.json"))
        # the trained head is sized to the checkpoint's tokenizer
        cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size,
                                  max_seq_len=max(cfg.max_seq_len, 4096))
    else:
        corpus = b""
        for i, g in enumerate(loaded.values() or [grammars.load("json")]):
            corpus += GrammarSampler(g, seed=i).corpus(
                200 // max(1, len(loaded)))
        tok = train_bpe(corpus, vocab_size=400)
        if args.smoke:
            # the reduced config's head is sized to the tokenizer, as in
            # the JAX package's CLI; a published config keeps its head and the
            # engine slices the logits to the tokenizer's vocabulary
            cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size,
                                      max_seq_len=4096)
    if args.kernels:
        cfg = dataclasses.replace(cfg, use_pallas_kernels=True)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = build_model(cfg)
    if args.checkpoint:
        params, _, _ = checkpoint.load(args.checkpoint, model, dev)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        params = model.init(gen, device=dev)
    device_tables = args.device_tables or args.device_loop
    engine = ServingEngine(model, params, tok, max_len=1024,
                           analysis_policy=args.analyze,
                           device_tables=device_tables, device=dev)
    for name, g in loaded.items():
        engine.register_grammar(name, g)   # analyzed per --analyze
    engine.precompute()
    for name, rep in engine.analysis_reports.items():
        print(f"[analysis] {name}: "
              f"{'OK' if rep.ok() else 'PROBLEMS'} "
              f"({rep.closure.n_states} states, "
              f"{'finite' if rep.closure.finite else 'open'}, "
              f"{rep.analysis_time_s:.2f}s)")
    if device_tables:
        for name, tbl in engine.device_tables.items():
            print(f"[device-table] {name}: {tbl.n_states} states, "
                  f"{tbl.n_bytes / 1024:.0f} KiB uploaded")
        missing = set(loaded) - set(engine.device_tables)
        if missing:
            print(f"[device-table] not certified (host path): "
                  f"{','.join(sorted(missing))}")

    decode = DecodeParams(temperature=args.temperature,
                          max_tokens=args.max_tokens,
                          speculative=args.speculative, spec_s=args.spec_s,
                          deadline_s=args.deadline_s)
    specs = [ConstraintSpec() if name == "none"
             or args.mode == "unconstrained"
             else ConstraintSpec(grammar=name, mode=args.mode,
                                 k=None if args.k < 0 else args.k,
                                 opportunistic=args.opportunistic)
             for name in gnames]
    base_prompts = ["A person encoded as a JSON object: ", "Results: ",
                    "Config: ", "Data record: "]
    requests = [Request(base_prompts[i % len(base_prompts)],
                        specs[i % len(specs)],
                        dataclasses.replace(decode, seed=args.seed + i))
                for i in range(args.prompts)]
    labels = [gnames[i % len(gnames)] for i in range(args.prompts)]
    return engine, requests, labels


def _print_ids(results) -> None:
    for rid, r in enumerate(results):
        print(f"IDS {rid} " + " ".join(str(t) for t in r.token_ids))


def main(argv=None) -> None:
    args = parse_args(argv)
    engine, requests, labels = build_engine(args)
    journal = None
    if args.journal:
        from repro_torch.serving import TokenJournal
        journal = TokenJournal(args.journal,
                               sync_every=args.journal_sync_every,
                               crash_after_syncs=args.crash_after_syncs)
    pool = dict(paged=False if args.no_paged else None,
                page_size=args.page_size, n_pages=args.pool_pages,
                device_loop=args.device_loop, sync_n=args.sync_n,
                prefix_cache=args.prefix_cache)
    if args.restore:
        # the same seeded engine as the crashed run, so re-prefill
        # regenerates its logits, and its slot count, so the batch shapes
        # are the crashed run's; the reopened journal keeps the resumed
        # run durable
        sched = engine.restore(args.journal, journal=journal,
                               capacity=min(args.slots, args.prompts),
                               **pool)
        n_live = len(sched.waiting)
        results = sched.run()
        print(f"[restore] {args.journal}: {len(results)} journaled "
              f"request(s), {n_live} resumed live; stats={sched.stats()}")
        for r in results:
            print(f"--- out[status={r.status}, {r.n_tokens} toks, "
                  f"{r.n_replayed_tokens} replayed]: {r.text[:120]!r}"
                  + (f" error={r.error}" if r.error else ""))
        if args.print_ids:
            _print_ids(results)
        return
    if len(requests) > 1 or journal is not None:
        results = engine.generate_batch(
            requests, max_batch=args.slots, queue_limit=args.queue_limit,
            journal=journal, **pool)
        layout = ("paged KV" if engine.last_batch_stats["paged"]
                  else "contiguous KV")
        print(f"[continuous batching: {len(requests)} requests, "
              f"{min(len(requests), args.slots)} slots, {layout}]")
        if args.prefix_cache:
            st = engine.last_batch_stats
            print(f"[prefix cache: {st['n_prefix_hits']} hits, "
                  f"{st['n_prefix_tokens']} prefill tokens skipped]")
    else:
        results = [engine.generate(r) for r in requests]
    for lbl, req, r in zip(labels, requests, results):
        print(f"--- prompt[{lbl}]: {req.prompt!r}")
        print(f"    out[status={r.status}, {r.n_tokens} toks, "
              f"{r.n_forward_passes} fwd, "
              f"{r.n_interventions} interventions, "
              f"spec {r.n_spec_accepted}/{r.n_spec_proposed}"
              + (f", {r.n_device_tokens} device-committed"
                 if args.device_loop else "")
              + f"]: {r.text[:120]!r}"
              + (f" error={r.error}" if r.error else ""))
    if args.print_ids:
        _print_ids(results)


if __name__ == "__main__":
    main()
