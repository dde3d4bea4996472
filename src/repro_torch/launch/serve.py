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
line says which layout it chose.
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
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def build_engine(args):
    """(engine, requests, labels) for parsed ``args``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import grammars
    from repro_torch.core.sampling import GrammarSampler
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serving import (ConstraintSpec, DecodeParams, Request,
                                     ServingEngine)
    from repro_torch.tokenizer import train_bpe

    dev = resolve_device(args.device)
    gnames = [n.strip() for n in args.grammar.split(",") if n.strip()]
    loaded = {n: grammars.load(n) for n in gnames if n != "none"}
    corpus = b""
    for i, g in enumerate(loaded.values() or [grammars.load("json")]):
        corpus += GrammarSampler(g, seed=i).corpus(200 // max(1, len(loaded)))
    tok = train_bpe(corpus, vocab_size=400)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        # the reduced config's head is sized to the tokenizer, as in the
        # JAX driver; a published config keeps its head and the engine
        # slices the logits to the tokenizer's vocabulary
        cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size,
                                  max_seq_len=4096)
    if args.kernels:
        cfg = dataclasses.replace(cfg, use_pallas_kernels=True)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = model.init(gen, device=dev)
    engine = ServingEngine(model, params, tok, max_len=1024, device=dev)
    for name, g in loaded.items():
        engine.register_grammar(name, g)
    engine.precompute()

    decode = DecodeParams(temperature=args.temperature,
                          max_tokens=args.max_tokens)
    specs = [ConstraintSpec() if name == "none"
             or args.mode == "unconstrained"
             else ConstraintSpec(grammar=name, mode=args.mode)
             for name in gnames]
    base_prompts = ["A person encoded as a JSON object: ", "Results: ",
                    "Config: ", "Data record: "]
    requests = [Request(base_prompts[i % len(base_prompts)],
                        specs[i % len(specs)],
                        dataclasses.replace(decode, seed=args.seed + i))
                for i in range(args.prompts)]
    labels = [gnames[i % len(gnames)] for i in range(args.prompts)]
    return engine, requests, labels


def main(argv=None) -> None:
    args = parse_args(argv)
    engine, requests, labels = build_engine(args)
    if len(requests) > 1:
        results = engine.generate_batch(
            requests, max_batch=args.slots,
            paged=False if args.no_paged else None,
            page_size=args.page_size, n_pages=args.pool_pages)
        layout = ("paged KV" if engine.last_batch_stats["paged"]
                  else "contiguous KV")
        print(f"[continuous batching: {len(requests)} requests, "
              f"{min(len(requests), args.slots)} slots, {layout}]")
    else:
        results = [engine.generate(r) for r in requests]
    for lbl, req, r in zip(labels, requests, results):
        print(f"--- prompt[{lbl}]: {req.prompt!r}")
        print(f"    out[status={r.status}, {r.n_tokens} toks, "
              f"{r.n_forward_passes} fwd, "
              f"{r.n_interventions} interventions]: {r.text[:120]!r}"
              + (f" error={r.error}" if r.error else ""))


if __name__ == "__main__":
    main()
