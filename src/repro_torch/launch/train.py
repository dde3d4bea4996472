"""Single-device trainer CLI of the port, the counterpart of
``repro.launch.train`` on one card (its ``--mesh`` and ``--fake-devices``
wait for the port's scale-out).  It right-sizes a BPE tokenizer to the
grammar's text, trains the config of ``--arch`` on grammar-sampled LM rows
(or, with ``--task``, the arithmetic-JSON task rows), prints a line every
10 steps, and with ``--save DIR`` writes the params, the tokenizer and
``meta.json`` in the JAX package's checkpoint format, which both packages'
serve CLIs take with ``--checkpoint DIR``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --steps 50 --batch 8 --seq 128 --save $TMPDIR/ck
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --smoke --checkpoint $TMPDIR/ck

``--dtype`` overrides the config's dtype (the published configs train in
bfloat16, the smoke ones in float32); ``--device cpu`` runs on the CPU, by
default it runs on the card.
"""
import argparse
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="wsd",
                    choices=["constant", "cosine", "wsd"])
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--grammar", default="json")
    ap.add_argument("--task", action="store_true",
                    help="arithmetic-JSON task data instead of grammar LM")
    ap.add_argument("--save", default=None, help="checkpoint dir")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="params' and activations' dtype (default: the "
                         "config's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Train as the flags say; returns a dict with the per-step ``losses``
    and wall ``step_s`` (each step read back), ``tokens_per_step``,
    ``n_params``, the config ``cfg`` and the detached ``params``."""
    args = parse_args(argv)
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import grammars
    from repro_torch.core.sampling import GrammarSampler
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.models.convert import tree_items
    from repro_torch.tokenizer import train_bpe
    from repro_torch.training import checkpoint, optimizer as opt
    from repro_torch.training.data import GrammarLMDataset, TaskDataset
    from repro_torch.training.train_loop import (detached, make_train_step,
                                                 to_device)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    # right-size vocab for the in-repo tokenizer
    corpus = GrammarSampler(grammars.load(args.grammar), seed=0).corpus(300)
    tok = train_bpe(corpus, vocab_size=max(300, args.vocab - 3))
    cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size,
                              max_seq_len=max(cfg.max_seq_len, args.seq + 1),
                              dtype=args.dtype or cfg.dtype)
    model = build_model(cfg)
    params = model.init(device=dev)
    ocfg = opt.AdamWConfig(lr=args.lr, schedule=args.schedule,
                           total_steps=args.steps,
                           warmup_steps=max(1, args.steps // 10))
    state = opt.init_state(params)
    step_fn = make_train_step(model, ocfg)
    if args.task:
        data = TaskDataset(tok, seq_len=args.seq).batches(args.batch)
    else:
        data = GrammarLMDataset(tok, args.grammar,
                                seq_len=args.seq).batches(args.batch)
    n_params = sum(p.numel() for _, p in tree_items(params))
    print(f"[train] {cfg.arch_id}: {n_params / 1e6:.1f}M params, vocab "
          f"{tok.vocab_size}, {cfg.dtype}, batch {args.batch} x seq "
          f"{args.seq} on {dev}", flush=True)
    losses, step_s = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        ts = time.perf_counter()
        batch = to_device(next(data), dev)
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))     # the step's readback
        step_s.append(time.perf_counter() - ts)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    params = detached(params)
    if args.save:
        checkpoint.save(args.save, params,
                        meta={"arch": cfg.arch_id, "steps": args.steps,
                              "vocab_size": tok.vocab_size})
        tok.save(os.path.join(args.save, "tokenizer.json"))
        print(f"saved to {args.save}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"losses": losses, "step_s": step_s, "cfg": cfg,
            "tokens_per_step": args.batch * args.seq, "n_params": n_params,
            "params": params}


if __name__ == "__main__":
    main()
