"""Trainer CLI of the port, the counterpart of ``repro.launch.train``.  It
right-sizes a BPE tokenizer to the grammar's text, trains the config of
``--arch`` on grammar-sampled LM rows (or, with ``--task``, the
arithmetic-JSON task rows), prints a line every 10 steps, and with
``--save DIR`` writes the params, the tokenizer and ``meta.json`` in the
JAX package's checkpoint format, which both packages' serve CLIs take with
``--checkpoint DIR``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --steps 50 --batch 8 --seq 128 --save $TMPDIR/ck
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --smoke --checkpoint $TMPDIR/ck

``--dtype`` overrides the config's dtype (the published configs train in
bfloat16, the smoke ones in float32); ``--device cpu`` runs on the CPU, by
default it runs on the card.

``--mesh DxM`` trains on a (data=D, model=M) ``DeviceMesh``: the params and
AdamW moments sharded by ``launch.sharding``'s rules (FSDP over data,
tensor parallelism over model) as DTensors, each batch split over data,
one rank a card over NCCL.  D*M > 1 cards take one process each under
``torchrun --nproc-per-node D*M``; ``--mesh 1x1`` starts its world of one
rank itself.  ``--fake-devices N`` is the counterpart of XLA's host
devices: it spawns N gloo ranks on the CPU (N = D*M, ``--device cpu``
only), so the sharded program runs without a card:

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 2 \\
      --mesh 2x2 --fake-devices 4 --device cpu

``--save`` gathers the shards to rank 0, which writes the checkpoint.
``--mesh host`` (the default) is the single-device path without a mesh.
"""
import argparse
import os
import re
import sys
import tempfile
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
    ap.add_argument("--mesh", default="host",
                    help="host | DxM (e.g. 2x4) with axes data x model")
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="spawn this many gloo ranks on the CPU for --mesh "
                         "(needs --device cpu)")
    args = ap.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    if args.mesh != "host" and not re.fullmatch(r"\d+x\d+", args.mesh):
        ap.error(f"--mesh {args.mesh!r}: host or DxM")
    if args.fake_devices:
        if args.device != "cpu":
            raise ValueError(
                "--fake-devices spawns CPU ranks: pass --device cpu (without "
                "it the trainer runs on the card, one rank a card)")
        if args.mesh == "host" or _mesh_shape(args.mesh)[0] \
                * _mesh_shape(args.mesh)[1] != args.fake_devices:
            raise ValueError(f"--fake-devices {args.fake_devices} needs a "
                             "--mesh DxM of as many ranks")
    return args


def _mesh_shape(text: str):
    d, m = (int(v) for v in text.split("x"))
    return d, m


def main(argv=None):
    """Train as the flags say; returns a dict with the per-step ``losses``
    and ``grad_norms`` and wall ``step_s`` (each step read back),
    ``tokens_per_step``, ``n_params``, the config ``cfg`` and the detached
    ``params`` (gathered whole under a mesh; a ``--fake-devices`` run
    returns its rank 0's numbers without the params)."""
    args = parse_args(argv)
    if args.fake_devices:
        return _spawn_fake_ranks(args)
    if args.mesh == "host":
        return _train(args)
    return _train_on_mesh(args)


def _train_on_mesh(args, rank=0):
    """Join (or start) the world of the mesh's ranks, train, leave it."""
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    d, m = _mesh_shape(args.mesh)
    n = d * m
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n:
            raise RuntimeError(
                f"--mesh {args.mesh} needs {n} cards; "
                f"{torch.cuda.device_count()} visible")
        if n > 1 and "WORLD_SIZE" not in os.environ:
            raise RuntimeError(f"--mesh {args.mesh} runs one rank a card: "
                               f"launch it with torchrun --nproc-per-node {n}")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():            # a spawned rank's, or torchrun's
        if dist.get_world_size() != n:
            raise RuntimeError(f"--mesh {args.mesh} needs a world of {n} "
                               f"ranks; this one has {dist.get_world_size()}")
        return _train(args, _device_mesh(dev, d, m), dev)
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n:
            raise RuntimeError(f"--mesh {args.mesh} needs a world of {n} "
                               f"ranks, not {os.environ['WORLD_SIZE']}")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
        try:
            return _train(args, _device_mesh(dev, d, m), dev)
        finally:
            dist.destroy_process_group()
    if n != 1:
        raise RuntimeError(f"--mesh {args.mesh} on the CPU needs "
                           f"--fake-devices {n} or torchrun")
    # a world of one rank over a file store (no network)
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            return _train(args, _device_mesh(dev, d, m), dev)
        finally:
            dist.destroy_process_group()


def _device_mesh(dev, d: int, m: int):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (d, m),
                            mesh_dim_names=("data", "model"))


def _fake_rank(rank, argv):
    """One spawned gloo rank of ``--fake-devices``: its result, rank 0's
    numbers without the params (every rank gathers them)."""
    out = _train_on_mesh(parse_args(argv), rank)
    out.pop("params")
    return out if rank == 0 else None


def _spawn_fake_ranks(args):
    from repro_torch.launch.mesh import join_gloo_world, start_gloo_world
    with tempfile.TemporaryDirectory(prefix="repro-fake-") as tmp:
        world = start_gloo_world(args.fake_devices, _fake_rank,
                                 (args.argv,), tmp)
        return join_gloo_world(world)[0]


def _train(args, mesh=None, dev=None):
    """The training loop, on one device or (with ``mesh``) on this rank's
    shards."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import grammars
    from repro_torch.core.sampling import GrammarSampler
    from repro_torch.device import resolve_device
    from repro_torch.launch import sharding as shr
    from repro_torch.models import act_sharding, build_model
    from repro_torch.models.convert import tree_items
    from repro_torch.tokenizer import train_bpe
    from repro_torch.training import checkpoint, optimizer as opt
    from repro_torch.training.data import GrammarLMDataset, TaskDataset
    from repro_torch.training.train_loop import (detached, full,
                                                 make_train_step, to_device)

    dev = dev or resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    # right-size vocab for the in-repo tokenizer
    corpus = GrammarSampler(grammars.load(args.grammar), seed=0).corpus(300)
    tok = train_bpe(corpus, vocab_size=max(300, args.vocab - 3))
    cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size,
                              max_seq_len=max(cfg.max_seq_len, args.seq + 1),
                              dtype=args.dtype or cfg.dtype)
    model = build_model(cfg)
    params = model.init(device=dev)
    rank = 0
    if mesh is not None:
        import torch.distributed as dist
        rank = dist.get_rank()
        shr.set_axis_sizes(mesh)
        act_sharding.register_mesh(mesh)
        act_sharding.configure(("data",), "model")
        # every rank draws the same params; rank 0's are scattered
        params = shr.shard_tree(mesh, params, shr.param_specs(cfg, params))
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
    say = print if rank == 0 else (lambda *a, **k: None)
    where = (f"a {args.mesh} mesh of {dev.type} ranks" if mesh is not None
             else dev)
    say(f"[train] {cfg.arch_id}: {n_params / 1e6:.1f}M params, vocab "
        f"{tok.vocab_size}, {cfg.dtype}, batch {args.batch} x seq "
        f"{args.seq} on {where}", flush=True)
    losses, grad_norms, step_s = [], [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        ts = time.perf_counter()
        batch = to_device(next(data), dev)
        if mesh is not None:
            batch = shr.shard_tree(mesh, batch, shr.batch_specs(
                cfg, batch, args.batch, ("data",)))
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(full(metrics["loss"])))   # the step's readback
        grad_norms.append(float(full(metrics["grad_norm"])))
        step_s.append(time.perf_counter() - ts)
        if i % 10 == 0 or i == args.steps - 1:
            say(f"step {i:4d} loss={losses[-1]:.4f} "
                f"lr={float(full(metrics['lr'])):.2e} "
                f"({time.perf_counter() - t0:.1f}s)", flush=True)
    params = detached(shr.gather_tree(params))
    if args.save and rank == 0:
        checkpoint.save(args.save, params,
                        meta={"arch": cfg.arch_id, "steps": args.steps,
                              "vocab_size": tok.vocab_size})
        tok.save(os.path.join(args.save, "tokenizer.json"))
        print(f"saved to {args.save}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if mesh is not None:
        act_sharding.register_mesh(None)
    return {"losses": losses, "grad_norms": grad_norms, "step_s": step_s,
            "cfg": cfg, "tokens_per_step": args.batch * args.seq,
            "n_params": n_params, "params": params}


if __name__ == "__main__":
    main()
