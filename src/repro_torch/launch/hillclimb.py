"""Hillclimb tool of the port, the counterpart of
``repro.launch.hillclimb``: measure one (arch, shape, variant) with the
dry run -- per-rank memory, the collective bytes of an eager step (every
layer's, so no trip-count fit) -- and the H100 roofline terms.  A CPU tool
like the dry run: no card is touched.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb gemma3-27b \\
      decode_32k --no-serve-fsdp --shard-logits --tag nofsdp_shardlogits

Results go to artifacts/hillclimb_torch/<arch>_<shape>_<tag>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import ART, TRAIN_MICROBATCHES, run_one
from repro_torch.launch.roofline import roofline


def measure(arch: str, shape_name: str, tag: str = "base",
            microbatches: int = 0, serve_fsdp: bool = True,
            shard_logits: bool = False, kv_int8: bool = False,
            capacity_factor: float = 0.0, opt_bf16: bool = False,
            save: bool = True):
    from repro_torch.training import optimizer as opt
    cfg = get_config(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if capacity_factor > 0 and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe,
                                         capacity_factor=capacity_factor))
    ocfg = opt.AdamWConfig(state_dtype="bfloat16") if opt_bf16 else None
    mb = microbatches or (TRAIN_MICROBATCHES.get(arch, 1)
                          if shape_name == "train_4k" else 1)
    rec = run_one(arch, shape_name, save=save, microbatches=mb,
                  cfg_override=cfg, serve_fsdp=serve_fsdp,
                  shard_logits_out=shard_logits, opt_cfg=ocfg,
                  variant=(tag if tag != "base" else ""))
    per_op = {k: v["bytes"] for k, v in rec["collectives"].items()}
    total = float(sum(per_op.values()))
    rf = roofline(arch, shape_name, "16x16", rec, coll_bytes=total,
                  cfg=cfg, replicated_weights=not serve_fsdp)
    mem = rec["memory"]
    result = {
        "tag": tag, "arch": arch, "shape": shape_name,
        "compute_ms": rf["compute_s"] * 1e3,
        "memory_ms": rf["memory_s"] * 1e3,
        "collective_ms": rf["collective_s"] * 1e3,
        "dominant": rf["dominant"],
        "useful_flops_ratio": rf["useful_flops_ratio"],
        "temp_gib": mem["temp_bytes"] / 2 ** 30,
        "arg_gib": mem["argument_bytes"] / 2 ** 30,
        "collective_bytes_per_dev": total,
        "by_op_mib": {k: v / 2 ** 20 for k, v in per_op.items() if v},
    }
    if save:
        out = ART.parent / "hillclimb_torch"
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{arch}_{shape_name}_{tag}.json").write_text(
            json.dumps(result, indent=1))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--tag", default="base")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--no-serve-fsdp", action="store_true")
    ap.add_argument("--shard-logits", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--capacity", type=float, default=0.0)
    ap.add_argument("--opt-bf16", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    r = measure(args.arch, args.shape, tag=args.tag,
                microbatches=args.microbatches,
                serve_fsdp=not args.no_serve_fsdp,
                shard_logits=args.shard_logits, kv_int8=args.kv_int8,
                capacity_factor=args.capacity, opt_bf16=args.opt_bf16)
    print(json.dumps(r, indent=1))
    print(f"({time.perf_counter() - t0:.0f}s)")


if __name__ == "__main__":
    main()
