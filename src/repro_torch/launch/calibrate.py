"""Collective trip-count check of the port, the counterpart of
``repro.launch.calibrate``.

The JAX package compiles its scan over layers, and XLA:CPU's HLO text holds
the loop body once, so it fits its collective bytes at the real depth from
two compiles (the group repeated once and twice): per op type

    bytes(R) = base + R * per_layer.

The port's dry run runs an eager step, which issues every layer's
collectives, so its count at the real depth is direct; here the same
two-point fit is a check of that count: ``base + R * per_layer``, from
steps at R = 1 and R = 2, must equal the direct count at the real R, op
by op, in counts and bytes.  For the encoder-decoder arch the encoder
depth scales with R too (its real depth equals the decoder's).

Adds {"collectives_corrected": ..., "collective_bytes_corrected": N,
"fit_matches_direct": bool} to the dry-run record JSON.

  PYTHONPATH=src python -m repro_torch.launch.calibrate --arch yi-34b \\
      --shape decode_32k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict

from repro_torch.configs import ALIASES, get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch.dryrun import (ART, TRAIN_MICROBATCHES, applicable,
                                       mesh_name, run_one)


def with_reps(cfg, r: int):
    head, reps, group, tail = cfg.layer_program
    real = [b for b in list(head) + list(group) * r + list(tail)
            if b != "shared_attn"]
    kw = dict(group_reps=r, n_layers=len(real))
    if cfg.is_encoder_decoder:
        kw["n_encoder_layers"] = r
    return dataclasses.replace(cfg, **kw)


def collect(cfg, shape_name: str, microbatches: int, multi_pod: bool = False,
            mesh_shape=None, **variant) -> Dict[str, Dict[str, float]]:
    """Collectives of one dry-run step of ``cfg``: {op: {count, bytes}}."""
    return run_one(cfg.arch_id, shape_name, multi_pod=multi_pod, save=False,
                   microbatches=microbatches, cfg_override=cfg,
                   mesh_shape=mesh_shape, **variant)["collectives"]


def fit(c1, c2, reps: int) -> Dict[str, Dict[str, float]]:
    """The two-point fit of each op's count and bytes at ``reps``."""
    out = {}
    for op in c1:
        row = {}
        for key in ("count", "bytes"):
            per_layer = max(0.0, c2[op][key] - c1[op][key])
            base = max(0.0, c1[op][key] - per_layer)
            row[key] = base + per_layer * reps
            row[f"per_layer_{key}"] = per_layer
        out[op] = row
    return out


def calibrate(arch: str, shape_name: str, multi_pod: bool = False,
              cfg=None, mesh_shape=None, save: bool = True) -> dict:
    """Fit at R = 1, 2 and the direct count at the real R; ``{}`` where the
    shape does not apply."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, _ = applicable(cfg, shape)
    if not ok:
        return {}
    mb = TRAIN_MICROBATCHES.get(cfg.arch_id, 1) \
        if shape_name == "train_4k" else 1
    _, reps, _, _ = cfg.layer_program
    c1, c2 = (collect(with_reps(cfg, r), shape_name, mb, multi_pod,
                      mesh_shape) for r in (1, 2))
    direct = collect(cfg, shape_name, mb, multi_pod, mesh_shape)
    fitted = fit(c1, c2, reps)
    matches = all(fitted[op][k] == direct[op][k]
                  for op in direct for k in ("count", "bytes"))
    total = sum(v["bytes"] for v in fitted.values())
    rec_path = ART / (f"{cfg.arch_id}_{shape_name}_"
                      f"{mesh_name(multi_pod, mesh_shape)}.json")
    if save and rec_path.exists():
        rec = json.loads(rec_path.read_text())
        rec["collectives_corrected"] = fitted
        rec["collective_bytes_corrected"] = total
        rec["fit_matches_direct"] = matches
        rec_path.write_text(json.dumps(rec, indent=1))
    return {"total_bytes": total, "ops": fitted, "direct": direct,
            "fit_matches_direct": matches}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ALIASES)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    print("[cal] a CPU tool: three dry-run steps an (arch, shape) on the "
          "fake process group; no card is touched", flush=True)
    n_fail = 0
    for a in archs:
        for s in shapes:
            t0 = time.perf_counter()
            try:
                out = calibrate(a, s, args.multi_pod)
                if out:
                    print(f"[cal] {a} x {s}: "
                          f"{out['total_bytes'] / 2**20:.1f} MiB/device, fit "
                          f"{'equals' if out['fit_matches_direct'] else 'DIFFERS FROM'}"
                          f" the direct count "
                          f"({time.perf_counter() - t0:.0f}s)", flush=True)
                    n_fail += not out["fit_matches_direct"]
            except Exception as e:  # noqa: BLE001 -- report, go on
                n_fail += 1
                print(f"[cal-FAIL] {a} x {s}: {type(e).__name__}: "
                      f"{str(e)[:160]}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} calibrations failed or differ")


if __name__ == "__main__":
    main()
