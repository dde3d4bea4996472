"""Roofline analysis of the port, on the H100 (``repro.launch.roofline``'s).

Three terms per (arch x shape x mesh), in seconds per step:

  compute    = FLOPs / (chips * 989e12)            [bf16 tensor cores, H100]
  memory     = HBM bytes / (chips * 3.35e12)
  collective = per-device collective bytes / 450e9 [NVLink, each way]

The constants are the NVIDIA H100 SXM data sheet's (``launch.mesh``), not
measurements.  The FLOPs and HBM bytes below are the JAX package's
analytic model, copied line for line, so the two packages' rooflines
differ only by the two chips' constants.  The dry run's own counts
(``cost.flops_per_device`` from ``torch.utils.flop_counter``) cover
every op it runs, including replicated ones, so they are kept beside it.

 - FLOPs and HBM bytes come from an exact analytic op-count model of our
   own blocks (we control every matmul; the model is validated against
   FlopCounterMode on the port's forward in tests);
 - collective bytes come from the dry run's eager step, which issues
   every layer's collectives (``launch.calibrate`` checks the count
   against the JAX package's two-point fit:
   bytes(R) = base + R * per_layer).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts"


# ---------------------------------------------------------------------------
# analytic FLOPs model (forward, per step, GLOBAL = all chips)
# ---------------------------------------------------------------------------


def _attn_flops(cfg: ModelConfig, tokens: int, t_ctx: float,
                window: Optional[int]) -> float:
    """One GQA attention block: projections + scores/out at avg context."""
    d, dh = cfg.d_model, cfg.d_head
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    t_eff = min(t_ctx, window) if window else t_ctx
    proj = 2 * tokens * d * (nq + 2 * nkv) * dh + 2 * tokens * nq * dh * d
    attn = 2 * 2 * tokens * nq * dh * t_eff
    return proj + attn


def _mla_flops(cfg: ModelConfig, tokens: int, t_ctx: float,
               absorbed: bool) -> float:
    m = cfg.mla
    d, nq = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                     m.v_head_dim, m.kv_lora_rank)
    f = 2 * tokens * d * m.q_lora_rank \
        + 2 * tokens * m.q_lora_rank * nq * (dn + dr) \
        + 2 * tokens * d * (r + dr) \
        + 2 * tokens * nq * dv * d                       # wo
    if absorbed:
        f += 2 * tokens * nq * dn * r                    # q absorb
        f += 2 * tokens * nq * (r + dr) * t_ctx          # scores
        f += 2 * tokens * nq * r * t_ctx                 # ctx
        f += 2 * tokens * nq * r * dv                    # out absorb
    else:
        f += 2 * tokens * r * nq * (dn + dv)             # kv expand (own kv)
        f += 2 * 2 * tokens * nq * (dn + dr) * t_ctx     # scores+out approx
    return f


def _mlp_flops(cfg: ModelConfig, tokens: int, f_dim: int) -> float:
    return 2 * 3 * tokens * cfg.d_model * f_dim


def _moe_flops(cfg: ModelConfig, tokens: int) -> float:
    mo = cfg.moe
    d = cfg.d_model
    f = 2 * tokens * d * mo.n_experts                    # router
    f += mo.top_k * mo.capacity_factor * _mlp_flops(cfg, tokens,
                                                    mo.d_ff_expert)
    if mo.n_shared_experts:
        f += _mlp_flops(cfg, tokens, mo.d_ff_expert * mo.n_shared_experts)
    if mo.dense_residual_d_ff:
        f += _mlp_flops(cfg, tokens, mo.dense_residual_d_ff)
    # group-limited one-hot dispatch einsums: 2 * 2 * tokens * group * ...
    from repro_torch.models.layers import MOE_GROUP_TOKENS
    cap_frac = mo.top_k * mo.capacity_factor
    f += 2 * 2 * tokens * MOE_GROUP_TOKENS * cap_frac * d / mo.n_experts \
        * mo.n_experts / MOE_GROUP_TOKENS * min(tokens, MOE_GROUP_TOKENS)
    return f


def _mamba_flops(cfg: ModelConfig, tokens: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    n = s.d_state
    if s.version == 1:
        dt_rank = max(1, d // 16)
        f = 2 * tokens * d * 2 * d_in                        # in_proj
        f += 2 * tokens * d_in * (dt_rank + 2 * n)           # x_proj
        f += 2 * tokens * dt_rank * d_in                     # dt_proj
        f += tokens * s.d_conv * d_in * 2                    # conv
        f += 6 * tokens * d_in * n                           # scan update
        f += 2 * tokens * d_in * n                           # y = C.h
        f += 2 * tokens * d_in * d                           # out_proj
        return f
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * n
    f = 2 * tokens * d * (2 * d_in + 2 * s.n_groups * n + nh)
    f += tokens * s.d_conv * conv_dim * 2
    # SSD: intra-chunk quadratic (chunk 128) + state passing
    from repro_torch.models.ssm import CHUNK
    lc = min(CHUNK, tokens)
    f += 2 * tokens * lc * nh * (n + s.head_dim)         # cb + y_intra
    f += 4 * tokens * nh * s.head_dim * n                # state update + read
    f += 2 * tokens * d_in * d                           # out_proj
    return f


def _block_flops(cfg: ModelConfig, kind: str, tokens: int, t_ctx: float,
                 decode: bool) -> float:
    if kind in ("attn", "shared_attn"):
        return _attn_flops(cfg, tokens, t_ctx, None) \
            + _mlp_flops(cfg, tokens, cfg.d_ff)
    if kind == "swa":
        return _attn_flops(cfg, tokens, t_ctx, cfg.sliding_window) \
            + _mlp_flops(cfg, tokens, cfg.d_ff)
    if kind == "xattn":
        return _attn_flops(cfg, tokens, t_ctx, None) \
            + _attn_flops(cfg, tokens, cfg.encoder_seq_len, None) \
            + _mlp_flops(cfg, tokens, cfg.d_ff)
    if kind == "mla":
        return _mla_flops(cfg, tokens, t_ctx, absorbed=decode) \
            + _mlp_flops(cfg, tokens, cfg.d_ff)
    if kind == "moe":
        attn = (_mla_flops(cfg, tokens, t_ctx, absorbed=decode)
                if cfg.mla else _attn_flops(cfg, tokens, t_ctx, None))
        return attn + _moe_flops(cfg, tokens)
    if kind in ("mamba1", "mamba2"):
        return _mamba_flops(cfg, tokens)
    raise ValueError(kind)


def flops_model(cfg: ModelConfig, shape: InputShape) -> Dict[str, float]:
    """Global forward FLOPs for one step of this workload + train factor."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens, t_ctx, decode = b * s, s / 2.0, False
    elif shape.kind == "prefill":
        tokens, t_ctx, decode = b * s, s / 2.0, False
    else:
        tokens, t_ctx, decode = b * 1, float(s), True
    head, reps, group, tail = cfg.layer_program
    blocks = list(head) + list(group) * reps + list(tail)
    f_blocks = sum(_block_flops(cfg, k, tokens, t_ctx, decode)
                   for k in blocks)
    if cfg.is_encoder_decoder and shape.kind != "decode":
        enc_tokens = b * cfg.encoder_seq_len
        f_blocks += cfg.n_encoder_layers * (
            _attn_flops(cfg, enc_tokens, cfg.encoder_seq_len / 2, None)
            + _mlp_flops(cfg, enc_tokens, cfg.d_ff))
    logits = 2 * tokens * cfg.d_model * cfg.vocab_size
    fwd = f_blocks + logits
    # train: bwd = 2x fwd, full remat adds ~1x fwd recompute
    factor = 4.0 if shape.kind == "train" else 1.0
    useful = (6.0 if shape.kind == "train" else 2.0) \
        * cfg.active_param_count() * tokens
    return {"fwd": fwd, "total": fwd * factor, "model_flops_6nd": useful}


# ---------------------------------------------------------------------------
# analytic HBM bytes model (GLOBAL)
# ---------------------------------------------------------------------------


def bytes_model(cfg: ModelConfig, shape: InputShape) -> Dict[str, float]:
    b, s = shape.global_batch, shape.seq_len
    dt = 2  # bf16
    p_bytes = cfg.param_count() * dt
    d = cfg.d_model
    head, reps, group, tail = cfg.layer_program
    blocks = list(head) + list(group) * reps + list(tail)
    n_layers = len(blocks)
    if shape.kind == "decode":
        tokens = b
        # params read once per step + cache read + write
        cache_r = _cache_bytes(cfg, b, s)
        act = tokens * d * n_layers * 8 * dt
        total = p_bytes + cache_r["read"] + cache_r["write"] + act
        return {"total": total, "params": p_bytes, **cache_r}
    tokens = b * s
    # per layer: ~6 (B,S,D)-sized reads/writes for matmul IO, plus flash
    # K/V re-reads: (T * kv_width) per q block of 512
    act = tokens * d * n_layers * 6 * dt
    kv_width = 2 * cfg.n_kv_heads * cfg.d_head
    flash_rereads = n_layers * b * (s / 512.0) * s * kv_width * dt * 0.5
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd+bwd+remat sweeps
    p_traffic = p_bytes * (3.0 if shape.kind == "train" else 1.0)
    if shape.kind == "train":
        p_traffic += cfg.param_count() * (4 + 16)  # grads f32? bf16 + m/v f32
    total = p_traffic + (act + flash_rereads) * mult
    return {"total": total, "params": p_traffic, "activations": act * mult,
            "flash_rereads": flash_rereads * mult}


def _cache_bytes(cfg: ModelConfig, b: int, t: int) -> Dict[str, float]:
    dt = 1.02 if cfg.kv_cache_dtype == "int8" else 2  # int8 + 2B/dh scales
    head, reps, group, tail = cfg.layer_program
    blocks = list(head) + list(group) * reps + list(tail)
    read = write = 0.0
    for k in blocks:
        if k in ("attn", "shared_attn", "xattn"):
            read += b * t * 2 * cfg.n_kv_heads * cfg.d_head * dt
            write += b * 2 * cfg.n_kv_heads * cfg.d_head * dt
            if k == "xattn":
                read += b * cfg.encoder_seq_len * 2 * cfg.n_kv_heads \
                    * cfg.d_head * dt
        elif k == "swa":
            w = min(cfg.sliding_window or t, t)
            read += b * w * 2 * cfg.n_kv_heads * cfg.d_head * dt
            write += b * 2 * cfg.n_kv_heads * cfg.d_head * dt
        elif k == "mla" or (k == "moe" and cfg.mla):
            m = cfg.mla
            read += b * t * (m.kv_lora_rank + m.qk_rope_head_dim) * dt
            write += b * (m.kv_lora_rank + m.qk_rope_head_dim) * dt
        elif k == "moe":
            read += b * t * 2 * cfg.n_kv_heads * cfg.d_head * dt
            write += b * 2 * cfg.n_kv_heads * cfg.d_head * dt
        if k in ("mamba1", "mamba2"):
            sscfg = cfg.ssm
            d_in = sscfg.expand * cfg.d_model
            if sscfg.version == 1:
                st = d_in * sscfg.d_state * 4
            else:
                st = (d_in // sscfg.head_dim) * sscfg.head_dim \
                    * sscfg.d_state * 4
            read += b * st
            write += b * st
    return {"read": read, "write": write}


# ---------------------------------------------------------------------------
# report assembly
# ---------------------------------------------------------------------------


def load_dryrun(arch: str, shape: str, mesh: str = "16x16"
                ) -> Optional[Dict[str, Any]]:
    p = ART / "dryrun_torch" / f"{arch}_{shape}_{mesh}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def collective_bytes_per_device(rec: Dict[str, Any],
                                rec_r1: Optional[Dict[str, Any]] = None,
                                rec_r2: Optional[Dict[str, Any]] = None,
                                reps: int = 1) -> float:
    """Total collective bytes, trip-count corrected when the 2-point
    calibration records are available."""
    def total(r):
        return sum(v["bytes"] for v in r["collectives"].values())
    if rec_r1 is None or rec_r2 is None:
        return float(total(rec))
    b1, b2 = total(rec_r1), total(rec_r2)
    per_layer = max(0.0, b2 - b1)
    base = max(0.0, b1 - per_layer)
    return float(base + per_layer * reps)


def roofline(arch: str, shape_name: str, mesh: str = "16x16",
             rec: Optional[Dict[str, Any]] = None,
             coll_bytes: Optional[float] = None,
             cfg: Optional[ModelConfig] = None,
             replicated_weights: bool = False) -> Dict[str, Any]:
    from repro_torch.configs import get_config
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    chips = 512 if mesh.startswith("pod") else 256
    rec = rec or load_dryrun(arch, shape_name, mesh)
    fl = flops_model(cfg, shape)
    by = bytes_model(cfg, shape)
    if replicated_weights and shape.kind == "decode":
        # weights replicated over the data axis: every device reads its own
        # full (model-sharded) copy -> global traffic = chips/model * params
        m_shards = 16
        extra = cfg.param_count() * 2 * (chips / m_shards) \
            - cfg.param_count() * 2
        by = dict(by)
        by["total"] += extra
        by["params_replicated_extra"] = extra
    if coll_bytes is None:
        coll_bytes = (sum(v["bytes"] for v in rec["collectives"].values())
                      if rec and "collectives" in rec else 0.0)
    compute_t = fl["total"] / (chips * PEAK_FLOPS_BF16)
    memory_t = by["total"] / (chips * HBM_BW)
    coll_t = coll_bytes / LINK_BW          # dry-run bytes are per-device
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_t}
    dominant = max(terms, key=terms.get)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh, "chips": chips,
        **terms,
        "dominant": dominant,
        "flops_total": fl["total"],
        "model_flops_6nd": fl["model_flops_6nd"],
        "useful_flops_ratio": fl["model_flops_6nd"] / fl["total"],
        "hbm_bytes": by["total"],
        "collective_bytes_per_device": coll_bytes,
        "hlo_flops_per_device_raw": (rec or {}).get(
            "cost", {}).get("flops_per_device"),
        "memory_per_device": (rec or {}).get("memory"),
    }


SUGGESTIONS = {
    "compute_s": ("compute-bound: raise tensor-core use — larger per-device "
                  "batch/seq tiles, fuse small matmuls, drop remat factor "
                  "with selective checkpointing"),
    "memory_s": ("HBM-bound: cut bytes/step — quantize KV cache, shrink the "
                 "cache via MLA/window, fuse mask+sample (no masked-logit "
                 "round trip), increase arithmetic intensity per pass"),
    "collective_s": ("collective-bound: reshard to cut cross-chip bytes — "
                     "avoid FSDP weight gathers on the decode path, overlap "
                     "collectives with compute, move experts fully onto "
                     "the model axis"),
}


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    from repro_torch.configs import ALIASES
    rows = []
    for arch in ALIASES:
        for shape in INPUT_SHAPES:
            rec = load_dryrun(arch, shape, args.mesh)
            if rec is None or "skipped" in rec:
                continue
            rows.append(roofline(arch, shape, args.mesh, rec))
    rows.sort(key=lambda r: -max(r["compute_s"], r["memory_s"],
                                 r["collective_s"]))
    hdr = (f"{'arch':24s} {'shape':12s} {'compute':>10s} {'memory':>10s} "
           f"{'collective':>11s} dominant")
    print(hdr)
    for r in rows:
        print(f"{r['arch']:24s} {r['shape']:12s} "
              f"{r['compute_s']*1e3:9.2f}ms {r['memory_s']*1e3:9.2f}ms "
              f"{r['collective_s']*1e3:10.2f}ms {r['dominant']}")
    out = ART / "roofline_torch.json"
    out.write_text(json.dumps(rows, indent=1))
    print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
