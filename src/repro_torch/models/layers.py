"""Core transformer layers of the port: norms, RoPE, GQA projections, MLA
(DeepSeek-V3's multi-head latent attention), the gated MLP and the MoE FFN
-- functional style (param dicts of tensors in, tensors out), mirroring
``repro.models.layers``.

Activations are ``cfg.dtype`` (bf16 at full scale); reductions (softmax,
norm variance, the MoE router) in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models.act_sharding import (constrain_batch, local_rows,
                                             unshard)
from repro_torch.models.flash import NEG, _bias_tile, attention_any

Params = Dict[str, object]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Normal(0, 1) * scale drawn in float32 and cast, scale 1/sqrt(fan_in)
    by default -- the distribution of ``repro.models.layers.dense_init``
    (the draws differ: ``torch.Generator`` is not ``jax.random``)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)        # scaled in place: one f32 transient


def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    # variance in f32, products in x.dtype (the reference's rounding points)
    var = torch.mean(x.to(torch.float32) ** 2, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Half-split
    layout: the first and second halves of D rotate as pairs."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def attention_init(gen, cfg: ModelConfig, device) -> Params:
    d, dh = cfg.d_model, cfg.d_head
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    dt = torch_dtype(cfg)
    return {
        "wq": dense_init(gen, (d, nq * dh), dtype=dt, device=device),
        "wk": dense_init(gen, (d, nkv * dh), dtype=dt, device=device),
        "wv": dense_init(gen, (d, nkv * dh), dtype=dt, device=device),
        "wo": dense_init(gen, (nq * dh, d), dtype=dt, device=device),
    }


def _split_heads(x: torch.Tensor, n_heads: int, d_head: int) -> torch.Tensor:
    b, s, _ = x.shape
    if isinstance(x, DTensor) and not _whole_heads(x, n_heads, -1):
        # a shard would hold part of a head: gather the heads' dim first
        x = unshard(x, -1)
    return x.reshape(b, s, n_heads, d_head)


def _whole_heads(x: DTensor, n_heads: int, dim: int) -> bool:
    """True iff every mesh dim that shards ``x``'s dim ``dim`` divides
    ``n_heads``, so that splitting it into heads keeps each within one
    shard."""
    n = 1
    for size, p in zip(x.device_mesh.mesh.shape, x.placements):
        if p.is_shard() and p.dim % x.ndim == dim % x.ndim:
            n *= size
    return n_heads % n == 0


def mlp_init(gen, d: int, f: int, dtype, device) -> Params:
    return {
        "w_gate": dense_init(gen, (d, f), dtype=dtype, device=device),
        "w_up": dense_init(gen, (d, f), dtype=dtype, device=device),
        "w_down": dense_init(gen, (f, d), dtype=dtype, device=device),
    }


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The gated MLP; under a mesh its row-parallel output is pinned to
    the batch placement (``act_sharding.constrain_batch``)."""
    return constrain_batch((F.silu(x @ params["w_gate"])
                            * (x @ params["w_up"])) @ params["w_down"])


# ---------------------------------------------------------------------------
# MLA -- multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg: ModelConfig, device) -> Params:
    m = cfg.mla
    d, nq = cfg.d_model, cfg.n_heads
    dt = torch_dtype(cfg)
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), dtype=dt, device=device),
        "q_norm": rmsnorm_init(m.q_lora_rank, dt, device),
        "wq_b": dense_init(gen, (m.q_lora_rank, nq * qk_dim), dtype=dt,
                           device=device),
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype=dt, device=device),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dt, device),
        "wkv_b": dense_init(
            gen, (m.kv_lora_rank, nq * (m.qk_nope_head_dim + m.v_head_dim)),
            dtype=dt, device=device),
        "wo": dense_init(gen, (nq * m.v_head_dim, d), dtype=dt,
                         device=device),
    }


def mla_compress(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 k_pos: torch.Tensor):
    """The cached latent: compressed kv (B,S,r) + rope key (B,S,1,dr)."""
    m = cfg.mla
    kv = x @ params["wkv_a"]
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    c_kv = rmsnorm(params["kv_norm"], c_kv, cfg.rms_eps)
    k_rope = rope(k_rope[:, :, None, :], k_pos, cfg.rope_theta)
    return c_kv, k_rope


def _mla_q(params: Params, cfg: ModelConfig, x, q_pos):
    m = cfg.mla
    b, s, _ = x.shape
    q = rmsnorm(params["q_norm"], x @ params["wq_a"], cfg.rms_eps) \
        @ params["wq_b"]
    q = q.reshape(b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, rope(q_rope, q_pos, cfg.rope_theta)


def _mla_uk_uv(params: Params, cfg: ModelConfig):
    m = cfg.mla
    w = params["wkv_b"].reshape(
        m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    return w[..., :m.qk_nope_head_dim], w[..., m.qk_nope_head_dim:]


def mla_apply(params: Params, cfg: ModelConfig, x: torch.Tensor,
              q_pos: torch.Tensor, latent: Tuple[torch.Tensor, torch.Tensor],
              k_pos: torch.Tensor,
              k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (non-absorbed) MLA for prefill: per-head K/V materialized from
    the latent, attention through ``flash.attention_any`` with Dk = nope +
    rope and Dv = v_head_dim.  x (B,S,D); latent = (c_kv (B,T,r), k_rope
    (B,T,1,dr))."""
    m = cfg.mla
    nq = cfg.n_heads
    b, s, _ = x.shape
    c_kv, k_rope = latent
    t = c_kv.shape[1]
    q_nope, q_rope = _mla_q(params, cfg, x, q_pos)
    kvb = (c_kv @ params["wkv_b"]).reshape(
        b, t, nq, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kvb[..., :m.qk_nope_head_dim], kvb[..., m.qk_nope_head_dim:]
    # MHA layout (G = nq, Qh = 1) with concatenated nope || rope dims
    q_full = torch.cat([q_nope, q_rope], dim=-1).reshape(
        b, s, nq, 1, m.qk_nope_head_dim + m.qk_rope_head_dim)
    k_full = torch.cat(
        [k_nope, k_rope.expand(b, t, nq, m.qk_rope_head_dim)], dim=-1)
    out = attention_any(q_full, k_full, v, q_pos, k_pos, None, k_valid)
    return constrain_batch(out.reshape(b, s, nq * m.v_head_dim)
                           @ params["wo"])


def mla_apply_absorbed(params: Params, cfg: ModelConfig, x: torch.Tensor,
                       q_pos: torch.Tensor,
                       latent: Tuple[torch.Tensor, torch.Tensor],
                       k_pos: Optional[torch.Tensor],
                       k_valid: Optional[torch.Tensor] = None,
                       lengths: Optional[torch.Tensor] = None,
                       block_tables: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Absorbed MLA decode: W_uk folds into the query and W_uv into the
    output, so attention runs against the compressed latent itself.

    With ``lengths`` set and ``cfg.use_pallas_kernels``, the latent read is
    the split-score decode kernel: one KV group whose score is q_lat . c_kv
    + q_rope . k_rope and whose values are the latent (Dv = r); with
    ``block_tables`` the latent/rope operands are paged pools
    (n_pages, ps, ...).  Otherwise the plain absorbed read over dense
    (B,T,...) latents, masked by ``k_pos``/``k_valid``.
    """
    m = cfg.mla
    nq = cfg.n_heads
    b, s, _ = x.shape
    c_kv, k_rope = latent
    q_nope, q_rope = _mla_q(params, cfg, x, q_pos)
    w_uk, w_uv = _mla_uk_uv(params, cfg)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)     # (B,S,H,r)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if lengths is not None and cfg.use_pallas_kernels:
        # k == v == the latent cache itself; k_rope rides as the split
        # (q2, k2) score term
        lat = c_kv[:, :, None]
        ctx_lat = decode_attention(
            q_lat.contiguous()[:, :, None], lat, lat, lengths, scale=scale,
            q2=q_rope.contiguous()[:, :, None], k2=k_rope,
            block_tables=block_tables)[:, :, 0]
        ctx_lat = ctx_lat.to(x.dtype)                           # (B,S,H,r)
    else:
        def read(q_lat, q_rope, c_kv, k_rope, q_pos, k_pos, k_valid):
            scores = (torch.einsum("bshr,btr->bhst", q_lat, c_kv)
                      + torch.einsum("bshd,btd->bhst", q_rope,
                                     k_rope[:, :, 0]))
            scores = scores.to(torch.float32) * scale
            bias = _bias_tile(q_pos, k_pos, None, k_valid)[:, :, 0]
            probs = torch.softmax(scores + bias, dim=-1).to(x.dtype)
            return torch.einsum("bhst,btr->bshr", probs, c_kv)  # (B,S,H,r)

        args = (q_lat, q_rope, c_kv, k_rope, q_pos, k_pos, k_valid)
        if any(isinstance(a, DTensor) for a in args):
            # each rank reads its own rows and heads of the latent
            heads, rows = (0, 2), (0, None)
            ctx_lat = local_rows(read, args, (
                heads, heads, rows, rows, rows, rows,
                None if k_valid is None else rows), heads, b, nq)
        else:
            ctx_lat = read(*args)
    out = torch.einsum("bshr,rhd->bshd", ctx_lat, w_uv)
    return constrain_batch(out.reshape(b, s, nq * m.v_head_dim)
                           @ params["wo"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _stacked_init(gen, shape, dtype, device) -> torch.Tensor:
    """``dense_init`` of an (E, ...) expert stack -- scale 1/sqrt(shape[0]),
    the reference's fan-in rule -- drawn one expert at a time, so no
    whole-stack float32 transient is ever allocated."""
    scale = 1.0 / math.sqrt(shape[0])
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        x = torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                        device=device)
        out[i] = x.mul_(scale)
    return out


def moe_init(gen, cfg: ModelConfig, device) -> Params:
    mo = cfg.moe
    d, fe = cfg.d_model, mo.d_ff_expert
    dt = torch_dtype(cfg)
    p: Params = {
        "router": dense_init(gen, (d, mo.n_experts), dtype=torch.float32,
                             device=device),
        "w_gate": _stacked_init(gen, (mo.n_experts, d, fe), dt, device),
        "w_up": _stacked_init(gen, (mo.n_experts, d, fe), dt, device),
        "w_down": _stacked_init(gen, (mo.n_experts, fe, d), dt, device),
    }
    if mo.n_shared_experts:
        p["shared"] = mlp_init(gen, d, fe * mo.n_shared_experts, dt, device)
    if mo.dense_residual_d_ff:
        p["dense"] = mlp_init(gen, d, mo.dense_residual_d_ff, dt, device)
    return p


MOE_GROUP_TOKENS = 2048


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lowest index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing with group-limited, capacity-bounded
    einsum dispatch, as ``repro.models.layers.moe_apply``: tokens split
    into groups of ``MOE_GROUP_TOKENS`` (one group when that does not
    divide), each (token, slot) placed at its cumulative position in its
    expert's per-group buffer of ``cap`` slots and dropped past it.  Every
    expert runs on its ``cap`` slots, full or empty.  Returns (output
    (B,S,D), the router's Switch load-balance loss (float32 scalar), a
    training term that serving ignores)."""
    mo = cfg.moe
    b, s, d = x.shape
    n_tok = b * s
    e, k = mo.n_experts, mo.top_k
    g = n_tok // MOE_GROUP_TOKENS if n_tok % MOE_GROUP_TOKENS == 0 else 1
    ng = n_tok // g
    xt = x.reshape(g, ng, d)
    logits = xt.to(torch.float32) @ params["router"]             # (G, Ng, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)                     # (G, Ng, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)               # renorm top-k
    # load-balance aux loss (Switch): e * sum_e f_e * p_e, over all tokens
    me = probs.mean(dim=(0, 1))
    ce = (expert_idx[..., 0, None] == torch.arange(e, device=x.device)
          ).to(torch.float32).mean(dim=(0, 1))
    aux = mo.router_aux_coef * e * torch.sum(me * ce)
    cap = max(1, int(math.ceil(ng * k / e * mo.capacity_factor)))
    cap = min(cap, ng)
    # position of each (token, slot) within its expert's per-group buffer;
    # the one-hots are comparisons (F.one_hot checks its input's range on
    # the host, a device sync a layer)
    experts = torch.arange(e, device=x.device)
    oh = (expert_idx[..., None] == experts).to(torch.int32)     # (G,Ng,k,E)
    flat_oh = oh.reshape(g, ng * k, e)
    pos_in_expert = (torch.cumsum(flat_oh, dim=1) - flat_oh).reshape(
        g, ng, k, e)
    pos = torch.sum(pos_in_expert * oh, dim=-1)                  # (G, Ng, k)
    keep = pos < cap
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    # one-hot of the buffer slot: a zero row for a dropped pos >= cap
    pos_oh = (pos[..., None] == torch.arange(cap, device=x.device)
              ).to(x.dtype)                                      # (G,Ng,k,C)
    disp = torch.einsum("gnke,gnkc->gnec",
                        oh.to(x.dtype) * keep[..., None].to(x.dtype), pos_oh)
    comb = torch.einsum("gnke,gnkc,gnk->gnec", oh.to(torch.float32),
                        pos_oh.to(torch.float32),
                        gate_vals.to(torch.float32)).to(x.dtype)
    # expert products as batched matmuls over E, on the weights as stored
    xe = torch.bmm(disp.reshape(g, ng, e * cap).transpose(1, 2), xt)
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    h = F.silu(torch.bmm(xe, params["w_gate"])) \
        * torch.bmm(xe, params["w_up"])                          # (E, G*C, F)
    ye = torch.bmm(h, params["w_down"])                          # (E, G*C, D)
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    out = torch.bmm(comb.reshape(g, ng, e * cap), ye).reshape(n_tok, d)
    xt_flat = xt.reshape(n_tok, d)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], xt_flat)
    if "dense" in params:
        out = out + mlp_apply(params["dense"], xt_flat)
    return constrain_batch(out.reshape(b, s, d)), aux
