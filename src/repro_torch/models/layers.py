"""Core transformer layers of the port, dense subset: norms, RoPE, GQA
projections and the gated MLP -- functional style (param dicts of tensors
in, tensors out), mirroring ``repro.models.layers``.

Activations are ``cfg.dtype`` (bf16 at full scale); reductions (softmax,
norm variance) in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

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
    return (x * scale).to(dtype)


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
    return x.reshape(b, s, n_heads, d_head)


def mlp_init(gen, d: int, f: int, dtype, device) -> Params:
    return {
        "w_gate": dense_init(gen, (d, f), dtype=dtype, device=device),
        "w_up": dense_init(gen, (d, f), dtype=dtype, device=device),
        "w_down": dense_init(gen, (f, d), dtype=dtype, device=device),
    }


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]
