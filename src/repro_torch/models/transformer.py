"""Block assembly of the port: head blocks + a repeated group + tail
blocks, as in ``repro.models.transformer``.  The JAX package scans the
group over stacked layer params; here the group's params are a per-layer
list and the loop is a Python loop, while the group's cache keeps its
leading ``reps`` axis (layer i writes ``cache[...][i]`` in place).

Block kinds ported so far:
  attn          GQA transformer block
  shared_attn   zamba2's shared-weight attention block: the ``attn`` math on
                ONE set of weights (``params["shared_attn"]``) for every
                invocation, each with its own K/V cache
  mla           DeepSeek multi-head latent attention block (MLA + dense MLP)
  moe           MoE-FFN block (attention = MLA if ``cfg.mla`` else GQA)
  mamba1        Mamba1 (selective scan) block, pre-norm and residual
  mamba2        Mamba2 (SSD) block, pre-norm and residual
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import gather_pages
from repro_torch.models import ssm
from repro_torch.models.flash import attention_any
from repro_torch.models.kvcache import check_ported
from repro_torch.models.layers import (_split_heads, attention_init,
                                       mla_apply, mla_apply_absorbed,
                                       mla_compress, mla_init, mlp_apply,
                                       mlp_init, moe_apply, moe_init, rmsnorm,
                                       rmsnorm_init, rope, torch_dtype)

Params = Dict[str, Any]


@dataclasses.dataclass
class Ctx:
    mode: str                                  # 'prefill' | 'decode'
    q_pos: torch.Tensor                        # (B, S)
    cache_len: Optional[torch.Tensor] = None   # () or (B,) int32
    # paged KV serving: (B, max_pages) int32 block table -- position p of
    # row b lives at pool row pages[b, p // ps], offset p % ps
    pages: Optional[torch.Tensor] = None
    # dense ragged writes: whether every row's S new positions fit below
    # T_max (checked once per forward; writes past T_max are dropped)
    dense_fits: Optional[bool] = None

    @property
    def ragged(self) -> bool:
        return self.cache_len is not None and self.cache_len.dim() == 1

    @property
    def paged(self) -> bool:
        return self.pages is not None


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               device) -> Params:
    d = cfg.d_model
    dt = torch_dtype(cfg)
    if kind in ("attn", "shared_attn"):
        return {
            "norm1": rmsnorm_init(d, dt, device),
            "attn": attention_init(gen, cfg, device),
            "norm2": rmsnorm_init(d, dt, device),
            "mlp": mlp_init(gen, d, cfg.d_ff, dt, device),
        }
    if kind == "mla":
        return {
            "norm1": rmsnorm_init(d, dt, device),
            "mla": mla_init(gen, cfg, device),
            "norm2": rmsnorm_init(d, dt, device),
            "mlp": mlp_init(gen, d, cfg.d_ff, dt, device),
        }
    if kind == "moe":
        p: Params = {"norm1": rmsnorm_init(d, dt, device),
                     "norm2": rmsnorm_init(d, dt, device),
                     "moe": moe_init(gen, cfg, device)}
        if cfg.mla is not None:
            p["mla"] = mla_init(gen, cfg, device)
        else:
            p["attn"] = attention_init(gen, cfg, device)
        return p
    if kind == "mamba1":
        return {"norm": rmsnorm_init(d, dt, device),
                "mamba": ssm.mamba1_init(gen, cfg, device)}
    if kind == "mamba2":
        return {"norm": rmsnorm_init(d, dt, device),
                "mamba": ssm.mamba2_init(gen, cfg, device)}
    raise NotImplementedError(
        f"block kind {kind!r} is not ported to repro_torch yet (ROADMAP "
        "Queue 1, 'other architectures')")


def stack_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Per-layer params; a ``shared_attn`` block's weights are built once,
    at ``params["shared_attn"]``, and its group slot stays empty."""
    head, reps, group, tail = cfg.layer_program
    params: Params = {
        "head": [block_init(gen, cfg, k, device) for k in head],
        "tail": [block_init(gen, cfg, k, device) for k in tail],
    }
    if "shared_attn" in head + group + tail:
        params["shared_attn"] = block_init(gen, cfg, "shared_attn", device)
    params["group"] = {f"b{i}": ([] if k == "shared_attn" else
                                 [block_init(gen, cfg, k, device)
                                  for _ in range(reps)])
                       for i, k in enumerate(group)}
    return params


# ---------------------------------------------------------------------------
# attention with cache plumbing
# ---------------------------------------------------------------------------


def _self_attention(p: Params, cfg: ModelConfig, xn: torch.Tensor, ctx: Ctx,
                    cache: Optional[Params]) -> torch.Tensor:
    """Attention output (B,S,D); writes this step's K/V into ``cache``."""
    nq, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b, s, _ = xn.shape
    q = rope(_split_heads(xn @ p["wq"], nq, dh), ctx.q_pos, cfg.rope_theta)
    k_new = rope(_split_heads(xn @ p["wk"], nkv, dh), ctx.q_pos,
                 cfg.rope_theta)
    v_new = _split_heads(xn @ p["wv"], nkv, dh)
    qg = q.reshape(b, s, nkv, nq // nkv, dh)

    if cache is None or ctx.mode == "prefill":
        out = attention_any(qg, k_new, v_new, ctx.q_pos, ctx.q_pos)
        if cache is not None:
            _write_kv(cache, ctx, k=k_new, v=v_new)
    else:  # decode
        _write_kv(cache, ctx, k=k_new, v=v_new)
        k_all, v_all = cache["k"], cache["v"]
        if cfg.use_pallas_kernels:
            # hand-written ragged decode kernel: q (B,S,G,Qh,D) against the
            # cache (B,T,G,D) or the (n_pages,ps,G,D) pool through the
            # block table; per-row lengths and the S>1 window in-kernel
            out = decode_attention(qg, k_all, v_all, ctx.cache_len + 1,
                                   block_tables=ctx.pages)
        else:
            if ctx.paged:
                k_all = gather_pages(k_all, ctx.pages)
                v_all = gather_pages(v_all, ctx.pages)
            t = k_all.shape[1]
            k_pos = torch.arange(t, dtype=torch.int32,
                                 device=xn.device).expand(b, t)
            lim = (ctx.cache_len[:, None] if ctx.ragged
                   else ctx.cache_len) + s
            out = attention_any(qg, k_all, v_all, ctx.q_pos, k_pos, None,
                                k_pos < lim)
    return out.reshape(b, s, nq * dh) @ p["wo"]


def _page_translate(ctx: Ctx, b: int, s: int, page_size: int):
    """(pool row, in-page offset), both (B, S) int64, for the S new tokens
    each row writes at positions cache_len[b]..cache_len[b]+S-1.  Vacant
    table entries (<= 0) AND positions past the table's width go to pool
    row 0, the trash page -- never to the last table column, which would
    corrupt the row's newest live page."""
    ln = ctx.cache_len
    ln_b = ln[:, None] if ctx.ragged else ln.reshape(1, 1).expand(b, 1)
    pos = ln_b.long() + torch.arange(s, device=ln.device)[None, :]
    tbl = torch.clamp(ctx.pages, min=0).long()                  # (B, MP)
    pidx = pos // page_size
    prow = torch.take_along_dim(
        tbl, torch.clamp(pidx, max=tbl.shape[1] - 1), dim=1)
    prow = torch.where(pidx >= tbl.shape[1], torch.zeros_like(prow), prow)
    return prow, pos % page_size


def _write_kv(cache: Params, ctx: Ctx, **new: torch.Tensor) -> None:
    """Write the S new tokens' cache leaves (each (B,S,...): K/V, or MLA's
    latent and rope key) at each row's frontier, in place."""
    first = next(iter(new.values()))
    b, s = first.shape[:2]
    ln = ctx.cache_len
    name0 = next(iter(new))
    if ctx.paged:
        # rows own disjoint pages, so index pairs never collide across live
        # rows (vacant rows all land on the trash page)
        prow, poff = _page_translate(ctx, b, s, cache[name0].shape[1])
        for name, x in new.items():
            cache[name][prow, poff] = x
        return
    t = cache[name0].shape[1]
    if ctx.ragged:
        rows = torch.arange(b, device=first.device)[:, None].expand(b, s)
        idx = ln[:, None].long() + torch.arange(s, device=first.device)[None, :]
        if ctx.dense_fits is None:
            ctx.dense_fits = int(ln.max()) + s <= t
        if ctx.dense_fits:
            for name, x in new.items():
                cache[name][rows, idx] = x
        else:                      # drop writes past T_max, as a scatter does
            keep = idx < t
            for name, x in new.items():
                cache[name][rows[keep], idx[keep]] = x[keep]
        return
    # one offset for the batch: a slice update whose start is clamped so
    # the S positions fit (dynamic_update_slice's rule)
    start = torch.clamp(ln.long(), 0, t - s)
    idx = start + torch.arange(s, device=first.device)
    for name, x in new.items():
        cache[name].index_copy_(1, idx, x)


def _mla_attention(p: Params, cfg: ModelConfig, xn: torch.Tensor, ctx: Ctx,
                   cache: Optional[Params]) -> torch.Tensor:
    """MLA output (B,S,D); writes this step's latent ``ckv`` and rope key
    ``krope`` into ``cache``.  Prefill runs full MLA over the new tokens;
    decode runs the absorbed read, through the split-score kernel
    (``use_pallas_kernels``) or over the gathered / dense latents."""
    b, s, _ = xn.shape
    c_kv, k_rope = mla_compress(p, cfg, xn, ctx.q_pos)
    if cache is None or ctx.mode == "prefill":
        out = mla_apply(p, cfg, xn, ctx.q_pos, (c_kv, k_rope), ctx.q_pos)
        if cache is not None:
            _write_kv(cache, ctx, ckv=c_kv, krope=k_rope)
        return out
    _write_kv(cache, ctx, ckv=c_kv, krope=k_rope)
    if cfg.use_pallas_kernels:
        # the split-score kernel: per-row lengths, the S>1 window, and paged
        # pools streamed through the block table, in-kernel
        return mla_apply_absorbed(p, cfg, xn, ctx.q_pos,
                                  (cache["ckv"], cache["krope"]), None, None,
                                  lengths=ctx.cache_len + 1,
                                  block_tables=ctx.pages)
    ckv, krope = cache["ckv"], cache["krope"]
    if ctx.paged:
        ckv = gather_pages(ckv, ctx.pages)
        krope = gather_pages(krope, ctx.pages)
    t = ckv.shape[1]
    k_pos = torch.arange(t, dtype=torch.int32, device=xn.device).expand(b, t)
    lim = (ctx.cache_len[:, None] if ctx.ragged else ctx.cache_len) + s
    return mla_apply_absorbed(p, cfg, xn, ctx.q_pos, (ckv, krope), k_pos,
                              k_pos < lim)


# ---------------------------------------------------------------------------
# block / stack apply
# ---------------------------------------------------------------------------


def block_apply(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                ctx: Ctx, cache: Optional[Params]) -> torch.Tensor:
    """One block; its ``cache`` (if given) is written in place."""
    if kind in ("attn", "shared_attn"):
        x = x + _self_attention(p["attn"], cfg,
                                rmsnorm(p["norm1"], x, cfg.rms_eps), ctx,
                                cache)
        return x + mlp_apply(p["mlp"], rmsnorm(p["norm2"], x, cfg.rms_eps))
    if kind == "mla":
        x = x + _mla_attention(p["mla"], cfg,
                               rmsnorm(p["norm1"], x, cfg.rms_eps), ctx,
                               cache)
        return x + mlp_apply(p["mlp"], rmsnorm(p["norm2"], x, cfg.rms_eps))
    if kind == "moe":
        xn = rmsnorm(p["norm1"], x, cfg.rms_eps)
        if cfg.mla is not None:
            x = x + _mla_attention(p["mla"], cfg, xn, ctx, cache)
        else:
            x = x + _self_attention(p["attn"], cfg, xn, ctx, cache)
        return x + moe_apply(p["moe"], cfg,
                             rmsnorm(p["norm2"], x, cfg.rms_eps))
    if kind in ("mamba1", "mamba2"):
        fn = ssm.mamba1_apply if kind == "mamba1" else ssm.mamba2_apply
        conv_st = cache["conv"] if cache is not None else None
        ssm_st = cache["ssm"] if cache is not None else None
        y, (new_conv, new_ssm) = fn(p["mamba"], cfg,
                                    rmsnorm(p["norm"], x, cfg.rms_eps),
                                    conv_st, ssm_st)
        if cache is not None:
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(new_ssm)
        return x + y
    raise NotImplementedError(
        f"block kind {kind!r} is not ported to repro_torch yet")


def stack_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, ctx: Ctx,
                cache: Optional[Params]) -> torch.Tensor:
    """Run head blocks, ``reps`` repetitions of the group, tail blocks.
    Every ``shared_attn`` of the group runs on ``params["shared_attn"]``
    with its own repetition's cache.  ``cache`` (if given) is written in
    place."""
    check_ported(cfg)
    head, reps, group, tail = cfg.layer_program
    shared = params.get("shared_attn")
    for i, kind in enumerate(head):
        c = cache["head"][i] if cache is not None else None
        x = block_apply(params["head"][i], cfg, kind, x, ctx, c)
    for r in range(reps):
        for j, kind in enumerate(group):
            c = None
            if cache is not None:
                c = {name: leaf[r]
                     for name, leaf in cache["group"][f"b{j}"].items()}
            p = shared if kind == "shared_attn" \
                else params["group"][f"b{j}"][r]
            x = block_apply(p, cfg, kind, x, ctx, c)
    for i, kind in enumerate(tail):
        c = cache["tail"][i] if cache is not None else None
        x = block_apply(params["tail"][i], cfg, kind, x, ctx, c)
    return x
