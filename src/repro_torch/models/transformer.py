"""Block assembly of the port: head blocks + a repeated group + tail
blocks, as in ``repro.models.transformer``.  The JAX package scans the
group over stacked layer params; here the group's params are a per-layer
list and the loop is a Python loop, while the group's cache keeps its
leading ``reps`` axis (layer i writes ``cache[...][i]`` in place).  In
train mode each repetition of the group runs under activation
checkpointing, as the JAX package remats its scanned group.

Block kinds (every kind of the JAX package):
  attn          GQA transformer block
  swa           the same over a sliding window, its cache a per-row ring
  shared_attn   zamba2's shared-weight attention block: the ``attn`` math on
                ONE set of weights (``params["shared_attn"]``) for every
                invocation, each with its own K/V cache
  mla           DeepSeek multi-head latent attention block (MLA + dense MLP)
  moe           MoE-FFN block (attention = MLA if ``cfg.mla`` else GQA)
  mamba1        Mamba1 (selective scan) block, pre-norm and residual
  mamba2        Mamba2 (SSD) block, pre-norm and residual
  xattn         encoder-decoder decoder block (self + cross attention)

An ``int8`` KV cache (``cfg.kv_cache_dtype``) quantizes each new token's
K/V per (token, head) as it is written and dequantizes the whole stripe,
pool or ring in plain code before it is read, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import gather_pages
from repro_torch.models import act_sharding, ssm
from repro_torch.models.flash import attention_any
from repro_torch.models.kvcache import check_ported
from repro_torch.models.layers import (_split_heads, _whole_heads,
                                       attention_init,
                                       mla_apply, mla_apply_absorbed,
                                       mla_compress, mla_init, mlp_apply,
                                       mlp_init, moe_apply, moe_init, rmsnorm,
                                       rmsnorm_init, rope, torch_dtype)

Params = Dict[str, Any]


@dataclasses.dataclass
class Ctx:
    mode: str                                  # 'train' | 'prefill' | 'decode'
    q_pos: torch.Tensor                        # (B, S)
    cache_len: Optional[torch.Tensor] = None   # () or (B,) int32
    # paged KV serving: (B, max_pages) int32 block table -- position p of
    # row b lives at pool row pages[b, p // ps], offset p % ps
    pages: Optional[torch.Tensor] = None
    enc_out: Optional[torch.Tensor] = None     # (B, T_enc, D) for xattn

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
    if kind in ("attn", "swa", "shared_attn"):
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
    if kind == "xattn":
        return {
            "norm1": rmsnorm_init(d, dt, device),
            "attn": attention_init(gen, cfg, device),
            "norm_x": rmsnorm_init(d, dt, device),
            "xattn": attention_init(gen, cfg, device),
            "norm2": rmsnorm_init(d, dt, device),
            "mlp": mlp_init(gen, d, cfg.d_ff, dt, device),
        }
    raise ValueError(kind)


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
                    cache: Optional[Params],
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention output (B,S,D); writes this step's K/V into ``cache``.
    With ``window`` (an ``swa`` block) the decode read is the plain path
    over [old ring || new keys], as in the JAX package."""
    nq, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b, s, _ = xn.shape
    q = rope(_split_heads(xn @ p["wq"], nq, dh), ctx.q_pos, cfg.rope_theta)
    k_new = rope(_split_heads(xn @ p["wk"], nkv, dh), ctx.q_pos,
                 cfg.rope_theta)
    v_new = _split_heads(xn @ p["wv"], nkv, dh)
    if isinstance(q, DTensor) and not _whole_heads(q, nkv, 2):
        # a shard would split a KV group's query heads: gather them first
        q = act_sharding.unshard(q, 2)
    qg = q.reshape(b, s, nkv, nq // nkv, dh)

    if cache is None or ctx.mode == "prefill":
        out = attention_any(qg, k_new, v_new, ctx.q_pos, ctx.q_pos, window)
        if cache is not None:
            _write_kv(cache, ctx, **_kv_leaves(cache, k_new, v_new))
    elif window is not None:
        # the ring: with S > 1 (a verify window) the new writes may evict
        # keys that earlier queries of this very step still see, so attend
        # over [old ring || new keys], then write
        k_old, v_old = _read_kv(cache, xn.dtype)
        k_all = torch.cat([k_old, k_new], dim=1)
        v_all = torch.cat([v_old, v_new], dim=1)
        k_pos = torch.cat([cache["pos"], ctx.q_pos], dim=1)
        out = attention_any(qg, k_all, v_all, ctx.q_pos, k_pos, window,
                            k_pos >= 0)
        _write_kv(cache, ctx, **_kv_leaves(cache, k_new, v_new))
    else:  # decode
        _write_kv(cache, ctx, **_kv_leaves(cache, k_new, v_new))
        k_all, v_all = _read_kv(cache, xn.dtype)
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
    return act_sharding.constrain_batch(out.reshape(b, s, nq * dh)
                                        @ p["wo"])


def _quantize_kv(x: torch.Tensor):
    """(B,S,H,D) -> int8 values and (B,S,H) bfloat16 scales, one a (token,
    head): max |x| / 127, at least 1e-8; values rounded half to even, as
    ``jnp.round`` does."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype) -> torch.Tensor:
    return (q.to(torch.float32)
            * scale.to(torch.float32)[..., None]).to(dtype)


def _kv_leaves(cache: Params, k: torch.Tensor, v: torch.Tensor) -> dict:
    """The leaves a K/V write stores: k/v, or their int8 values and scales
    when the cache is quantized."""
    if "k_scale" not in cache:
        return {"k": k, "v": v}
    k, k_sc = _quantize_kv(k)
    v, v_sc = _quantize_kv(v)
    return {"k": k, "v": v, "k_scale": k_sc, "v_scale": v_sc}


def _read_kv(cache: Params, dtype):
    """The cache's k/v in the compute dtype (an int8 cache dequantized
    whole, in plain code)."""
    if "k_scale" in cache:
        return (_dequantize_kv(cache["k"], cache["k_scale"], dtype),
                _dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


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
    if "pos" in cache:
        _write_ring(cache, ctx, new)
        return
    if ctx.paged:
        # rows own disjoint pages, so index pairs never collide across live
        # rows (vacant rows all land on the trash page)
        prow, poff = _page_translate(ctx, b, s, cache[name0].shape[1])
        for name, x in new.items():
            cache[name][prow, poff] = x
        return
    t = cache[name0].shape[1]
    if ctx.ragged:
        # writes past T_max are dropped, as a scatter drops them, without
        # reading the lengths back: a dropped position p >= T_max writes
        # its row's own value back at p - S instead, a position below that
        # row's frontier which no new token of this write touches (S <= T
        # and the dropped positions are distinct, so no index repeats)
        rows = torch.arange(b, device=first.device)[:, None].expand(b, s)
        idx = ln[:, None].long() + torch.arange(s, device=first.device)[None, :]
        keep = idx < t
        dst = torch.where(keep, idx, idx - s)
        for name, x in new.items():
            leaf = cache[name]
            k = keep.reshape((b, s) + (1,) * (x.dim() - 2))
            leaf[rows, dst] = torch.where(k, x, leaf[rows, dst])
        return
    # one offset for the batch: a slice update whose start is clamped so
    # the S positions fit (dynamic_update_slice's rule)
    start = torch.clamp(ln.long(), 0, t - s)
    idx = start + torch.arange(s, device=first.device)
    for name, x in new.items():
        if isinstance(cache[name], DTensor):
            act_sharding.write_slots(cache[name], x, start)
        else:
            cache[name].index_copy_(1, idx, x)


def _write_ring(cache: Params, ctx: Ctx, new: dict) -> None:
    """Ring write, per row: the last min(S, W) new tokens go to slots
    position % W, and the slot->position map ``pos`` follows.  Rows of a
    ragged batch sit at different positions, so offsets are (B, n)."""
    first = next(iter(new.values()))
    b, s = first.shape[:2]
    w = cache["pos"].shape[1]
    n = min(s, w)                      # only the last w tokens can survive
    ln = ctx.cache_len
    ln_b = ln[:, None] if ctx.ragged else ln.reshape(1, 1).expand(b, 1)
    pos_val = ln_b + (s - n) + torch.arange(n, dtype=torch.int32,
                                            device=ln.device)[None, :]
    if isinstance(cache["pos"], DTensor):
        for name, x in new.items():
            act_sharding.write_slots(cache[name], x[:, s - n:],
                                     pos_val[:, :1], wrap=w)
        act_sharding.write_slots(cache["pos"], pos_val, pos_val[:, :1],
                                 wrap=w)
        return
    idx = (pos_val % w).long()         # (B, n), distinct within a row
    rows = torch.arange(b, device=ln.device)[:, None].expand(b, n)
    for name, x in new.items():
        cache[name][rows, idx] = x[:, s - n:]
    cache["pos"][rows, idx] = pos_val


def _cross_attention(p: Params, cfg: ModelConfig, xn: torch.Tensor,
                     ctx: Ctx, cache: Optional[Params]) -> torch.Tensor:
    """Decoder -> encoder attention, no rope and no mask.  Prefill (and
    training) project the encoder output, writing ``xk``/``xv`` into
    ``cache``; decode reads them back."""
    nq, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b, s, _ = xn.shape
    q = _split_heads(xn @ p["wq"], nq, dh).reshape(b, s, nkv, nq // nkv, dh)
    if ctx.mode in ("train", "prefill") and ctx.enc_out is not None:
        xk = _split_heads(ctx.enc_out @ p["wk"], nkv, dh)
        xv = _split_heads(ctx.enc_out @ p["wv"], nkv, dh)
        if cache is not None:
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
    else:
        xk, xv = cache["xk"], cache["xv"]
    t = xk.shape[1]
    # position 0 everywhere: the causal bias never masks
    zq = torch.zeros((b, s), dtype=torch.int32, device=xn.device)
    zk = torch.zeros((b, t), dtype=torch.int32, device=xn.device)
    out = attention_any(q, xk, xv, zq, zk)
    return act_sharding.constrain_batch(out.reshape(b, s, nq * dh)
                                        @ p["wo"])


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
                ctx: Ctx, cache: Optional[Params]):
    """One block -> (x, aux loss): the MoE router's load-balance term, a
    float32 scalar, or 0.0 for the other kinds.  Its ``cache`` (if given)
    is written in place."""
    if kind in ("attn", "swa", "shared_attn"):
        window = cfg.sliding_window if kind == "swa" else None
        x = x + _self_attention(p["attn"], cfg,
                                rmsnorm(p["norm1"], x, cfg.rms_eps), ctx,
                                cache, window)
        return x + mlp_apply(p["mlp"],
                             rmsnorm(p["norm2"], x, cfg.rms_eps)), 0.0
    if kind == "xattn":
        x = x + _self_attention(p["attn"], cfg,
                                rmsnorm(p["norm1"], x, cfg.rms_eps), ctx,
                                cache)
        x = x + _cross_attention(p["xattn"], cfg,
                                 rmsnorm(p["norm_x"], x, cfg.rms_eps), ctx,
                                 cache)
        return x + mlp_apply(p["mlp"],
                             rmsnorm(p["norm2"], x, cfg.rms_eps)), 0.0
    if kind == "mla":
        x = x + _mla_attention(p["mla"], cfg,
                               rmsnorm(p["norm1"], x, cfg.rms_eps), ctx,
                               cache)
        return x + mlp_apply(p["mlp"],
                             rmsnorm(p["norm2"], x, cfg.rms_eps)), 0.0
    if kind == "moe":
        xn = rmsnorm(p["norm1"], x, cfg.rms_eps)
        if cfg.mla is not None:
            x = x + _mla_attention(p["mla"], cfg, xn, ctx, cache)
        else:
            x = x + _self_attention(p["attn"], cfg, xn, ctx, cache)
        h, aux = moe_apply(p["moe"], cfg, rmsnorm(p["norm2"], x, cfg.rms_eps))
        return x + h, aux
    if kind in ("mamba1", "mamba2"):
        fn = ssm.mamba1_apply if kind == "mamba1" else ssm.mamba2_apply
        train = ctx.mode == "train"
        # training starts every sequence from zero state
        conv_st = cache["conv"] if cache is not None and not train else None
        ssm_st = cache["ssm"] if cache is not None and not train else None
        y, (new_conv, new_ssm) = fn(p["mamba"], cfg,
                                    rmsnorm(p["norm"], x, cfg.rms_eps),
                                    conv_st, ssm_st, train=train)
        if cache is not None:
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(new_ssm)
        return x + y, 0.0
    raise ValueError(kind)


def stack_apply(params: Params, cfg: ModelConfig, x: torch.Tensor, ctx: Ctx,
                cache: Optional[Params]):
    """Run head blocks, ``reps`` repetitions of the group, tail blocks ->
    (x, summed aux loss).  Every ``shared_attn`` of the group runs on
    ``params["shared_attn"]`` with its own repetition's cache.  ``cache``
    (if given) is written in place.  In train mode each repetition runs
    under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward instead of kept, so activation memory is
    one repetition's."""
    check_ported(cfg)
    head, reps, group, tail = cfg.layer_program
    shared = params.get("shared_attn")
    aux_total = 0.0
    for i, kind in enumerate(head):
        c = cache["head"][i] if cache is not None else None
        x, aux = block_apply(params["head"][i], cfg, kind, x, ctx, c)
        aux_total = aux_total + aux

    def run_group(h, r, caches):
        aux_g = 0.0
        for j, kind in enumerate(group):
            p = shared if kind == "shared_attn" \
                else params["group"][f"b{j}"][r]
            h, a = block_apply(p, cfg, kind, h, ctx, caches[j])
            aux_g = aux_g + a
        return h, aux_g

    remat = ctx.mode == "train" and torch.is_grad_enabled()
    for r in range(reps):
        # every repetition starts from the same placement under a mesh (the
        # identity on plain tensors), so each issues the same collectives;
        # outside the checkpointed body, where it costs no saved activation
        x = act_sharding.constrain_batch(x)
        caches = [None] * len(group)
        if cache is not None:
            caches = [{name: leaf[r]
                       for name, leaf in cache["group"][f"b{j}"].items()}
                      for j in range(len(group))]
        if remat:
            x, aux = checkpoint(run_group, x, r, caches, use_reentrant=False)
        else:
            x, aux = run_group(x, r, caches)
        aux_total = aux_total + aux
    for i, kind in enumerate(tail):
        c = cache["tail"][i] if cache is not None else None
        x, aux = block_apply(params["tail"][i], cfg, kind, x, ctx, c)
        aux_total = aux_total + aux
    return x, aux_total
