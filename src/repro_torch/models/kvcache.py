"""Decode caches of the port: dense per-row stripes or a paged pool with
per-slot block tables (``repro.models.kvcache``'s layout).

Dense: ``attn``/``shared_attn`` k/v (B, T_max, n_kv, d_head); ``mla`` the
latent ``ckv`` (B, T_max, kv_lora_rank) and the rope key ``krope``
(B, T_max, 1, qk_rope_head_dim); ``moe`` whichever its attention is (MLA if
``cfg.mla`` else k/v); validity = pos < len.  ``swa`` keeps a ring
(B, W, n_kv, d_head), W = min(sliding_window, T_max), with a per-row
slot->position map ``pos`` (B, W) int32 that starts at -1 (an empty slot).
``xattn`` (whisper's decoder block) keeps the self-attention stripe plus the
encoder's ``xk``/``xv`` (B, encoder_seq_len, n_kv, d_head), written once at
prefill.  With ``kv_cache_dtype="int8"`` every K/V layout (stripe, pool and
ring) stores int8 ``k``/``v`` with bfloat16 per-(token, head) scales
``k_scale``/``v_scale`` (..., n_kv).  SSM blocks (``mamba1``/``mamba2``)
keep O(1) state a row and stay dense: ``conv`` (B, d_conv-1, C) in the
config's dtype (the last inputs of the causal conv) and ``ssm`` in float32,
(B, d_inner, N) for Mamba1 and (B, n_heads, head_dim, N) for Mamba2.
Paged (``init_cache(..., page_size=ps)``): k/v are a POOL
(n_pages, ps, n_kv, d_head) -- MLA's ckv/krope likewise (n_pages, ps, ...)
-- shared by all slots plus ``cache["pages"]``, a
(B, max_pages) int32 block table (max_pages = T_max / ps): logical position
p of row b lives at pool row ``pages[b, p // ps]``, offset ``p % ps``.  Page
0 is the trash page: unallocated table entries point at it, so writes from
vacant slots land somewhere harmless; allocators hand out pages 1..n-1.
Rings, SSM states and encoder K/V stay dense (``pageable``).

The cache of a repeated group of layers carries a leading ``reps`` axis, as
in the JAX package, so ``cache["group"]["b0"]["k"][i]`` is layer i's stripe
or pool.  ``len`` is a scalar int32 for the whole model or a (B,) vector
for ragged batched serving.  Entries at positions >= len are garbage by
contract; every reader masks by pos < len (a ring by its ``pos`` map).  The
port updates caches in place (the JAX package returns new ones) and
returns them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype

# block kinds whose cache can take the paged pool layout
PAGEABLE_KINDS = ("attn", "shared_attn", "mla", "moe")
# every block kind of the JAX package's model zoo
BLOCK_KINDS = ("attn", "swa", "shared_attn", "mla", "moe", "mamba1",
               "mamba2", "xattn")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a block kind the JAX package does not know either."""
    head, reps, group, tail = cfg.layer_program
    unknown = sorted((set(head) | set(group) | set(tail)) - set(BLOCK_KINDS))
    if unknown:
        raise ValueError(f"{cfg.arch_id}: unknown block kinds {unknown}")


def pageable(cfg: ModelConfig) -> bool:
    """True iff every cache-bearing block of ``cfg`` can be paged."""
    head, reps, group, tail = cfg.layer_program
    kinds = list(head) + list(group) + list(tail)
    return (not cfg.is_encoder_decoder
            and all(k in PAGEABLE_KINDS for k in kinds))


def default_n_pages(batch: int, max_len: int, page_size: int) -> int:
    """Capacity-equivalent pool: as many tokens as ``batch`` contiguous
    stripes would hold, plus the reserved trash page."""
    return batch * (max_len // page_size) + 1


def _block_cache(cfg: ModelConfig, kind: str, lead, t: int, dtype,
                 device) -> dict:
    """Zero cache of one block: ``lead`` is (B,) or (n_pages,) -- with the
    group's (reps,) in front -- and ``t`` the stripe or page length (a
    ring's slots are the first min(sliding_window, t) of it)."""
    if kind in ("mamba1", "mamba2"):
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        if kind == "mamba1":
            conv_c, state = d_in, (d_in, s.d_state)
        else:
            conv_c = d_in + 2 * s.n_groups * s.d_state
            state = (d_in // s.head_dim, s.head_dim, s.d_state)
        return {"conv": torch.zeros(tuple(lead) + (s.d_conv - 1, conv_c),
                                    dtype=dtype, device=device),
                "ssm": torch.zeros(tuple(lead) + state, dtype=torch.float32,
                                   device=device)}
    if kind == "mla" or (kind == "moe" and cfg.mla is not None):
        m = cfg.mla
        return {"ckv": torch.zeros(tuple(lead) + (t, m.kv_lora_rank),
                                   dtype=dtype, device=device),
                "krope": torch.zeros(tuple(lead) + (t, 1, m.qk_rope_head_dim),
                                     dtype=dtype, device=device)}
    nkv, dh = cfg.n_kv_heads, cfg.d_head
    if kind == "swa":
        t = min(cfg.sliding_window or t, t)
    quant = cfg.kv_cache_dtype == "int8"
    kv_dt = torch.int8 if quant else dtype
    shape = tuple(lead) + (t, nkv, dh)
    out = {"k": torch.zeros(shape, dtype=kv_dt, device=device),
           "v": torch.zeros(shape, dtype=kv_dt, device=device)}
    if quant:
        for name in ("k_scale", "v_scale"):
            out[name] = torch.zeros(tuple(lead) + (t, nkv),
                                    dtype=torch.bfloat16, device=device)
    if kind == "swa":
        # per-row slot->position map, -1 = empty: rows of a continuous
        # batch sit at different positions, so each carries its own ring
        out["pos"] = torch.full(tuple(lead) + (t,), -1, dtype=torch.int32,
                                device=device)
    if kind == "xattn":
        enc = tuple(lead) + (cfg.encoder_seq_len, nkv, dh)
        out["xk"] = torch.zeros(enc, dtype=dtype, device=device)
        out["xv"] = torch.zeros(enc, dtype=dtype, device=device)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               page_size: Optional[int] = None,
               n_pages: Optional[int] = None, device="cpu") -> dict:
    """Zero cache of ``cfg``'s stack on ``device``."""
    check_ported(cfg)
    dtype = torch_dtype(cfg)
    head, reps, group, tail = cfg.layer_program
    if page_size is not None:
        assert pageable(cfg), \
            f"{cfg.arch_id}: not every cache-bearing block is pageable"
        assert max_len % page_size == 0, \
            f"max_len {max_len} must be a multiple of page_size {page_size}"
        if n_pages is None:
            n_pages = default_n_pages(batch, max_len, page_size)
        assert n_pages >= 2, "pool needs the trash page plus >= 1 usable"
        lead, t = (n_pages,), page_size
    else:
        lead, t = (batch,), max_len
    cache = {
        "len": torch.zeros((), dtype=torch.int32, device=device),
        "head": [_block_cache(cfg, k, lead, t, dtype, device) for k in head],
        "group": {f"b{i}": _block_cache(cfg, k, (reps,) + lead, t, dtype,
                                        device)
                  for i, k in enumerate(group)},
        "tail": [_block_cache(cfg, k, lead, t, dtype, device) for k in tail],
    }
    if page_size is not None:
        cache["pages"] = torch.zeros((batch, max_len // page_size),
                                     dtype=torch.int32, device=device)
    return cache


def page_size_of(cache) -> Optional[int]:
    """Page size of a paged cache (None for dense layouts): the second axis
    of any pool leaf."""
    if "pages" not in cache:
        return None
    for part in (cache["head"], cache["tail"]):
        for blk in part:
            for v in blk.values():
                return v.shape[1]
    for blk in cache["group"].values():
        for v in blk.values():
            return v.shape[2]          # (reps, n_pages, ps, ...)
    return None


# leaves a forward overwrites whole, which a rewound ``len`` cannot mask
RECURRENT_LEAVES = ("conv", "ssm")


def _state_leaves(blk) -> tuple:
    """Names of ``blk``'s leaves a forward overwrites below ``len``: the
    recurrent state, or every leaf of a ring (a write at position p evicts
    p - W, which a later query still sees once p is rolled back)."""
    if "pos" in blk:
        return tuple(blk)
    return tuple(n for n in RECURRENT_LEAVES if n in blk)


def _block_pairs(a, b):
    """(block of ``a``, the same block of ``b``) over a cache's head, tail
    and group blocks."""
    return (list(zip(a["head"], b["head"])) + list(zip(a["tail"], b["tail"]))
            + [(a["group"][k], b["group"][k]) for k in a["group"]])


def snapshot_state(cache, into=None) -> dict:
    """A cache-shaped view of ``cache`` as it stands before a forward, for a
    speculative refeed: ``len``, every recurrent leaf (``conv``, ``ssm``)
    and every leaf of a sliding-window ring copied -- into ``into``'s
    buffers when given, so a caller allocates them once -- and every other
    leaf aliased.  K/V stripes and pools (and whisper's encoder K/V) need
    no copy: a forward writes them only at positions >= len, which a
    rewound len masks and a refeed rewrites."""
    def block(src, dst):
        out = dict(src)
        for name in _state_leaves(src):
            out[name] = (src[name].clone() if dst is None
                         else dst[name].copy_(src[name]))
        return out

    snap = dict(cache, len=cache["len"].clone())
    for part in ("head", "tail"):
        snap[part] = [block(b, into and into[part][i])
                      for i, b in enumerate(cache[part])]
    snap["group"] = {k: block(b, into and into["group"][k])
                     for k, b in cache["group"].items()}
    return snap


def restore_state(cache, snap) -> dict:
    """Write ``snap``'s copied leaves and ``len`` (from
    :func:`snapshot_state`) back into ``cache``; returns ``cache``."""
    for dst, src in _block_pairs(cache, snap):
        for name in _state_leaves(dst):
            dst[name].copy_(src[name])
    cache["len"] = snap["len"]
    return cache
