"""Decode caches of the port: dense per-row stripes or a paged pool with
per-slot block tables (``repro.models.kvcache``'s layout).

Dense: ``attn``/``shared_attn`` k/v (B, T_max, n_kv, d_head); ``mla`` the
latent ``ckv`` (B, T_max, kv_lora_rank) and the rope key ``krope``
(B, T_max, 1, qk_rope_head_dim); ``moe`` whichever its attention is (MLA if
``cfg.mla`` else k/v); validity = pos < len.  SSM blocks (``mamba1``/``mamba2``) keep O(1) state a row and
stay dense: ``conv`` (B, d_conv-1, C) in the config's dtype (the last
inputs of the causal conv) and ``ssm`` in float32, (B, d_inner, N) for
Mamba1 and (B, n_heads, head_dim, N) for Mamba2.
Paged (``init_cache(..., page_size=ps)``): k/v are a POOL
(n_pages, ps, n_kv, d_head) -- MLA's ckv/krope likewise (n_pages, ps, ...)
-- shared by all slots plus ``cache["pages"]``, a
(B, max_pages) int32 block table (max_pages = T_max / ps): logical position
p of row b lives at pool row ``pages[b, p // ps]``, offset ``p % ps``.  Page
0 is the trash page: unallocated table entries point at it, so writes from
vacant slots land somewhere harmless; allocators hand out pages 1..n-1.

The cache of a repeated group of layers carries a leading ``reps`` axis, as
in the JAX package, so ``cache["group"]["b0"]["k"][i]`` is layer i's stripe
or pool.  ``len`` is a scalar int32 for the whole model or a (B,) vector
for ragged batched serving.  Entries at positions >= len are garbage by
contract; every reader masks by pos < len.  The port updates caches in
place (the JAX package returns new ones) and returns them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype

# block kinds whose cache can take the paged pool layout
PAGEABLE_KINDS = ("attn", "shared_attn", "mla", "moe")
# block kinds this port runs so far
PORTED_KINDS = ("attn", "shared_attn", "mla", "moe", "mamba1", "mamba2")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for an architecture whose blocks this port does not run yet."""
    head, reps, group, tail = cfg.layer_program
    kinds = set(head) | set(group) | set(tail)
    missing = sorted(kinds - set(PORTED_KINDS))
    if missing or cfg.is_encoder_decoder or cfg.kv_cache_dtype != "native":
        raise NotImplementedError(
            f"{cfg.arch_id}: block kinds {missing or kinds}, encoder-decoder "
            f"or an int8 KV cache are not ported to repro_torch yet "
            f"(ROADMAP Queue 1, 'other architectures')")


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
    group's (reps,) in front -- and ``t`` the stripe or page length."""
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
    shape = tuple(lead) + (t, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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
