"""Public model API of the port: ``build_model(config) -> Model`` with

  init(generator, device)            -> params
  init_cache(batch, max_len, ...)    -> cache (dense, or paged pool + table)
  prefill(params, inputs, cache)     -> (last logits (B,1,V), cache)
  decode_step(params, cache, tokens) -> (logits (B,S_new,V), cache)
  rollback(cache, n_tokens)          -> cache

mirroring ``repro.models.model`` for the block kinds ported so far
(``kvcache.PORTED_KINDS``: dense attention, zamba2's shared attention, MLA,
MoE and the Mamba1/Mamba2 SSM blocks).  Params are nested dicts of tensors; caches
are updated in place and returned.
``tokens`` in decode_step may carry S_new > 1 (one forward scores a
speculative chain).  Training (``loss``/``train_logits``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import kvcache
from repro_torch.models.layers import (dense_init, rmsnorm, rmsnorm_init,
                                       torch_dtype)
from repro_torch.models.transformer import Ctx, stack_apply, stack_init

Params = Dict[str, Any]
NEG = -1e30


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256; pad logits are -1e30."""
        return ((self.cfg.vocab_size + 255) // 256) * 256

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> Params:
        """Random weights drawn on ``device`` from ``generator`` (a
        generator on that device; default: seed 0)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        cfg = self.cfg
        dt = torch_dtype(cfg)
        params: Params = {
            "embed": dense_init(generator, (self.padded_vocab, cfg.d_model),
                                scale=1.0, dtype=dt, device=dev),
            "final_norm": rmsnorm_init(cfg.d_model, dt, dev),
            "stack": stack_init(generator, cfg, dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(
                generator, (cfg.d_model, self.padded_vocab), dtype=dt,
                device=dev)
        return params

    # -- embedding / head -------------------------------------------------------

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens]

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(params["final_norm"], x, self.cfg.rms_eps)
        if self.cfg.tie_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["lm_head"]
        if self.padded_vocab != self.cfg.vocab_size:
            logits[..., self.cfg.vocab_size:] = NEG
        return logits

    # -- serve ----------------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, page_size=None,
                   n_pages=None, device="cuda"):
        """Dense per-row cache by default; with ``page_size`` the stripes
        become a shared page pool + (B, max_pages) block table
        (``pages``).  Paged caches are decode-only: admission prefills a
        dense B=1 row and scatters it into the row's pages."""
        return kvcache.init_cache(self.cfg, batch, max_len,
                                  page_size=page_size, n_pages=n_pages,
                                  device=resolve_device(device))

    def prefill(self, params: Params, inputs: Dict[str, Any],
                cache) -> Tuple[torch.Tensor, Any]:
        """Run the prompt, fill the cache; returns (last-position logits,
        cache).  ``inputs`` may carry an int ``length``: the prompt is then
        right-padded to a bucket and only the first ``length`` tokens are
        real -- the head reads the true last token and ``len`` advances by
        ``length``, so pad K/V sits beyond the valid frontier."""
        tokens = inputs["tokens"]
        x = self._embed(params, tokens)
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        ctx = Ctx(mode="prefill", q_pos=pos, cache_len=cache["len"])
        x = stack_apply(params["stack"], self.cfg, x, ctx, cache)
        length = inputs.get("length")
        if length is None:
            cache["len"] = cache["len"] + s
            return self._head(params, x[:, -1:]), cache
        length = int(length)
        cache["len"] = cache["len"] + length
        return self._head(params, x[:, length - 1:length]), cache

    def decode_step(self, params: Params, cache,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """tokens: (B, S_new).  Returns logits (B, S_new, V); the cache's
        ``len`` (scalar or per-row (B,)) advances by S_new."""
        x = self._embed(params, tokens)
        b, s, _ = x.shape
        ln = cache["len"]
        base = ln[:, None] if ln.dim() == 1 else ln
        pos = base + torch.arange(s, dtype=torch.int32,
                                  device=x.device).expand(b, s)
        ctx = Ctx(mode="decode", q_pos=pos, cache_len=ln,
                  pages=cache.get("pages"))
        x = stack_apply(params["stack"], self.cfg, x, ctx, cache)
        cache["len"] = ln + s
        return self._head(params, x), cache

    def rollback(self, cache, n_tokens: int):
        """Speculative rollback: rewind ``len`` (entries beyond len are
        masked by validity, so nothing is copied).  SSM states cannot be
        rewound; the JAX package refeeds them instead, which the port does
        not do yet (speculation is not ported)."""
        out = dict(cache)
        out["len"] = cache["len"] - n_tokens
        return out


def build_model(cfg: ModelConfig) -> Model:
    cfg.check()
    kvcache.check_ported(cfg)
    return Model(cfg)
