"""Public model API of the port: ``build_model(config) -> Model`` with

  init(generator, device)            -> params
  train_logits(params, inputs)       -> (logits (B,S,V), aux loss)
  loss(params, batch)                -> (scalar, metrics)
  init_cache(batch, max_len, ...)    -> cache (dense, or paged pool + table)
  prefill(params, inputs, cache)     -> (last logits (B,1,V), cache)
  decode_step(params, cache, tokens) -> (logits (B,S_new,V), cache)
  rollback(cache, n_tokens)          -> cache

mirroring ``repro.models.model`` for every block kind of its zoo
(``kvcache.BLOCK_KINDS``: full and sliding-window attention, zamba2's
shared attention, MLA, MoE, the Mamba1/Mamba2 SSM blocks and whisper's
encoder-decoder block).  ``inputs`` may carry a VLM's ``prefix`` (B, P, D),
embedded before the tokens, and an encoder-decoder's ``frames``
(B, T_enc, D), run through the bidirectional encoder.  Params are nested
dicts of tensors; caches are updated in place and returned.
``tokens`` in decode_step may carry S_new > 1 (one forward scores a
speculative chain).  ``loss`` is differentiable: autograd takes the
gradient of every parameter, the group's repetitions rematerialized and
long attention through the flash backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import act_sharding, kvcache
from repro_torch.models.layers import (dense_init, rmsnorm, rmsnorm_init,
                                       torch_dtype)
from repro_torch.models.transformer import (Ctx, block_apply, block_init,
                                            stack_apply, stack_init)

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
        if cfg.is_encoder_decoder:
            # one dict a layer (the JAX package stacks them on an axis)
            params["encoder"] = {
                "blocks": [block_init(generator, cfg, "attn", dev)
                           for _ in range(cfg.n_encoder_layers)],
                "norm": rmsnorm_init(cfg.d_model, dt, dev),
            }
        return params

    # -- embedding / head -------------------------------------------------------

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        if isinstance(params["embed"], DTensor):
            return act_sharding.constrain_batch(
                act_sharding.vocab_embed(params["embed"], tokens))
        return act_sharding.constrain_batch(params["embed"][tokens])

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = act_sharding.constrain_batch(
            rmsnorm(params["final_norm"], x, self.cfg.rms_eps))
        if self.cfg.tie_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["lm_head"]
        if self.padded_vocab != self.cfg.vocab_size:
            if isinstance(logits, DTensor):
                # no sharding rule fills a slice of a vocab-sharded tensor
                pad = torch.arange(self.padded_vocab, device=x.device) \
                    >= self.cfg.vocab_size
                logits = torch.where(pad, NEG, logits)
            else:
                logits[..., self.cfg.vocab_size:] = NEG
        return act_sharding.constrain_logits(logits)

    # -- encoder (whisper): bidirectional stack over stub frame embeddings ---

    def _encode(self, params: Params, frames: torch.Tensor,
                train: bool) -> torch.Tensor:
        """Sinusoidal positions added to ``frames`` (B, T, D), then the
        encoder's ``attn`` blocks with every position 0 (the causal bias
        never masks).  With ``train`` and grad enabled each block runs
        under activation checkpointing, as the JAX package remats its
        encoder scan."""
        cfg = self.cfg
        b, t, _ = frames.shape
        dev = frames.device
        pos = torch.arange(t, dtype=torch.float32, device=dev)[:, None]
        dim = torch.arange(cfg.d_model // 2, dtype=torch.float32,
                           device=dev)[None, :]
        ang = pos / torch.pow(10000.0, 2 * dim / cfg.d_model)
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        x = frames + pe[None].to(frames.dtype)
        ctx = Ctx(mode="train",
                  q_pos=torch.zeros((b, t), dtype=torch.int32, device=dev))

        def block(h, p):
            return block_apply(p, cfg, "attn", h, ctx, None)[0]

        remat = train and torch.is_grad_enabled()
        for p in params["encoder"]["blocks"]:
            x = (checkpoint(block, x, p, use_reentrant=False) if remat
                 else block(x, p))
        return rmsnorm(params["encoder"]["norm"], x, cfg.rms_eps)

    def _assemble(self, params: Params, inputs: Dict[str, Any],
                  train: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x (B,S,D), encoder output or None): a VLM's ``prefix`` goes
        before the token embeddings, an encoder-decoder's ``frames``
        through the encoder, both in the model's dtype."""
        cfg = self.cfg
        x = self._embed(params, inputs["tokens"])
        enc_out = None
        if cfg.family == "vlm" and "prefix" in inputs:
            x = torch.cat([inputs["prefix"].to(x.dtype), x], dim=1)
        if cfg.is_encoder_decoder:
            enc_out = self._encode(params, inputs["frames"].to(x.dtype),
                                   train)
        return x, enc_out

    # -- train ----------------------------------------------------------------

    def train_logits(self, params: Params, inputs: Dict[str, Any]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Causal logits over the whole of ``inputs["tokens"]`` (B, S) --
        after a VLM's prefix -- no cache, with the summed aux loss (float32
        scalar)."""
        x, enc_out = self._assemble(params, inputs, train=True)
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        x, aux = stack_apply(params["stack"], self.cfg, x,
                             Ctx(mode="train", q_pos=pos, enc_out=enc_out),
                             None)
        return self._head(params, x), torch.as_tensor(
            aux, dtype=torch.float32, device=x.device)

    def loss(self, params: Params, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch["tokens"]: (B, S+1); next-token prediction over it.
        labels < 0 are masked."""
        tokens = batch["tokens"]
        inputs = dict(batch)
        inputs["tokens"] = tokens[:, :-1]
        labels = tokens[:, 1:]
        logits, aux = self.train_logits(params, inputs)
        # prefix positions (a VLM's) predict nothing: trim to the text tail
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]
        nll = cross_entropy(logits, labels)
        return nll + aux, {"nll": nll, "aux": aux,
                           "ppl": torch.exp(torch.clamp(nll, max=20.0))}

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
        ``length``, so pad K/V sits beyond the valid frontier (full
        attention and MLA only: a ring or a recurrent state would take the
        pads in).  A VLM's prefix counts toward the positions; whisper's
        encoder K/V is written into the cache here."""
        x, enc_out = self._assemble(params, inputs)
        b, s, _ = x.shape
        pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        ctx = Ctx(mode="prefill", q_pos=pos, cache_len=cache["len"],
                  enc_out=enc_out)
        x, _ = stack_apply(params["stack"], self.cfg, x, ctx, cache)
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
        x, _ = stack_apply(params["stack"], self.cfg, x, ctx, cache)
        cache["len"] = ln + s
        return self._head(params, x), cache

    def rollback(self, cache, n_tokens: int):
        """Speculative rollback: rewind ``len`` (entries beyond len are
        masked by validity, so nothing is copied).  Recurrent state
        (Mamba1/Mamba2 ``conv``/``ssm``) and sliding-window rings cannot be
        rewound: the serving engine refeeds such caches from
        ``kvcache.snapshot_state`` taken before the verify forward
        instead."""
        out = dict(cache)
        out["len"] = cache["len"] - n_tokens
        return out

    # -- misc ------------------------------------------------------------------

    def example_batch(self, batch: int, seq: int, seed: int = 0,
                      device="cuda") -> Dict[str, torch.Tensor]:
        """A training batch of ``repro``'s ``example_batch`` shapes: tokens
        (B, seq + 1) drawn from ``seed`` -- a VLM's cut to leave room for
        its prefix -- and zero ``prefix`` / ``frames`` embeddings."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                                       generator=gen, dtype=torch.int64,
                                       device=dev)}
        dt = torch_dtype(cfg)
        if cfg.family == "vlm":
            p = cfg.n_prefix_tokens
            out["tokens"] = out["tokens"][:, :max(2, seq + 1 - p)]
            out["prefix"] = torch.zeros((batch, p, cfg.d_model), dtype=dt,
                                        device=dev)
        if cfg.is_encoder_decoder:
            out["frames"] = torch.zeros(
                (batch, cfg.encoder_seq_len, cfg.d_model), dtype=dt,
                device=dev)
        return out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 over the labels >= 0;
    ``logsumexp`` and a gather where the JAX package contracts a one-hot
    (the same sum)."""
    logits = logits.to(torch.float32)
    if isinstance(logits, DTensor):
        logz, gold = act_sharding.vocab_parallel_nll_terms(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(
            labels, min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def build_model(cfg: ModelConfig) -> Model:
    cfg.check()
    kvcache.check_ported(cfg)
    return Model(cfg)
