"""Public fused grammar-masked argmax: the port of
``repro.kernels.masked_sample.ops.masked_argmax``.

A CUDA tensor goes through the hand-written kernel, or the call raises;
only a tensor on the CPU takes the plain version (``ref.py``).  The packed
layout is ``int32`` words here (``uint32`` in the JAX package, which this
port reads bit for bit).  The byte-mask kernel and the device sampler
(``masked_sample_packed``) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.masked_sample.kernel import masked_argmax_packed
from repro_torch.kernels.masked_sample.ref import masked_argmax_ref


def masked_argmax(logits: torch.Tensor, mask: torch.Tensor):
    """logits (B, V); mask packed (B, ceil(V/32)) int32 (or, on the CPU
    only, a (B, V) bool/int8 mask) -> (idx (B,) int32, val (B,) float32)."""
    if logits.device.type == "cpu":
        return masked_argmax_ref(logits, mask)
    if mask.dtype != torch.int32:
        raise NotImplementedError(
            "masked_argmax on the card takes packed int32 words; the byte-"
            "mask kernel is not ported yet (ROADMAP Queue 2)")
    return masked_argmax_packed(logits, mask)
