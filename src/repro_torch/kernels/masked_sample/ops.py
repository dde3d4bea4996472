"""Public fused grammar-masked argmax: the port of
``repro.kernels.masked_sample.ops.masked_argmax``.

A CUDA tensor goes through a hand-written kernel, or the call raises: the
mask's dtype picks the layout, packed ``int32`` words (``uint32`` in the
JAX package, which this port reads bit for bit) or one bool/int8/uint8
byte a token.  Only a tensor on the CPU takes the plain version
(``ref.py``).  The device sampler (``masked_sample_packed``) is not ported
yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.masked_sample.kernel import (masked_argmax_bytes,
                                                      masked_argmax_packed)
from repro_torch.kernels.masked_sample.ref import masked_argmax_ref


def masked_argmax(logits: torch.Tensor, mask: torch.Tensor):
    """logits (B, V); mask packed (B, ceil(V/32)) int32 or (B, V)
    bool/int8/uint8 -> (idx (B,) int32, val (B,) float32)."""
    if logits.device.type == "cpu":
        return masked_argmax_ref(logits, mask)
    if mask.dtype == torch.int32:
        return masked_argmax_packed(logits, mask)
    return masked_argmax_bytes(logits, mask)
