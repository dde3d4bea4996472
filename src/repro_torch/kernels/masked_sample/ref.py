"""Plain PyTorch version of the fused masked-argmax kernel.

Packed masks are ``(..., ceil(V/32))`` words in the ``core/bitmask`` layout
(bit b of word w, LSB first, is token 32w+b) carried as ``int32``: PyTorch
has no shift for ``uint32`` on the CPU, and ``(w >> b) & 1`` reads every bit
of an int32 word exactly, sign bit included.
"""
from __future__ import annotations

import torch

NEG = -1e30
WORD_BITS = 32


def unpack_bits(bits: torch.Tensor, v: int) -> torch.Tensor:
    """Packed ``(..., ceil(v/32))`` int32 words -> bool ``(..., v)``."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=bits.device)
    expanded = (bits.to(torch.int32)[..., :, None] >> shifts) & 1
    flat = expanded.reshape(bits.shape[:-1] + (bits.shape[-1] * WORD_BITS,))
    return flat[..., :v] != 0


def masked_argmax_ref(logits: torch.Tensor, mask: torch.Tensor):
    """logits (B, V); mask (B, V) bool/int8 or packed (B, ceil(V/32)) int32
    -> (idx (B,) int32, val (B,) float32).

    Masked entries become -1e30; ties go to the lowest index, so an
    all-illegal row gives idx 0 and val -1e30.
    """
    if mask.dtype == torch.int32:
        mask = unpack_bits(mask, logits.shape[-1])
    masked = torch.where(mask != 0, logits.to(torch.float32),
                         torch.tensor(NEG, dtype=torch.float32,
                                      device=logits.device))
    idx = torch.argmax(masked, dim=-1).to(torch.int32)
    val = torch.amax(masked, dim=-1)
    return idx, val
