"""Public fused grammar-masked argmax: the port of
``repro.kernels.masked_sample.ops.masked_argmax``.

A CUDA tensor goes through a hand-written kernel, or the call raises: the
mask's dtype picks the layout, packed ``int32`` words (``uint32`` in the
JAX package, which this port reads bit for bit) or one bool/int8/uint8
byte a token.  Only a tensor on the CPU takes the plain version
(``ref.py``).

``masked_sample_packed`` is the device sampler of rows with a temperature
above 0: Gumbel-max over the packed legal set, a plain torch op (the JAX
package's is plain ``jnp`` too, not a Pallas kernel).  Its noise comes from
a counter-based hash of (request seed, draw index, token), so a row's draws
never depend on the batch it shares.  It matches the host ``select_token``
path in distribution only, as the JAX package's sampler does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.masked_sample.kernel import (masked_argmax_bytes,
                                                      masked_argmax_packed)
from repro_torch.kernels.masked_sample.ref import (NEG, masked_argmax_ref,
                                                   unpack_bits)

_M32 = 0xFFFFFFFF


def masked_argmax(logits: torch.Tensor, mask: torch.Tensor):
    """logits (B, V); mask packed (B, ceil(V/32)) int32 or (B, V)
    bool/int8/uint8 -> (idx (B,) int32, val (B,) float32)."""
    if logits.device.type == "cpu":
        return masked_argmax_ref(logits, mask)
    if mask.dtype == torch.int32:
        return masked_argmax_packed(logits, mask)
    return masked_argmax_bytes(logits, mask)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply rounds) of int64 values in
    [0, 2**32); each product stays below 2**63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def gumbel_noise(keys: torch.Tensor, v: int) -> torch.Tensor:
    """(B, V) float32 standard Gumbel noise, a pure function of each row's
    key (seed, draw index) and the token index: counter-based, so no
    generator state is shared between rows or calls."""
    k = keys.to(torch.int64) & _M32
    row = _mix32(_mix32(k[:, 0] ^ 0x9E3779B9) ^ k[:, 1])[:, None]
    tok = torch.arange(v, dtype=torch.int64, device=keys.device)[None, :]
    h = _mix32(_mix32(row ^ tok) ^ 0x85EBCA6B)
    # 24 bits -> a float32 uniform strictly inside (0, 1)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def masked_sample_packed(logits: torch.Tensor, bits: torch.Tensor,
                         temps: torch.Tensor,
                         keys: torch.Tensor) -> torch.Tensor:
    """Masked softmax sampling over packed masks on the logits' device.

    ``logits`` (B, V); ``bits`` (B, ceil(V/32)) int32 packed words;
    ``temps`` (B,) float32 per-row temperature (a row with t <= 0 gets the
    masked argmax: noise over ``logits/1e-6`` cannot flip a strict
    maximum); ``keys`` (B, 2) int64, each row's (seed, draw index).
    Returns (B,) int32 token ids: ``argmax(logits/T + G)`` over the legal
    set, which samples ``softmax(logits/T)`` restricted to it."""
    b, v = logits.shape
    legal = unpack_bits(bits, v)
    scaled = logits.to(torch.float32) \
        / torch.clamp(temps.to(torch.float32), min=1e-6)[:, None]
    score = torch.where(legal, scaled + gumbel_noise(keys, v), NEG)
    return torch.argmax(score, dim=-1).to(torch.int32)
