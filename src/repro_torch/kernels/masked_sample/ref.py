"""Plain PyTorch version of the fused masked-argmax kernel, the plan that
splits a row's vocabulary across the kernel's blocks, and an emulation of
that split and its merge for the tests.

Packed masks are ``(..., ceil(V/32))`` words in the ``core/bitmask`` layout
(bit b of word w, LSB first, is token 32w+b) carried as ``int32``: PyTorch
has no shift for ``uint32`` on the CPU, and ``(w >> b) & 1`` reads every bit
of an int32 word exactly, sign bit included.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1e30
WORD_BITS = 32
SMS = 132              # the H100's streaming multiprocessors
BLOCKS_PER_SM = 2      # blocks the plan aims for, across all rows
ONE_BLOCK_V = 4096     # at or below: one block a row, no merge
MIN_SPLIT = 1024       # tokens a block, at least (where there is a split)
MAX_SPLIT = 32768      # and at most


class ArgmaxPlan(NamedTuple):
    n_split: int       # blocks a row
    split_len: int     # tokens a block: a multiple of 32, the last one short


def argmax_plan(b: int, v: int) -> ArgmaxPlan:
    """How the kernel splits a (b, v) call, from the shapes alone: one block
    a row at ``v <= ONE_BLOCK_V``; else about ``BLOCKS_PER_SM * SMS`` blocks
    over all rows, each of ``MIN_SPLIT`` to ``MAX_SPLIT`` tokens, split
    edges on multiples of 32 tokens (one mask word)."""
    def up32(n):
        return -(-n // WORD_BITS) * WORD_BITS
    if v <= ONE_BLOCK_V:
        return ArgmaxPlan(1, max(up32(v), WORD_BITS))
    want = -(-BLOCKS_PER_SM * SMS // max(b, 1))
    split_len = min(max(up32(-(-v // want)), MIN_SPLIT), MAX_SPLIT)
    return ArgmaxPlan(-(-v // split_len), split_len)


def unpack_bits(bits: torch.Tensor, v: int) -> torch.Tensor:
    """Packed ``(..., ceil(v/32))`` int32 words -> bool ``(..., v)``."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=bits.device)
    expanded = (bits.to(torch.int32)[..., :, None] >> shifts) & 1
    flat = expanded.reshape(bits.shape[:-1] + (bits.shape[-1] * WORD_BITS,))
    return flat[..., :v] != 0


def _masked(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """float32 logits with illegal tokens at -1e30."""
    if mask.dtype == torch.int32:
        mask = unpack_bits(mask, logits.shape[-1])
    return torch.where(mask != 0, logits.to(torch.float32),
                       torch.tensor(NEG, dtype=torch.float32,
                                    device=logits.device))


def masked_argmax_ref(logits: torch.Tensor, mask: torch.Tensor):
    """logits (B, V) float32, bfloat16 or float16; mask (B, V) bool/int8 or
    packed (B, ceil(V/32)) int32 -> (idx (B,) int32, val (B,) float32).

    The logits are widened to float32, masked entries become -1e30; ties go
    to the lowest index, so an all-illegal row gives idx 0 and val -1e30.
    """
    masked = _masked(logits, mask)
    idx = torch.argmax(masked, dim=-1).to(torch.int32)
    val = torch.amax(masked, dim=-1)
    return idx, val


def masked_argmax_split(logits: torch.Tensor, mask: torch.Tensor,
                        plan: ArgmaxPlan):
    """The kernel's split and merge on finite logits, for the tests: each
    of the plan's splits reduces its tokens to one (value, index) pair, and
    the row's pairs are merged in split order, a pair taking over only if
    its value is larger or equal at a lower index -- the kernel's total
    order.  Same arguments and results as ``masked_argmax_ref``."""
    masked = _masked(logits, mask)
    b, v = masked.shape
    best_v = torch.full((b,), float("-inf"), dtype=torch.float32,
                        device=masked.device)
    best_i = torch.full((b,), 2 ** 31 - 1, dtype=torch.int32,
                        device=masked.device)
    for s in range(plan.n_split):
        part = masked[:, s * plan.split_len:(s + 1) * plan.split_len]
        if part.shape[1] == 0:
            continue
        i = torch.argmax(part, dim=-1).to(torch.int32) + s * plan.split_len
        val = torch.amax(part, dim=-1)
        take = (val > best_v) | ((val == best_v) & (i < best_i))
        best_v = torch.where(take, val, best_v)
        best_i = torch.where(take, i, best_i)
    return best_i, best_v
