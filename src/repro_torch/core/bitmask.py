"""Packed ``uint32`` token-mask bitsets (the mask-pipeline wire format).

A vocabulary mask is ``ceil(V/32)`` little words: bit ``b`` of word ``w``
(LSB first) is token ``w*32 + b``.  The same layout is consumed, unchanged,
by every stage of the pipeline:

 - tree build packs each node's token-id lists into per-node segments
   (``core/trees.py``), so mask assembly is a vectorized ``bitwise_or``
   over visited nodes instead of per-token fancy-index scatters;
 - the scheduler stages per-slot rows into a persistent ``(B, W)`` uint32
   buffer and ships THAT to the device — V/8 bytes per row instead of the
   V int8 bytes of the old dense staging array;
 - the fused sampling kernel (``kernels/masked_sample``) loads the words
   and unpacks them in-register, fused with the running argmax.

Packing is arithmetic (shift + sum), not ``np.packbits``-with-a-view, so
the layout is endianness-independent and matches the kernel's
``(word >> (lane % 32)) & 1`` unpack exactly.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

WORD_BITS = 32
_SHIFTS = np.arange(WORD_BITS, dtype=np.uint32)


def n_words(v: int) -> int:
    """Words per packed mask row for a vocabulary of ``v`` tokens."""
    return (v + WORD_BITS - 1) // WORD_BITS


def pack_bool(mask: np.ndarray) -> np.ndarray:
    """Bool/int (..., V) mask -> packed (..., ceil(V/32)) uint32.

    Bits past V in the final word are 0 (required by the kernel's tail
    tile contract).
    """
    mask = np.asarray(mask)
    v = mask.shape[-1]
    w = n_words(v)
    padded = np.zeros(mask.shape[:-1] + (w * WORD_BITS,), np.uint32)
    padded[..., :v] = mask.astype(bool)
    grouped = padded.reshape(mask.shape[:-1] + (w, WORD_BITS))
    return (grouped << _SHIFTS).sum(axis=-1, dtype=np.uint32)


def pack_ids(ids: Iterable[int], v: int) -> np.ndarray:
    """Token-id list -> packed (ceil(V/32),) uint32 segment."""
    out = np.zeros(n_words(v), np.uint32)
    ids = np.asarray(list(ids), np.int64)
    if ids.size:
        # bitwise_or.at: duplicate words in the index must accumulate
        np.bitwise_or.at(out, ids >> 5,
                         np.uint32(1) << (ids & 31).astype(np.uint32))
    return out


def set_bit(words: np.ndarray, tok: int) -> None:
    """Set one token's bit in a packed row, in place."""
    words[tok >> 5] |= np.uint32(1) << np.uint32(tok & 31)


def get_bit(words: np.ndarray, tok: int) -> bool:
    """Test one token's bit in a packed row."""
    return bool((words[tok >> 5] >> np.uint32(tok & 31)) & np.uint32(1))


def to_ids(words: np.ndarray, v: int) -> np.ndarray:
    """Packed (W,) uint32 row -> ascending token ids of the set bits.

    Only nonzero words are expanded, so sparse masks (the common grammar
    case) cost O(set words * 32), not O(V).
    """
    idx = np.nonzero(words)[0]
    if idx.size == 0:
        return np.empty(0, np.int64)
    bits = (words[idx, None] >> _SHIFTS) & np.uint32(1)
    r, c = np.nonzero(bits)            # row-major: ascending token order
    ids = (idx[r].astype(np.int64) << 5) + c
    return ids[ids < v]


def unpack(words: np.ndarray, v: int) -> np.ndarray:
    """Packed (..., W) uint32 -> bool (..., v)."""
    words = np.asarray(words, np.uint32)
    bits = (words[..., :, None] >> _SHIFTS) & np.uint32(1)
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD_BITS,))
    return flat[..., :v].astype(bool)
