"""Public ragged flash-decode attention: the port of
``repro.kernels.decode_attention.ops.decode_attention`` (without the
absorbed-MLA split score, which is not ported yet).

A CUDA tensor goes through the hand-written kernel, or the call raises;
only a tensor on the CPU takes the plain version (``ref.py``).
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k, v, lengths, scale=None, block_tables=None):
    """q (B,S,G,Qh,Dk) -- or (B,G,Qh,Dk), read as S=1; k (B,T,G,Dk);
    v (B,T,G,Dv); lengths () or (B,) int32 -> matching q's rank.

    ``lengths`` counts the keys visible to the first window position;
    window position s of row b attends keys t < lengths[b] + s.  With
    ``block_tables`` (B, max_pages) int32, k/v are shared pools
    (n_pages, page_size, G, D) and row b's key t lives at pool row
    block_tables[b, t // page_size], offset t % page_size.
    """
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, scale=scale,
                                    block_tables=block_tables)
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, None]
    out = decode_attention_cuda(q, k, v, lengths, scale=scale,
                                block_tables=block_tables)
    return out[:, 0] if squeeze else out
