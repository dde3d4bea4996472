"""Public ragged flash-decode attention: the port of
``repro.kernels.decode_attention.ops.decode_attention``.

A CUDA tensor goes through a hand-written kernel, or the call raises: the
plain-score kernel, or with ``q2``/``k2`` the split-score kernel of
absorbed MLA.  Only a tensor on the CPU takes the plain version
(``ref.py``).
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import (
    decode_attention_cuda, decode_attention_split_cuda)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k, v, lengths, scale=None, q2=None, k2=None,
                     block_tables=None):
    """q (B,S,G,Qh,Dk) -- or (B,G,Qh,Dk), read as S=1; k (B,T,G,Dk);
    v (B,T,G,Dv); lengths () or (B,) int32 -> matching q's rank.

    ``lengths`` counts the keys visible to the first window position;
    window position s of row b attends keys t < lengths[b] + s.  Optional
    (q2, k2) adds a second score term (absorbed-MLA latent + rope split):
    score = (q.k^T + q2.k2^T) * scale; on the card that call takes the
    values from ``k`` itself (``v`` must be ``k``, as absorbed MLA passes
    it).  With ``block_tables`` (B, max_pages) int32, k/v (and k2) are
    shared pools (n_pages, page_size, G, D) and row b's key t lives at pool
    row block_tables[b, t // page_size], offset t % page_size.
    """
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, lengths, scale=scale, q2=q2,
                                    k2=k2, block_tables=block_tables)
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, None]
        q2 = None if q2 is None else q2[:, None]
    if q2 is None:
        out = decode_attention_cuda(q, k, v, lengths, scale=scale,
                                    block_tables=block_tables)
    else:
        out = decode_attention_split_cuda(q, k, v, q2, k2, lengths,
                                          scale=scale,
                                          block_tables=block_tables)
    return out[:, 0] if squeeze else out
