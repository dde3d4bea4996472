"""Plain PyTorch version of the ragged, paged decode-attention kernel."""
from __future__ import annotations

import math

import torch

NEG = -1e30


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Materialize a paged pool as its dense per-row equivalent.

    pool (n_pages, page_size, ...) + block_tables (B, max_pages) ->
    (B, max_pages * page_size, ...).  Vacant (< 0) table entries go to pool
    row 0 (the trash page); the positions they cover are beyond the owning
    row's frontier, so the validity mask hides whatever they hold.
    """
    g = pool[torch.clamp(block_tables.long(), min=0)]   # (B, MP, ps, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def lengths_vector(lengths, b: int, device) -> torch.Tensor:
    """A scalar or (B,) length as a contiguous (B,) int32 tensor."""
    ln = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return ln.reshape(-1).expand(b).contiguous()


def decode_attention_ref(q, k, v, lengths, scale=None, q2=None, k2=None,
                         block_tables=None):
    """q (B,S,G,Qh,Dk) -- or (B,G,Qh,Dk), read as S=1; k (B,T,G,Dk);
    v (B,T,G,Dv); lengths () or (B,) int32 -> (B,S,G,Qh,Dv) in q's dtype.

    Window position s of row b attends keys t < lengths[b] + s.  Rows with
    no visible key give zeros.  Optional split score (q2 (B,S,G,Qh,D2),
    k2 (B,T,G,D2)): score = (q.k^T + q2.k2^T) * scale, the absorbed-MLA
    latent + rope decomposition.  With ``block_tables`` (B, max_pages),
    k/v (and k2) are pools (n_pages, page_size, G, D) gathered into the
    dense stripe each row's table stands for.
    """
    if block_tables is not None:
        k = gather_pages(k, block_tables)
        v = gather_pages(v, block_tables)
        k2 = None if k2 is None else gather_pages(k2, block_tables)
    squeeze = q.dim() == 4
    if squeeze:
        q = q[:, None]
        q2 = None if q2 is None else q2[:, None]
    b, s_win, g, qh, dk = q.shape
    t = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    ln = lengths_vector(lengths, b, q.device)
    s = torch.einsum("bsgqd,btgd->bsgqt", q.float(), k.float())
    if q2 is not None:
        s = s + torch.einsum("bsgqd,btgd->bsgqt", q2.float(), k2.float())
    s = s * scale
    limit = ln[:, None] + torch.arange(s_win, dtype=torch.int32,
                                       device=q.device)            # (B,S)
    valid = torch.arange(t, device=q.device)[None, None, :] \
        < limit[:, :, None]                                          # (B,S,T)
    vmask = valid[:, :, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, NEG))
    p = torch.where(vmask, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros_like(s))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bsgqt,btgd->bsgqd", p, v.float()).to(q.dtype)
    return out[:, 0] if squeeze else out
