"""Plain PyTorch version of the ragged, paged decode-attention kernel, and
of its key-split algorithm: the host's choice of the split
(``key_split_plan`` for the plain score, ``split_score_plan`` for the
split score of absorbed MLA), the per-split partial states
(``key_split_partials``, either score) and their merge
(``merge_key_splits``)."""
from __future__ import annotations

import math

import torch

NEG = -1e30
TILE_KEYS = 64          # keys the plain-score kernel stages a step
SPLIT_BLOCKS = 528      # blocks a call aims for: 4 on each of an H100's 132 SMs
MAX_SPLIT_PAGES = 128   # table entries one split may span (held in shared memory)
# the split-score (absorbed-MLA) kernel in bfloat16
SCORE_TILE_KEYS = 32    # keys it stages a step
SCORE_ROWS = 32         # query rows a block holds (two tensor-core tiles)
SCORE_BLOCKS = 132      # blocks a call may fill: one an SM of an H100
MAX_SCORE_SPLITS = 64   # key splits a call may take (their (m, l) in smem)
MAX_SCORE_SPLIT_PAGES = 512   # table entries one split may span


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


def key_split_plan(b: int, g: int, page_size: int, n_tiles: int,
                   paged: bool) -> tuple:
    """(n_split, split_len): how the plain-score kernel splits a row's key
    capacity ``n_tiles * page_size`` (contiguous: T, one page) across
    blocks, from shapes alone -- never from the lengths, so choosing it
    reads nothing back from the card.  Aims for ``SPLIT_BLOCKS`` blocks over
    the ``b * g`` (row, group) pairs; a split is a whole number of
    ``TILE_KEYS`` tiles, and in paged mode spans at most ``MAX_SPLIT_PAGES``
    table entries."""
    cap = max(1, page_size * n_tiles)
    tiles = -(-cap // TILE_KEYS)
    n_split = min(max(1, -(-SPLIT_BLOCKS // max(1, b * g))), tiles)
    split_len = -(-tiles // n_split) * TILE_KEYS
    if paged:
        # pages a window of split_len keys can span: (split_len-1)//ps + 2
        split_len = min(split_len, max(
            TILE_KEYS,
            (MAX_SPLIT_PAGES - 1) * page_size // TILE_KEYS * TILE_KEYS))
    return -(-cap // split_len), split_len


def split_score_plan(b: int, g: int, rows: int, page_size: int,
                     n_tiles: int, paged: bool) -> tuple:
    """(n_split, split_len): how the bfloat16 split-score kernel splits a
    row's key capacity ``n_tiles * page_size`` across blocks, from shapes
    alone (the batch, the groups, the ``rows = S * Qh`` query rows of a
    window and the capacity), never from the lengths.  A block holds
    ``SCORE_ROWS`` query rows, so a call has ``b * g * ceil(rows /
    SCORE_ROWS)`` blocks a split; the split count is the most that keeps
    them within ``SCORE_BLOCKS`` (one wave: a part-filled second wave of
    whole splits would double the time), at least 1 and at most
    ``MAX_SCORE_SPLITS``.  Each split's partial state is a (rows, R + 4)
    float32 block of scratch, so fewer rows a block would mean more splits
    and more scratch.  A split is a whole number of ``SCORE_TILE_KEYS``
    tiles, and in paged mode spans at most ``MAX_SCORE_SPLIT_PAGES`` table
    entries."""
    cap = max(1, page_size * n_tiles)
    tiles = -(-cap // SCORE_TILE_KEYS)
    blocks = b * g * -(-rows // SCORE_ROWS)
    n_split = min(max(1, SCORE_BLOCKS // max(1, blocks)), tiles,
                  MAX_SCORE_SPLITS)
    split_len = -(-tiles // n_split) * SCORE_TILE_KEYS
    if paged:
        split_len = min(split_len, max(
            SCORE_TILE_KEYS, (MAX_SCORE_SPLIT_PAGES - 1) * page_size
            // SCORE_TILE_KEYS * SCORE_TILE_KEYS))
    return -(-cap // split_len), split_len


def key_split_partials(q, k, v, lengths, n_split: int, split_len: int,
                       scale=None, block_tables=None, q2=None, k2=None):
    """The kernel's first pass in plain PyTorch: for each split j, the
    online-softmax state of every query row over keys [j * split_len,
    (j + 1) * split_len) below the row's frontier.  With ``q2``/``k2`` the
    score is the split score (q.k^T + q2.k2^T) * scale, as
    ``decode_attention_ref`` takes it.

    q (B,S,G,Qh,Dk); k/v as ``decode_attention_ref`` takes them ->
    (m, l, acc) in float32: m and l (n_split,B,S,G,Qh), acc
    (n_split,B,S,G,Qh,Dv); m is the split's largest score (NEG where the
    row sees no key of the split), l the sum of exp(score - m) and acc the
    unnormalised exp(score - m) @ v.  A split that holds no visible key
    gives the empty state (NEG, 0, 0)."""
    if block_tables is not None:
        k = gather_pages(k, block_tables)
        v = gather_pages(v, block_tables)
        k2 = None if k2 is None else gather_pages(k2, block_tables)
    b, s_win, g, qh, dk = q.shape
    t = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    ln = lengths_vector(lengths, b, q.device)
    limit = ln[:, None] + torch.arange(s_win, dtype=torch.int32,
                                       device=q.device)            # (B,S)
    ms, ls, accs = [], [], []
    for j in range(n_split):
        lo, hi = j * split_len, min((j + 1) * split_len, t)
        pos = torch.arange(lo, max(lo, hi), device=q.device)
        sc = torch.einsum("bsgqd,btgd->bsgqt", q.float(), k[:, lo:hi].float())
        if q2 is not None:
            sc = sc + torch.einsum("bsgqd,btgd->bsgqt", q2.float(),
                                   k2[:, lo:hi].float())
        sc = sc * scale
        vmask = (pos[None, None, :] < limit[:, :, None])[:, :, None, None]
        sc = torch.where(vmask, sc, torch.full_like(sc, NEG))
        m = sc.amax(dim=-1) if hi > lo else torch.full(
            (b, s_win, g, qh), NEG, device=q.device)
        p = torch.where(vmask, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bsgqt,btgd->bsgqd", p, v[:, lo:hi].float()))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_key_splits(m, l, acc, dtype):
    """The kernel's merge: each split's state rescaled by exp(m_j - m) to
    the rows' largest score m, summed in split order, and normalised;
    rows that see no key give exactly 0."""
    top = m.amax(dim=0)
    w = torch.exp(m - top)
    den = (l * w).sum(dim=0)
    num = (acc * w[..., None]).sum(dim=0)
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(dtype)
