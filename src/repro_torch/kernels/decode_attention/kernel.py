"""Launch wrappers of the decode-attention CUDA kernels
(``kernels/csrc/decode_attention.cu``), the port of the TPU kernel
``repro.kernels.decode_attention.kernel.decode_attention_pallas``: the
plain score (``decode_attention_cuda``) and the split score of absorbed
MLA (``decode_attention_split_cuda``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (MAX_SCORE_SPLITS,
                                                      key_split_plan,
                                                      lengths_vector,
                                                      split_score_plan)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_TILE = 16       # query rows of the window one plain-score block holds
MAX_HEAD_DIM = 128
MAX_LATENT = 512    # split score: latent width (Dk = Dv) the kernels take
MAX_SPLIT_DIM = 64  # split score: width of the second (rope) term
# (device index, stream) -> int32 counters of the plain-score kernel's split
# merge: allocated zero, and every launch leaves them zero again, so a call
# needs no memset kernel of its own.  One buffer a stream: launches on one
# stream never overlap.  A launch that failed midway may leave a counter
# set, so the scheduler's engine reset drops them (``drop_scratch``) and the
# next launch allocates zeroed ones.
_COUNTERS: dict = {}


def drop_scratch() -> None:
    """Forget every stream's merge counters: the next launch allocates
    zeroed ones instead of trusting what a failed launch left."""
    _COUNTERS.clear()


def _check_operands(name, q, *kv):
    """Same CUDA device and dtype (float32 or bfloat16), contiguous,
    16-byte aligned."""
    dev = q.device
    if dev.type != "cuda" or any(x.device != dev for x in kv):
        raise ValueError(f"{name}: operands must be on one CUDA device, got "
                         + "/".join(str(x.device) for x in (q,) + kv))
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype for x in kv):
        raise ValueError(f"{name}: operands must share float32 or bfloat16, "
                         "got " + "/".join(str(x.dtype) for x in (q,) + kv))
    for x in (q,) + kv:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             "16-byte aligned")


def _table(name, block_tables, k, b):
    """(page size, table width, table or None): contiguous rows read as one
    page of T keys a row."""
    if block_tables is None:
        if k.shape[0] != b:
            raise ValueError(f"{name}: contiguous k/v need one row per batch "
                             "row")
        return k.shape[1], 1, None
    if block_tables.device != k.device or block_tables.dtype != torch.int32 \
            or block_tables.dim() != 2 or block_tables.shape[0] != b \
            or not block_tables.is_contiguous():
        raise ValueError(f"{name}: block_tables must be a contiguous "
                         "(B, max_pages) int32 tensor on the card")
    return k.shape[1], block_tables.shape[1], block_tables


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths, scale=None,
                          block_tables=None) -> torch.Tensor:
    """q (B,S,G,Qh,Dk); k (B,T,G,Dk) / v (B,T,G,Dv), or with
    ``block_tables`` (B, max_pages) int32 pools (n_pages, ps, G, D);
    lengths () or (B,) -> (B,S,G,Qh,Dv) in q's dtype, on the card.

    The keys are split across blocks by ``key_split_plan``, from shapes
    alone, and the window's S * Qh query rows into tiles of ``ROW_TILE``;
    with more than one split the call allocates float32 scratch for the
    splits' partial states, and takes one int32 counter a (row, group, row
    tile) from ``_counters``.  It reads nothing back to the host."""
    build.refuse_grad("decode_attention_cuda", q, k, v)
    _check_operands("decode_attention_cuda", q, k, v)
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention_cuda: q (B,S,G,Qh,D) and k/v "
                         "(rows, T, G, D) expected")
    b, s_win, g, qh, dk = q.shape
    dv = v.shape[-1]
    if k.shape[2] != g or v.shape[2] != g or k.shape[:2] != v.shape[:2] \
            or k.shape[3] != dk:
        raise ValueError(f"decode_attention_cuda: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if dk % 8 or dv % 8 or dk > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(
            f"decode_attention_cuda: needs Dk % 8 == Dv % 8 == 0 and Dk, Dv "
            f"<= {MAX_HEAD_DIM}; got Dk={dk} Dv={dv}")
    page_size, n_tiles, tbl = _table("decode_attention_cuda", block_tables,
                                     k, b)
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    dev = q.device
    ln = lengths_vector(lengths, b, dev)
    out = torch.empty((b, s_win, g, qh, dv), dtype=q.dtype, device=dev)
    n_split, split_len = key_split_plan(b, g, page_size, n_tiles,
                                        tbl is not None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = counters = None
    if n_split > 1:
        part = torch.empty((n_split, b * g, s_win * qh, dv + 2),
                           dtype=torch.float32, device=dev)
        counters = _counters(dev, stream,
                             b * g * -(-(s_win * qh) // ROW_TILE))
    lib = build.library()
    rc = lib.repro_decode_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ln.data_ptr(), None if tbl is None else tbl.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), b, s_win, g, qh,
        dk, dv, page_size, n_tiles, n_split, split_len, float(scale), stream)
    build.check(rc, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def _counters(dev, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 counters for launches on ``stream``."""
    key = (dev.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def decode_attention_split_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, q2: torch.Tensor,
                                k2: torch.Tensor, lengths, scale=None,
                                block_tables=None) -> torch.Tensor:
    """Split-score decode attention of absorbed MLA: score =
    (q.k^T + q2.k2^T) * scale, values = k.

    q (B,S,G,Qh,R); q2 (B,S,G,Qh,D2); k (B,T,G,R) and k2 (B,T,G,D2), or
    with ``block_tables`` (B, max_pages) int32 pools (n_pages, ps, G, R)
    and (n_pages, ps, G, D2); ``v`` must be ``k`` (the latent is both key
    and value); lengths () or (B,) -> (B,S,G,Qh,R) in q's dtype.

    bfloat16 runs on the tensor cores with the keys split across blocks by
    ``split_score_plan``, from shapes alone: with more than one split the
    call allocates float32 scratch for the splits' partial states, which a
    second kernel merges.  float32 runs on the CUDA cores, unsplit.  It
    reads nothing back to the host."""
    name = "decode_attention_split_cuda"
    build.refuse_grad(name, q, k, v, q2, k2)
    _check_operands(name, q, k, q2, k2)
    if q.dim() != 5 or q2.dim() != 5 or k.dim() != 4 or k2.dim() != 4:
        raise ValueError(f"{name}: q/q2 (B,S,G,Qh,D) and k/k2 (rows, T, G, "
                         "D) expected")
    if v.data_ptr() != k.data_ptr() or v.shape != k.shape \
            or v.stride() != k.stride() or v.dtype != k.dtype:
        raise ValueError(f"{name}: the values must be the keys' own tensor "
                         "(absorbed MLA's latent)")
    b, s_win, g, qh, r = q.shape
    d2 = q2.shape[-1]
    if q2.shape[:4] != q.shape[:4] or k.shape[2] != g or k.shape[3] != r \
            or k2.shape[:3] != k.shape[:3] or k2.shape[3] != d2:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} q2 "
                         f"{tuple(q2.shape)} k {tuple(k.shape)} k2 "
                         f"{tuple(k2.shape)} disagree")
    if r % 8 or d2 % 8 or r > MAX_LATENT or d2 > MAX_SPLIT_DIM:
        raise ValueError(f"{name}: needs R % 8 == 0, D2 % 8 == 0, R <= "
                         f"{MAX_LATENT}, D2 <= {MAX_SPLIT_DIM}; got R={r} "
                         f"D2={d2}")
    page_size, n_tiles, tbl = _table(name, block_tables, k, b)
    if scale is None:
        scale = 1.0 / math.sqrt(r)
    dev = q.device
    ln = lengths_vector(lengths, b, dev)
    out = torch.empty((b, s_win, g, qh, r), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_split, split_len, part = 1, 1, None
    if q.dtype == torch.bfloat16:
        rows = s_win * qh
        n_split, split_len = split_score_plan(b, g, rows, page_size, n_tiles,
                                              tbl is not None)
        if n_split > MAX_SCORE_SPLITS:
            raise ValueError(f"{name}: {n_tiles} table entries of {page_size} "
                             f"keys need {n_split} key splits, more than "
                             f"{MAX_SCORE_SPLITS}")
        if n_split > 1:
            part = torch.empty((n_split, b * g, rows, r + 4),
                               dtype=torch.float32, device=dev)
    lib = build.library()
    rc = lib.repro_decode_attention_split(
        _DTYPES[q.dtype], q.data_ptr(), q2.data_ptr(), k.data_ptr(),
        k2.data_ptr(), ln.data_ptr(), None if tbl is None else tbl.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), b, s_win,
        g, qh, r, d2, page_size, n_tiles, n_split, split_len, float(scale),
        stream)
    build.check(rc, "decode_attention_split")
    decode_attention_split_cuda.launches += 1
    return out


decode_attention_split_cuda.launches = 0
