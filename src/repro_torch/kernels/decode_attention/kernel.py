"""Launch wrapper of the decode-attention CUDA kernel
(``kernels/csrc/decode_attention.cu``), the port of the TPU kernel
``repro.kernels.decode_attention.kernel.decode_attention_pallas``."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import lengths_vector

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 16       # S * Qh query rows one block holds
MAX_HEAD_DIM = 128


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths, scale=None,
                          block_tables=None) -> torch.Tensor:
    """q (B,S,G,Qh,Dk); k (B,T,G,Dk) / v (B,T,G,Dv), or with
    ``block_tables`` (B, max_pages) int32 pools (n_pages, ps, G, D);
    lengths () or (B,) -> (B,S,G,Qh,Dv) in q's dtype, on the card."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("decode_attention_cuda: q, k, v must be on one CUDA "
                         f"device, got {q.device}/{k.device}/{v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("decode_attention_cuda: q, k, v must share float32 "
                         f"or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention_cuda: q (B,S,G,Qh,D) and k/v "
                         "(rows, T, G, D) expected")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode_attention_cuda: {name} must be "
                             "contiguous and 16-byte aligned")
    b, s_win, g, qh, dk = q.shape
    dv = v.shape[-1]
    if k.shape[2] != g or v.shape[2] != g or k.shape[:2] != v.shape[:2] \
            or k.shape[3] != dk:
        raise ValueError(f"decode_attention_cuda: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if dk % 8 or dk > MAX_HEAD_DIM or dv > MAX_HEAD_DIM \
            or s_win * qh > MAX_ROWS:
        raise ValueError(
            f"decode_attention_cuda: needs Dk % 8 == 0, Dk, Dv <= "
            f"{MAX_HEAD_DIM} and S*Qh <= {MAX_ROWS}; got Dk={dk} Dv={dv} "
            f"S*Qh={s_win * qh}")
    if block_tables is None:
        if k.shape[0] != b:
            raise ValueError("decode_attention_cuda: contiguous k/v need one "
                             "row per batch row")
        page_size, n_tiles, tbl = k.shape[1], 1, None
    else:
        if block_tables.device != dev or block_tables.dtype != torch.int32 \
                or block_tables.dim() != 2 or block_tables.shape[0] != b \
                or not block_tables.is_contiguous():
            raise ValueError("decode_attention_cuda: block_tables must be a "
                             "contiguous (B, max_pages) int32 tensor on the "
                             "card")
        page_size, n_tiles, tbl = k.shape[1], block_tables.shape[1], \
            block_tables
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    ln = lengths_vector(lengths, b, dev)
    out = torch.empty((b, s_win, g, qh, dv), dtype=q.dtype, device=dev)
    lib = build.library()
    rc = lib.repro_decode_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ln.data_ptr(), None if tbl is None else tbl.data_ptr(),
        out.data_ptr(), b, s_win, g, qh, dk, dv, page_size, n_tiles,
        float(scale), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
