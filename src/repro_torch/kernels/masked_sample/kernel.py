"""Launch wrappers of the masked-argmax CUDA kernels
(``kernels/csrc/masked_argmax.cu``), the ports of the TPU kernels
``repro.kernels.masked_sample.kernel.masked_argmax_pallas_packed`` (packed
mask words, ``masked_argmax_packed``) and ``masked_argmax_pallas`` (one
mask byte a token, ``masked_argmax_bytes``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def masked_argmax_packed(logits: torch.Tensor, bits: torch.Tensor):
    """logits (B, V) float32 on the card, unit column stride (the row stride
    may be wider than V, e.g. a ``[:, :v]`` view of padded logits); bits
    (B, ceil(V/32)) int32 contiguous -> (idx (B,) int32, val (B,) float32).
    """
    if logits.device.type != "cuda" or bits.device != logits.device:
        raise ValueError("masked_argmax_packed: logits and bits must be on "
                         f"one CUDA device, got {logits.device}/{bits.device}")
    if logits.dtype != torch.float32 or logits.dim() != 2 \
            or logits.stride(1) != 1:
        raise ValueError("masked_argmax_packed: logits must be (B, V) "
                         "float32 with unit column stride, got "
                         f"{tuple(logits.shape)} {logits.dtype} "
                         f"strides {logits.stride()}")
    b, v = logits.shape
    n_words = -(-v // 32)
    if bits.dtype != torch.int32 or tuple(bits.shape) != (b, n_words) \
            or not bits.is_contiguous():
        raise ValueError(f"masked_argmax_packed: bits must be contiguous "
                         f"({b}, {n_words}) int32, got {tuple(bits.shape)} "
                         f"{bits.dtype}")
    idx = torch.empty((b,), dtype=torch.int32, device=logits.device)
    val = torch.empty((b,), dtype=torch.float32, device=logits.device)
    if b == 0:
        return idx, val
    lib = build.library()
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    rc = lib.repro_masked_argmax_packed(
        logits.data_ptr(), logits.stride(0), bits.data_ptr(), n_words, b, v,
        idx.data_ptr(), val.data_ptr(), stream)
    build.check(rc, "masked_argmax_packed")
    masked_argmax_packed.launches += 1
    return idx, val


masked_argmax_packed.launches = 0


MASK_BYTE_DTYPES = (torch.bool, torch.int8, torch.uint8)


def masked_argmax_bytes(logits: torch.Tensor, mask: torch.Tensor):
    """logits (B, V) float32 on the card, unit column stride (the row stride
    may be wider than V); mask (B, V) bool/int8/uint8 with unit column
    stride, nonzero = legal -> (idx (B,) int32, val (B,) float32)."""
    if logits.device.type != "cuda" or mask.device != logits.device:
        raise ValueError("masked_argmax_bytes: logits and mask must be on "
                         f"one CUDA device, got {logits.device}/{mask.device}")
    if logits.dtype != torch.float32 or logits.dim() != 2 \
            or logits.stride(1) != 1:
        raise ValueError("masked_argmax_bytes: logits must be (B, V) "
                         "float32 with unit column stride, got "
                         f"{tuple(logits.shape)} {logits.dtype} "
                         f"strides {logits.stride()}")
    b, v = logits.shape
    if mask.dtype not in MASK_BYTE_DTYPES or tuple(mask.shape) != (b, v) \
            or mask.stride(1) != 1:
        raise ValueError(f"masked_argmax_bytes: mask must be ({b}, {v}) "
                         "bool/int8/uint8 with unit column stride, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    idx = torch.empty((b,), dtype=torch.int32, device=logits.device)
    val = torch.empty((b,), dtype=torch.float32, device=logits.device)
    if b == 0:
        return idx, val
    lib = build.library()
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    rc = lib.repro_masked_argmax_bytes(
        logits.data_ptr(), logits.stride(0), mask.data_ptr(), mask.stride(0),
        b, v, idx.data_ptr(), val.data_ptr(), stream)
    build.check(rc, "masked_argmax_bytes")
    masked_argmax_bytes.launches += 1
    return idx, val


masked_argmax_bytes.launches = 0
