"""Launch wrappers of the masked-argmax CUDA kernels
(``kernels/csrc/masked_argmax.cu``), the ports of the TPU kernels
``repro.kernels.masked_sample.kernel.masked_argmax_pallas_packed`` (packed
mask words, ``masked_argmax_packed``) and ``masked_argmax_pallas`` (one
mask byte a token, ``masked_argmax_bytes``).

Both split a row's vocabulary across blocks by ``ref.argmax_plan``; with
more than one split a row, the blocks leave their partial results in
scratch and the last block of a row merges them, found by an int32 counter
a row.  Counters and scratch are kept per (device, stream): the counters
are allocated zero and every launch leaves them zero again, so a call needs
no memset kernel of its own, and launches on one stream never overlap."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.masked_sample.ref import argmax_plan

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MASK_BYTE_DTYPES = (torch.bool, torch.int8, torch.uint8)
# (device index, stream) -> (int32 counters, int64 scratch of (value, index)
# pairs), grown on demand.  A launch that failed midway may leave a counter
# set, so the scheduler's engine reset drops them (``drop_scratch``) and the
# next launch allocates zeroed ones.
_SCRATCH: dict = {}


def drop_scratch() -> None:
    """Forget every stream's counters and pair scratch: the next launch
    allocates zeroed counters instead of trusting what a failed launch
    left."""
    _SCRATCH.clear()


def _check_logits(name, logits, mask):
    if logits.device.type != "cuda" or mask.device != logits.device:
        raise ValueError(f"{name}: logits and mask must be on one CUDA "
                         f"device, got {logits.device}/{mask.device}")
    if logits.dtype not in _DTYPES or logits.dim() != 2 \
            or logits.stride(1) != 1:
        raise ValueError(f"{name}: logits must be (B, V) float32, bfloat16 "
                         "or float16 with unit column stride, got "
                         f"{tuple(logits.shape)} {logits.dtype} "
                         f"strides {logits.stride()}")


def _scratch(dev, stream: int, b: int, n_split: int):
    """(counters, pair scratch) pointers for a launch on ``stream``: None,
    None for one split a row."""
    if n_split == 1:
        return None, None
    key = (dev.index, stream)
    counters, part = _SCRATCH.get(key, (None, None))
    if counters is None or counters.numel() < b:
        counters = torch.zeros((max(b, 1024),), dtype=torch.int32, device=dev)
    if part is None or part.numel() < b * n_split:
        part = torch.empty((max(b * n_split, 4096),), dtype=torch.int64,
                           device=dev)
    _SCRATCH[key] = (counters, part)
    return counters.data_ptr(), part.data_ptr()


def _launch(name, entry, logits, mask_ptr, mask_ld):
    b, v = logits.shape
    dev = logits.device
    idx = torch.empty((b,), dtype=torch.int32, device=dev)
    val = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return idx, val
    plan = argmax_plan(b, v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters, part = _scratch(dev, stream, b, plan.n_split)
    rc = getattr(build.library(), entry)(
        _DTYPES[logits.dtype], logits.data_ptr(), logits.stride(0), mask_ptr,
        mask_ld, b, v, plan.n_split, plan.split_len, part, counters,
        idx.data_ptr(), val.data_ptr(), stream)
    build.check(rc, name)
    return idx, val


def masked_argmax_packed(logits: torch.Tensor, bits: torch.Tensor):
    """logits (B, V) float32, bfloat16 or float16 on the card, unit column
    stride (the row stride may be wider than V and odd, e.g. a ``[:, :v]``
    view of padded logits); bits (B, ceil(V/32)) int32 contiguous -> (idx
    (B,) int32, val (B,) float32).  Reads nothing back to the host."""
    build.refuse_grad("masked_argmax_packed", logits)
    _check_logits("masked_argmax_packed", logits, bits)
    b, v = logits.shape
    n_words = -(-v // 32)
    if bits.dtype != torch.int32 or tuple(bits.shape) != (b, n_words) \
            or not bits.is_contiguous():
        raise ValueError(f"masked_argmax_packed: bits must be contiguous "
                         f"({b}, {n_words}) int32, got {tuple(bits.shape)} "
                         f"{bits.dtype}")
    out = _launch("masked_argmax_packed", "repro_masked_argmax_packed",
                  logits, bits.data_ptr(), n_words)
    if b:
        masked_argmax_packed.launches += 1
    return out


masked_argmax_packed.launches = 0


def masked_argmax_bytes(logits: torch.Tensor, mask: torch.Tensor):
    """logits (B, V) float32, bfloat16 or float16 on the card, unit column
    stride (the row stride may be wider than V); mask (B, V) bool/int8/uint8
    with unit column stride, nonzero = legal -> (idx (B,) int32, val (B,)
    float32).  Reads nothing back to the host."""
    build.refuse_grad("masked_argmax_bytes", logits)
    _check_logits("masked_argmax_bytes", logits, mask)
    b, v = logits.shape
    if mask.dtype not in MASK_BYTE_DTYPES or tuple(mask.shape) != (b, v) \
            or mask.stride(1) != 1:
        raise ValueError(f"masked_argmax_bytes: mask must be ({b}, {v}) "
                         "bool/int8/uint8 with unit column stride, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    out = _launch("masked_argmax_bytes", "repro_masked_argmax_bytes",
                  logits, mask.data_ptr(), mask.stride(0))
    if b:
        masked_argmax_bytes.launches += 1
    return out


masked_argmax_bytes.launches = 0
