"""Launch wrapper of the Mamba2 SSD scan CUDA kernel
(``kernels/csrc/ssd_scan.cu``), the port of the TPU kernel
``repro.kernels.ssd_scan.kernel.ssd_scan_pallas``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref

MAX_DIM = 128       # largest head dim D and state size N


def ssd_scan_cuda(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  ld: torch.Tensor, dt: torch.Tensor, h0: torch.Tensor):
    """x (B,S,H,D); b, c (B,S,N); ld, dt (B,S,H); h0 (B,H,D,N), all
    float32, contiguous, on one CUDA device -> (y (B,S,H,D), hT (B,H,D,N))
    float32.

    One launch, laid out by ``ref.ssd_plan`` from the shapes alone: S = 1
    takes the decode path, S > 1 the chunked path on the tensor cores (the
    kernel's own chunk length, whatever the caller's plain version would
    use).  It
    allocates nothing but the two outputs and reads nothing back to the
    host."""
    args = (("x", x), ("b", b), ("c", c), ("ld", ld), ("dt", dt),
            ("h0", h0))
    dev = x.device
    for name, t in args:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("ssd_scan_cuda: every operand must be on one "
                             f"CUDA device, got {name} on {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ssd_scan_cuda: {name} must be contiguous "
                             f"float32, got {t.dtype}")
    if x.dim() != 4 or b.dim() != 3:
        raise ValueError("ssd_scan_cuda: x (B,S,H,D) and b (B,S,N) expected")
    bsz, s, h, d = x.shape
    n = b.shape[-1]
    want = {"b": (bsz, s, n), "c": (bsz, s, n), "ld": (bsz, s, h),
            "dt": (bsz, s, h), "h0": (bsz, h, d, n)}
    for name, t in args[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    if not (1 <= d <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"ssd_scan_cuda: head dim {d} and state {n} must "
                         f"be in 1..{MAX_DIM}")
    y = torch.empty((bsz, s, h, d), dtype=torch.float32, device=dev)
    h_t = torch.empty((bsz, h, d, n), dtype=torch.float32, device=dev)
    if bsz == 0 or h == 0:
        return y, h_t
    plan = ref.ssd_plan(s, h, d, n)
    lib = build.library()
    rc = lib.repro_ssd_scan(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), ld.data_ptr(),
        dt.data_ptr(), h0.data_ptr(), y.data_ptr(), h_t.data_ptr(), bsz, s,
        h, d, n, plan.d_split,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "ssd_scan")
    ssd_scan_cuda.launches += 1
    return y, h_t


ssd_scan_cuda.launches = 0
