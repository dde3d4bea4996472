"""Launch wrapper of the Mamba1 selective-scan CUDA kernel
(``kernels/csrc/mamba_scan.cu``), the port of the TPU kernel
``repro.kernels.mamba_scan.kernel.mamba_scan_pallas``."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan.ref import scan_plan

MAX_STATE = 64      # N the kernel takes: 16 lanes of 4 states


def mamba_scan_cuda(dt: torch.Tensor, x: torch.Tensor, bmat: torch.Tensor,
                    cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor):
    """dt/x (B,S,d); bmat/cmat (B,S,N); a (d,N); h0 (B,d,N), all float32,
    contiguous, on one CUDA device -> (y (B,S,d), hT (B,d,N)) float32.

    One launch, laid out by ``scan_plan`` from the shapes alone; it
    allocates nothing but the two outputs and reads nothing back to the
    host, so a CUDA graph can capture it."""
    args = (("dt", dt), ("x", x), ("bmat", bmat), ("cmat", cmat), ("a", a),
            ("h0", h0))
    dev = dt.device
    for name, t in args:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("mamba_scan_cuda: every operand must be on one "
                             f"CUDA device, got {name} on {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"mamba_scan_cuda: {name} must be contiguous "
                             f"float32, got {t.dtype}")
    if dt.dim() != 3 or a.dim() != 2:
        raise ValueError("mamba_scan_cuda: dt (B,S,d) and a (d,N) expected")
    b, s, d = dt.shape
    n = a.shape[1]
    want = {"x": (b, s, d), "bmat": (b, s, n), "cmat": (b, s, n),
            "a": (d, n), "h0": (b, d, n)}
    for name, t in args[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"mamba_scan_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"mamba_scan_cuda: d_state {n} not in "
                         f"1..{MAX_STATE}")
    y = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    h_t = torch.empty((b, d, n), dtype=torch.float32, device=dev)
    if b == 0 or d == 0:
        return y, h_t
    lanes, chans, tile = scan_plan(s, d, n)
    lib = build.library()
    rc = lib.repro_mamba_scan(
        dt.data_ptr(), x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_t.data_ptr(), b, s, d,
        n, lanes, chans, tile, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "mamba_scan")
    mamba_scan_cuda.launches += 1
    return y, h_t


mamba_scan_cuda.launches = 0
