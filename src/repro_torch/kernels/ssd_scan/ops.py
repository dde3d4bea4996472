"""Public Mamba2 SSD scan: the port of
``repro.kernels.ssd_scan.ops.ssd_scan``.

A CUDA tensor goes through the hand-written kernel, or the call raises;
only a tensor on the CPU takes the plain version (``ref.py``), which is
chunked by ``chunk`` as the JAX package's is.  The kernel chooses its own
chunk and ignores ``chunk``.
"""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref


def ssd_scan(x, b, c, ld, dt, h0, chunk: int = 64):
    """x (B,S,H,D); b, c (B,S,N); ld, dt (B,S,H); h0 (B,H,D,N) float32
    -> (y (B,S,H,D), hT (B,H,D,N)) float32."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, b, c, ld, dt, h0, chunk=chunk)
    return ssd_scan_cuda(x, b, c, ld, dt, h0)
