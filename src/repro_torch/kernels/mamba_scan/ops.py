"""Public Mamba1 selective scan: the port of
``repro.kernels.mamba_scan.ops.mamba_scan``.

A CUDA tensor goes through the hand-written kernel, or the call raises;
only a tensor on the CPU takes the plain version (``ref.py``).
"""
from __future__ import annotations

from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref


def mamba_scan(dt, x, bmat, cmat, a, h0):
    """dt/x (B,S,d); bmat/cmat (B,S,N); a (d,N); h0 (B,d,N) float32
    -> (y (B,S,d), hT (B,d,N)) float32."""
    if dt.device.type == "cpu":
        return mamba_scan_ref(dt, x, bmat, cmat, a, h0)
    return mamba_scan_cuda(dt, x, bmat, cmat, a, h0)
