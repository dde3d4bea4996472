"""Plain PyTorch version of the Mamba1 selective-scan kernel: the direct
recurrence, a loop over the sequence (``repro``'s ``mamba_scan_ref``)."""
from __future__ import annotations

import torch


def mamba_scan_ref(dt, x, bmat, cmat, a, h0):
    """dt/x (B,S,d); bmat/cmat (B,S,N); a (d,N); h0 (B,d,N)
    -> (y (B,S,d), hT (B,d,N)), float32.

    h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) (x) B_t;  y_t = h_t . C_t
    """
    dt, x, bmat, cmat, a = (t.float() for t in (dt, x, bmat, cmat, a))
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        dt_t = dt[:, t]                                        # (B,d)
        a_bar = torch.exp(dt_t[:, :, None] * a[None])          # (B,d,N)
        h = a_bar * h + (dt_t * x[:, t])[:, :, None] * bmat[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    return y, h
