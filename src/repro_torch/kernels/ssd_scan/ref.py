"""Plain PyTorch version of the Mamba2 SSD scan kernel: the chunked
block decomposition of ``repro``'s ``ssd_scan_ref`` (single group, g=1).

Inputs (float32): x (B,S,H,D); b, c (B,S,N) shared across heads; ld
(B,S,H) log decay (dt * A, <= 0); dt (B,S,H); h0 (B,H,D,N).
Outputs: y (B,S,H,D), hT (B,H,D,N), float32.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, b, c, ld, dt, h0, chunk: int = 64):
    bsz, s, h, d = x.shape
    nc = max(1, s // chunk)
    assert s % nc == 0, f"seq {s} not divisible into {nc} chunks"
    lc = s // nc
    x, b, c, ld, dt = (t.float() for t in (x, b, c, ld, dt))
    hst = h0.float()
    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for i in range(nc):
        sl = slice(i * lc, (i + 1) * lc)
        xc, bc, cc, ldc, dtc = x[:, sl], b[:, sl], c[:, sl], ld[:, sl], \
            dt[:, sl]
        cum = torch.cumsum(ldc, dim=1)                         # (B,lc,H)
        cb = torch.einsum("bin,bjn->bij", cc, bc)              # (B,lc,lc)
        cum_t = cum.transpose(1, 2)                            # (B,H,lc)
        dmat = cum_t[:, :, :, None] - cum_t[:, :, None, :]     # (B,H,i,j)
        w = cb[:, None] * torch.where(mask, torch.exp(dmat),
                                      torch.zeros_like(dmat))
        xdt = xc * dtc[..., None]                              # (B,lc,H,D)
        y_intra = torch.einsum("bhij,bjhd->bihd", w, xdt)
        y_state = torch.einsum("bin,bhdn->bihd", cc, hst) \
            * torch.exp(cum)[..., None]
        total = cum[:, -1]                                     # (B,H)
        rev = torch.exp(total[:, None] - cum)                  # (B,lc,H)
        hst = hst * torch.exp(total)[..., None, None] + torch.einsum(
            "bjhd,bjn,bjh->bhdn", xdt, bc, rev)
        ys.append(y_intra + y_state)
    return torch.cat(ys, dim=1), hst
