"""Plain PyTorch versions of the Mamba2 SSD scan kernel, and the host's
choice of the kernel's path and slices (``ssd_plan``).

``ssd_scan_ref`` is the chunked block decomposition of ``repro``'s
``ssd_scan_ref`` (single group, g=1).  ``ssd_scan_chunked`` computes what the
kernel's chunked path computes, in its order: a zero-padded last chunk, the
in-chunk cumulative decay, and the four products, each in float32 or as
TF32 passes emulated by rounding the operands' bits.

Inputs (float32): x (B,S,H,D); b, c (B,S,N) shared across heads; ld
(B,S,H) log decay (dt * A, <= 0); dt (B,S,H); h0 (B,H,D,N).
Outputs: y (B,S,H,D), hT (B,H,D,N), float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

SMS = 132               # streaming multiprocessors of an H100 SXM
D_SPLITS = (1, 2, 4)    # blocks that may share a head's D rows


class SsdPlan(NamedTuple):
    path: str           # "decode" (S = 1) or "chunked"
    d_split: int        # blocks a head: slices of its D rows


def slice_rows(d: int, d_split: int) -> int:
    """Rows of D a block takes: ceil(d / d_split) rounded up to 8
    (``slice_rows`` in ``ssd_scan.cu``)."""
    rows = -(-d // d_split)
    return -(-rows // 8) * 8


def ssd_plan(s: int, h: int, d: int, n: int) -> SsdPlan:
    """How the kernel lays out a (B, S, H, D) scan with N states, from
    shapes alone (every batch row alike), so choosing it reads nothing from
    the card.  S = 1 takes the decode path.  Otherwise (S = 0 included:
    the kernel then copies h0 to hT) the D rows of a head are cut into
    ``d_split`` slices, the most of ``D_SPLITS`` that keeps H * d_split
    within the card's SMs (so a B=1 prompt fills them) with slices of whole
    8-row tiles.  The kernel itself chooses the chunk length (64 steps, 32
    where S <= 32) and, where a block's shared memory would not hold it,
    drops the chunk to 32 and then doubles the slices."""
    if s == 1:
        return SsdPlan("decode", 1)
    d_split = max(p for p in D_SPLITS
                  if p == 1 or (h * p <= SMS and d % (8 * p) == 0))
    return SsdPlan("chunked", -(-d // slice_rows(d, d_split)))


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


def tf32_split(a: torch.Tensor):
    """a = hi + lo, each rounded to TF32 (10 mantissa bits) to nearest,
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: hi of a, lo of
    a - hi."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        sign = bits & -0x80000000
        mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
        return (sign | mag).view(torch.float32)
    hi = rna(a)
    return hi, rna(a - hi)


def _mm(a, b, passes: int):
    """a @ b in float32 (``passes`` 0), one TF32 pass (hi * hi), or three
    (hi * hi + (hi * lo + lo * hi)), each pass summed in float32."""
    if passes == 0:
        return a @ b
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if passes == 1:
        return ah @ bh
    if passes != 3:
        raise ValueError(f"tf32_passes must be 0, 1 or 3, got {passes}")
    return ah @ bh + (al @ bh + ah @ bl)


def ssd_scan_chunked(x, b, c, ld, dt, h0, chunk: int = 64,
                     tf32_passes: int = 3):
    """The kernel's chunked path in plain PyTorch: chunks of ``chunk``
    steps, the last zero-padded (ld = dt = 0 leave the state as it was);
    per chunk the cumulative decay cum, then G = C B^T, Y = (C h^T) o
    exp(cum) + (G o M) (x dt) with M_ij = exp(cum_i - cum_j) for j <= i,
    and h = h exp(cum_L) + (x dt exp(cum_L - cum))^T B, every product as
    ``_mm`` with ``tf32_passes``."""
    bsz, s, h, d = x.shape
    pad = -s % chunk
    x, b, c, ld, dt = (torch.nn.functional.pad(
        t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        for t in (x, b, c, ld, dt))
    hst = h0.float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for i in range(0, s + pad, chunk):
        sl = slice(i, i + chunk)
        xc = x[:, sl].transpose(1, 2)                          # (B,H,L,D)
        bc, cc = b[:, sl], c[:, sl]                            # (B,L,N)
        cum = torch.cumsum(ld[:, sl].transpose(1, 2), dim=-1)  # (B,H,L)
        dtc = dt[:, sl].transpose(1, 2)                        # (B,H,L)
        gm = _mm(cc, bc.transpose(1, 2), tf32_passes)          # (B,L,L)
        decay = torch.where(mask, torch.exp(cum[..., :, None]
                                            - cum[..., None, :]),
                            torch.zeros((), device=x.device))
        w = gm[:, None] * decay                                # (B,H,L,L)
        y_state = _mm(cc[:, None], hst.transpose(-1, -2), tf32_passes)
        y = y_state * torch.exp(cum)[..., None] \
            + _mm(w, xc * dtc[..., None], tf32_passes)        # (B,H,L,D)
        total = cum[..., -1:]                                  # (B,H,1)
        fx = dtc * torch.exp(total - cum)                      # (B,H,L)
        hst = hst * torch.exp(total)[..., None] + _mm(
            (xc * fx[..., None]).transpose(-1, -2), bc[:, None], tf32_passes)
        ys.append(y.transpose(1, 2))
    if not ys:
        return x.new_zeros((bsz, 0, h, d)), hst
    return torch.cat(ys, dim=1)[:, :s], hst
