"""Plain PyTorch version of the Mamba1 selective-scan kernel: the direct
recurrence, a loop over the sequence (``repro``'s ``mamba_scan_ref``); and
the host's choice of the kernel's layout (``scan_plan``)."""
from __future__ import annotations

import torch

STATES_A_LANE = 4       # states a lane of the kernel holds
SCAN_THREADS = 256      # threads a block at most (the kernel takes <= 256)
TIME_TILE = 32          # steps a tile stages at most: a multiple of 16 lanes


def scan_plan(s: int, d: int, n: int) -> tuple:
    """(lanes, chans, tile): how the kernel lays out a (B, S, d) scan with
    N = ``n`` states (every batch row alike), from shapes alone, so choosing
    it reads nothing back from the card.  A channel's states go
    ``STATES_A_LANE`` to a lane over ``lanes`` lanes (the power of two at or
    above ceil(n / STATES_A_LANE)); a block holds ``chans`` channels (at
    most ``SCAN_THREADS`` threads, whole warps, a multiple of 4 channels so
    rows of dt and x move in 16-byte pieces), and the grid
    (B, ceil(d / chans)) covers every channel once.  ``tile`` steps are staged at a time:
    ``TIME_TILE``, or S rounded up to a multiple of ``lanes`` where that is
    less (the kernel walks the steps ``lanes`` at a time); a tile of 1
    stages nothing, as at S = 1."""
    lanes = 1 << max(0, -(-n // STATES_A_LANE) - 1).bit_length()
    grain = max(4, 32 // lanes)
    chans = min(SCAN_THREADS // lanes, -(-d // grain) * grain)
    tile = 1 if s <= 1 else min(TIME_TILE, -(-s // lanes) * lanes)
    return lanes, chans, tile


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
