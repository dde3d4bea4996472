"""State-space blocks of the port: Mamba1 (selective scan) and Mamba2 (SSD),
mirroring ``repro.models.ssm``.

 - Mamba1: with ``use_pallas_kernels`` the selective scan runs in the
   hand-written kernel (``kernels/mamba_scan``), which keeps the
   (B, d_inner, N) state in registers; otherwise the discretized
   (B, S, d_inner, N) tensors are formed and scanned chunk by chunk
   (``CHUNK`` steps a chunk, a log-step doubling scan inside each, the
   state carried between chunks).
 - Mamba2: with ``use_pallas_kernels`` and one group the SSD scan runs in
   the hand-written kernel (``kernels/ssd_scan``); otherwise the chunked
   block decomposition: masked, decay-weighted (lc x lc) products within a
   chunk and scalar-decay state passing between chunks.

Decode is the same function at S=1, with the conv and recurrent states
carried in the serving cache.  ``dt_bias``, ``A_log`` and ``D`` are float32
whatever ``cfg.dtype`` is; the scans run in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import (dense_init, rmsnorm, rmsnorm_init,
                                       torch_dtype)

Params = Dict[str, torch.Tensor]

CHUNK = 128
F32 = torch.float32


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------


def mamba1_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = max(1, d // 16)
    dt = torch_dtype(cfg)
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in), dtype=dt, device=device),
        "conv_w": dense_init(gen, (s.d_conv, d_in), dtype=dt, device=device),
        "conv_b": torch.zeros((d_in,), dtype=dt, device=device),
        "x_proj": dense_init(gen, (d_in, dt_rank + 2 * s.d_state), dtype=dt,
                             device=device),
        "dt_proj": dense_init(gen, (dt_rank, d_in), dtype=dt, device=device),
        "dt_bias": torch.zeros((d_in,), dtype=F32, device=device),
        "A_log": torch.log(torch.arange(1, s.d_state + 1, dtype=F32,
                                        device=device)).expand(d_in, -1)
        .contiguous(),                                       # (d_in, N)
        "D": torch.ones((d_in,), dtype=F32, device=device),
        "out_proj": dense_init(gen, (d_in, d), dtype=dt, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B,S,C), w: (K,C), state: (B,K-1,C) the
    previous inputs (decode continuity).  Returns (silu(y + b), new state)."""
    k = w.shape[0]
    bsz, s, c = x.shape
    if state is None:
        state = x.new_zeros((bsz, k - 1, c))
    xp = torch.cat([state, x], dim=1)                    # (B, S+K-1, C)
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, xp.shape[1] - (k - 1):] if k > 1 else state
    return F.silu(y + b), new_state


def _scan_chunked(a: torch.Tensor, bx: torch.Tensor,
                  h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear recurrence h_t = a_t * h_{t-1} + bx_t along axis 1.

    a, bx: (B, S, ...) float32; h0: (B, ...).  Returns (h_all (B,S,...),
    h_S).  ``S // CHUNK`` chunks (one if S < CHUNK) run in order; within a
    chunk a doubling scan combines (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)
    in log2(lc) steps.
    """
    s = a.shape[1]
    n_chunks = max(1, s // CHUNK)
    assert s % n_chunks == 0, f"seq {s} not divisible into chunks"
    lc = s // n_chunks
    h = h0
    outs = []
    for c in range(n_chunks):
        aa = a[:, c * lc:(c + 1) * lc]
        bb = bx[:, c * lc:(c + 1) * lc]
        k = 1
        while k < lc:
            bb = torch.cat([bb[:, :k], aa[:, k:] * bb[:, :-k] + bb[:, k:]],
                           dim=1)
            aa = torch.cat([aa[:, :k], aa[:, k:] * aa[:, :-k]], dim=1)
            k *= 2
        h_all = aa * h[:, None] + bb
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, dim=1), h


def mamba1_apply(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None,
                 ssm_state: Optional[torch.Tensor] = None):
    """x: (B,S,D) -> (y, (conv_state, ssm_state)).  S=1 is the decode
    step; larger S covers prefill."""
    s_cfg = cfg.ssm
    d_in = s_cfg.expand * cfg.d_model
    n = s_cfg.d_state
    dt_rank = max(1, cfg.d_model // 16)
    bsz = x.shape[0]

    xz = x @ params["in_proj"]
    xs, z = xz[..., :d_in], xz[..., d_in:]
    xs, new_conv = _causal_conv(xs, params["conv_w"], params["conv_b"],
                                conv_state)
    proj = xs @ params["x_proj"]
    dt_in = proj[..., :dt_rank]
    b_in = proj[..., dt_rank:dt_rank + n].to(F32)               # (B,S,N)
    c_in = proj[..., dt_rank + n:].to(F32)                      # (B,S,N)
    dt = F.softplus((dt_in @ params["dt_proj"]).to(F32)
                    + params["dt_bias"])                        # (B,S,d_in)
    a = -torch.exp(params["A_log"])                             # (d_in,N)
    if ssm_state is None:
        ssm_state = torch.zeros((bsz, d_in, n), dtype=F32, device=x.device)
    xs32 = xs.to(F32)
    if cfg.use_pallas_kernels:
        # hand-written selective scan (kernels/mamba_scan): the state stays
        # in registers, the discretized tensors are never formed
        y, h_last = mamba_scan(dt.contiguous(), xs32.contiguous(),
                               b_in.contiguous(), c_in.contiguous(),
                               a.contiguous(), ssm_state.contiguous())
    else:
        a_bar = torch.exp(dt[..., None] * a)                    # (B,S,d,N)
        bx = (dt * xs32)[..., None] * b_in[:, :, None, :]
        h_all, h_last = _scan_chunked(a_bar, bx, ssm_state)
        y = torch.einsum("bsdn,bsn->bsd", h_all, c_in)
    y = y + params["D"] * xs32
    y = (y.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    return y, (new_conv, h_last)


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    g = s.n_groups
    dt = torch_dtype(cfg)
    conv_dim = d_in + 2 * g * s.d_state
    return {
        "z_proj": dense_init(gen, (d, d_in), dtype=dt, device=device),
        "xbc_proj": dense_init(gen, (d, conv_dim), dtype=dt, device=device),
        "dt_in_proj": dense_init(gen, (d, nh), dtype=dt, device=device),
        "conv_w": dense_init(gen, (s.d_conv, conv_dim), dtype=dt,
                             device=device),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "dt_bias": torch.zeros((nh,), dtype=F32, device=device),
        "A_log": torch.zeros((nh,), dtype=F32, device=device),
        "D": torch.ones((nh,), dtype=F32, device=device),
        "norm": rmsnorm_init(d_in, dt, device),
        "out_proj": dense_init(gen, (d_in, d), dtype=dt, device=device),
    }


def _ssd_chunked(xs, b_in, c_in, log_decay, dt, h0):
    """The chunked SSD einsums of ``repro.models.ssm.mamba2_apply`` for any
    number of groups: xs (B,S,nh,hd); b_in, c_in (B,S,g,N); log_decay, dt
    (B,S,nh); h0 (B,nh,hd,N) -> (y (B,S,nh,hd), hT), float32."""
    bsz, slen, nh, hd = xs.shape
    g = b_in.shape[2]
    hpg = nh // g
    n_chunks = max(1, slen // CHUNK)
    assert slen % n_chunks == 0
    lc = slen // n_chunks
    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                 device=xs.device))
    h = h0
    ys = []
    for i in range(n_chunks):
        sl = slice(i * lc, (i + 1) * lc)
        xc, bc, cc, ldc, dtc = xs[:, sl], b_in[:, sl], c_in[:, sl], \
            log_decay[:, sl], dt[:, sl]
        cum = torch.cumsum(ldc, dim=1)                         # (B,lc,nh)
        # intra-chunk: y[i] = sum_{j<=i} decay(i,j) (C_i.B_j) dt_j x_j
        cb = torch.einsum("bign,bjgn->bgij", cc, bc)           # (B,g,lc,lc)
        cb = torch.repeat_interleave(cb, hpg, dim=1)           # (B,nh,lc,lc)
        cum_t = cum.transpose(1, 2)
        dmat = cum_t[:, :, :, None] - cum_t[:, :, None, :]     # (B,nh,i,j)
        dmat = torch.where(mask, dmat, torch.full_like(dmat, -math.inf))
        w = cb * torch.exp(dmat)
        xdt = xc * dtc[..., None]                              # (B,lc,nh,hd)
        y_intra = torch.einsum("bhij,bjhd->bihd", w, xdt)
        # incoming state: y[i] = C_i . h * decay(0..i)
        cfull = torch.repeat_interleave(cc, hpg, dim=2)        # (B,lc,nh,N)
        y_state = torch.einsum("bihn,bhdn->bihd", cfull, h) \
            * torch.exp(cum)[..., None]
        # new state: h' = decay(total) h + sum_j decay(j..end) B_j dt_j x_j
        total = cum[:, -1]                                     # (B,nh)
        rev = torch.exp(total[:, None] - cum)                  # (B,lc,nh)
        bfull = torch.repeat_interleave(bc, hpg, dim=2)        # (B,lc,nh,N)
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "bjhd,bjhn,bjh->bhdn", xdt, bfull, rev)
        ys.append(y_intra + y_state)
    return torch.cat(ys, dim=1), h


def mamba2_apply(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None,
                 ssm_state: Optional[torch.Tensor] = None):
    """x: (B,S,D) -> (y, (conv_state, ssm_state (B,nh,hd,N)))."""
    s_cfg = cfg.ssm
    d_in = s_cfg.expand * cfg.d_model
    hd, n, g = s_cfg.head_dim, s_cfg.d_state, s_cfg.n_groups
    nh = d_in // hd
    bsz, slen, _ = x.shape

    z = x @ params["z_proj"]
    xbc = x @ params["xbc_proj"]
    dt_raw = x @ params["dt_in_proj"]
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    xs = xbc[..., :d_in].reshape(bsz, slen, nh, hd).to(F32)
    b_in = xbc[..., d_in:d_in + g * n].reshape(bsz, slen, g, n).to(F32)
    c_in = xbc[..., d_in + g * n:].reshape(bsz, slen, g, n).to(F32)
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])        # (B,S,nh)
    a = -torch.exp(params["A_log"])                            # (nh,)
    log_decay = dt * a                                         # <= 0
    if ssm_state is None:
        ssm_state = torch.zeros((bsz, nh, hd, n), dtype=F32, device=x.device)

    if cfg.use_pallas_kernels and g == 1:
        # hand-written SSD scan (kernels/ssd_scan); on the CPU its plain
        # version is chunked as the JAX package's kernel is
        y, h_last = ssd_scan(xs.contiguous(), b_in[:, :, 0].contiguous(),
                             c_in[:, :, 0].contiguous(),
                             log_decay.contiguous(), dt.contiguous(),
                             ssm_state.contiguous(),
                             chunk=min(CHUNK, slen))
    else:
        y, h_last = _ssd_chunked(xs, b_in, c_in, log_decay, dt, ssm_state)
    y = y + params["D"][:, None] * xs
    y = y.reshape(bsz, slen, d_in).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.rms_eps)
    return y @ params["out_proj"], (new_conv, h_last)
