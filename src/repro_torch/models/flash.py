"""Full-sequence attention in plain PyTorch (forward only): the port of
``repro.models.flash``'s ``naive_attention`` / ``blocked_attention``
forward and the ``attention_any`` dispatch.  Used for prefill and for the
decode read when the hand-written kernel is off.

GQA layout: q (B, S, G, Qh, D) where G = n_kv heads, Qh = n_q // n_kv;
k/v (B, T, G, D).
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def _bias_tile(q_pos, k_pos, window, k_valid) -> torch.Tensor:
    """q_pos (B, qb), k_pos (B, kb) -> additive bias (B,1,1,qb,kb) f32."""
    ok = k_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        ok = ok & (k_pos[:, None, :] > (q_pos[:, :, None] - window))
    if k_valid is not None:
        ok = ok & k_valid[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), NEG, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)[:, None, None, :, :]


def _pick_blocks(s, t, q_block, kv_block):
    if s % q_block != 0 or s <= q_block:
        q_block = s
    if t % kv_block != 0 or t <= kv_block:
        kv_block = t
    return q_block, kv_block


def blocked_attention(q, k, v, q_pos, k_pos, window=None, k_valid=None,
                      q_block: int = 512, kv_block: int = 1024):
    """Online-softmax attention over (q_block x kv_block) tiles, so the
    live intermediate is one tile.  q (B,S,G,Qh,D); k,v (B,T,G,D)."""
    b, s, g, qh, d = q.shape
    t = k.shape[1]
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    q_block, kv_block = _pick_blocks(s, t, q_block, kv_block)
    outs = []
    for qs in range(0, s, q_block):
        qb, qp = q[:, qs:qs + q_block], q_pos[:, qs:qs + q_block]
        m = torch.full((b, g, qh, q_block), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, g, qh, q_block), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, g, qh, q_block, dv), dtype=torch.float32,
                          device=q.device)
        for ks in range(0, t, kv_block):
            kb, vb = k[:, ks:ks + kv_block], v[:, ks:ks + kv_block]
            kval = None if k_valid is None else k_valid[:, ks:ks + kv_block]
            sc = torch.einsum("bsgqd,btgd->bgqst", qb, kb) * scale
            sc = sc.to(torch.float32) + _bias_tile(
                qp, k_pos[:, ks:ks + kv_block], window, kval)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgqst,btgd->bgqsd", p.to(qb.dtype), vb).to(torch.float32)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1)


def naive_attention(q, k, v, q_pos, k_pos, window=None, k_valid=None):
    """Unblocked attention (short prompts / decode)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    sc = torch.einsum("bsgqd,btgd->bgqst", q, k) * scale
    bias = _bias_tile(q_pos, k_pos, window, k_valid)
    probs = torch.softmax(sc.to(torch.float32) + bias, dim=-1)
    return torch.einsum("bgqst,btgd->bsgqd", probs.to(q.dtype), v)


def attention_any(q, k, v, q_pos, k_pos, window=None, k_valid=None,
                  blocked_threshold: int = 1024):
    """Dispatch: blocked for long sequences, naive for short/decode."""
    s, t = q.shape[1], k.shape[1]
    if s * t >= blocked_threshold * blocked_threshold:
        return blocked_attention(q, k, v, q_pos, k_pos, window, k_valid)
    return naive_attention(q, k, v, q_pos, k_pos, window, k_valid)
