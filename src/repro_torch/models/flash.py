"""Full-sequence attention in plain PyTorch: the port of
``repro.models.flash``'s ``naive_attention``, ``blocked_attention`` (its
custom VJP too: the backward recomputes the probability tiles) and the
``attention_any`` dispatch.  Used for training, for prefill and for the
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


def _flash_fwd(q, k, v, q_pos, k_pos, window, k_valid, q_block, kv_block):
    """Online-softmax attention over (q_block x kv_block) tiles, so the
    live intermediate is one tile.  Returns (out (B,S,G,Qh,Dv) in q's
    dtype, lse (B,G,Qh,S) float32)."""
    b, s, g, qh, d = q.shape
    t = k.shape[1]
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    outs, lses = [], []
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
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _flash_bwd(q, k, v, q_pos, k_pos, window, k_valid, out, lse, dout,
               q_block, kv_block):
    """The flash-2 backward of ``repro.models.flash._flash_bwd``: each
    probability tile is recomputed from the saved row log-sum-exp and
    dropped, so the live intermediate stays one tile.  Sums in float32;
    the grads come back in their operands' dtypes."""
    s, t = q.shape[1], k.shape[1]
    f32 = torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    # delta_i = rowsum(dO_i * O_i)
    delta = torch.einsum("bsgqd,bsgqd->bgqs", dout.to(f32), out.to(f32))
    dq = torch.empty(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=k.device)
    dv = torch.zeros(v.shape, dtype=f32, device=v.device)
    for qs in range(0, s, q_block):
        sl = slice(qs, qs + q_block)
        qb, qp, dob = q[:, sl], q_pos[:, sl], dout[:, sl].to(f32)
        lse_i, del_i = lse[..., sl, None], delta[..., sl, None]
        dq_i = torch.zeros(qb.shape, dtype=f32, device=q.device)
        for ks in range(0, t, kv_block):
            kl = slice(ks, ks + kv_block)
            kb, vb = k[:, kl], v[:, kl]
            kval = None if k_valid is None else k_valid[:, kl]
            sc = torch.einsum("bsgqd,btgd->bgqst", qb, kb) * scale
            sc = sc.to(f32) + _bias_tile(qp, k_pos[:, kl], window, kval)
            p = torch.exp(sc - lse_i)                        # (B,G,Qh,qb,kb)
            dv[:, kl] += torch.einsum("bgqst,bsgqd->btgd", p, dob)
            dp = torch.einsum("bsgqd,btgd->bgqst", dob, vb.to(f32))
            ds = p * (dp - del_i) * scale
            dq_i += torch.einsum("bgqst,btgd->bsgqd", ds, kb.to(f32))
            dk[:, kl] += torch.einsum("bgqst,bsgqd->btgd", ds, qb.to(f32))
        dq[:, sl] = dq_i
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BlockedAttention(torch.autograd.Function):
    """The custom VJP of ``repro.models.flash.blocked_attention``: the
    forward saves (q, k, v, out, lse) and no tile; the backward recomputes
    the tiles (``_flash_bwd``).  Autograd through the loops instead would
    keep every (q_block x kv_block) tile for the backward, the memory of
    the whole S x T attention matrix."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window, k_valid, q_block,
                kv_block):
        out, lse = _flash_fwd(q, k, v, q_pos, k_pos, window, k_valid,
                              q_block, kv_block)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, k_valid, out, lse)
        ctx.blocks = (window, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, k_valid, out, lse = ctx.saved_tensors
        window, q_block, kv_block = ctx.blocks
        dq, dk, dv = _flash_bwd(q, k, v, q_pos, k_pos, window, k_valid, out,
                                lse, dout, q_block, kv_block)
        return dq, dk, dv, None, None, None, None, None, None


def blocked_attention(q, k, v, q_pos, k_pos, window=None, k_valid=None,
                      q_block: int = 512, kv_block: int = 1024):
    """q (B,S,G,Qh,D); k,v (B,T,G,D) -> (B,S,G,Qh,Dv): online softmax over
    (q_block x kv_block) tiles forward, the tiles recomputed backward, so
    training memory stays one tile."""
    q_block, kv_block = _pick_blocks(q.shape[1], k.shape[1], q_block,
                                     kv_block)
    return _BlockedAttention.apply(q, k, v, q_pos, k_pos, window, k_valid,
                                   q_block, kv_block)


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
    """Dispatch: blocked for long sequences, naive for short/decode.  On
    DTensors (a mesh's shards) each rank attends its own rows and KV
    groups (``act_sharding.local_attention``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        from repro_torch.models.act_sharding import local_attention
        return local_attention(
            lambda *a: attention_any(*a, blocked_threshold=blocked_threshold),
            q, k, v, q_pos, k_pos, window, k_valid)
    s, t = q.shape[1], k.shape[1]
    if s * t >= blocked_threshold * blocked_threshold:
        return blocked_attention(q, k, v, q_pos, k_pos, window, k_valid)
    return naive_attention(q, k, v, q_pos, k_pos, window, k_valid)
