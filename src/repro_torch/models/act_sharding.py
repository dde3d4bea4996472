"""Activation sharding constraints of the port, the counterpart of
``repro.models.act_sharding``.

The launchers register the mesh and its batch axes here; the model pins
activations at the block boundaries (embedding output, each repetition's
input, each sublayer's row-parallel output, final hidden state, logits).
On a DTensor under a registered mesh a constraint is an explicit
``redistribute``: dim 0 to ``Shard(0)`` over the batch axes and, for the
logits, the vocab dim to ``Shard`` over the model axis, each only where the
axes divide the dim (the JAX package's tests), every other mesh dim
``Replicate`` (a ``None`` entry of a ``PartitionSpec``).  On a plain tensor,
or with no mesh configured, a constraint is the identity.

The model's ops that DTensor has no good rule for run here with their
collectives written out: ``local_attention`` and ``local_rows`` (an
attention read or the SSD scan as a ``local_map`` body over each rank's
rows and heads), ``vocab_embed`` (a vocab-parallel lookup),
``vocab_parallel_nll_terms`` (the loss over vocab shards), ``write_slots``
(a cache write into a sharded leaf) and ``unshard`` (an explicit gather of
a dim).  Each is reached only with DTensor operands.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

_BATCH_AXES: Optional[Tuple[str, ...]] = None
_MODEL_AXIS: Optional[str] = None
_MESH = None


def configure(batch_axes: Optional[Tuple[str, ...]],
              model_axis: Optional[str] = "model") -> None:
    global _BATCH_AXES, _MODEL_AXIS
    _BATCH_AXES = tuple(batch_axes) if batch_axes else None
    _MODEL_AXIS = model_axis


@contextlib.contextmanager
def activation_sharding(batch_axes, model_axis="model"):
    global _BATCH_AXES, _MODEL_AXIS
    old = (_BATCH_AXES, _MODEL_AXIS)
    configure(batch_axes, model_axis)
    try:
        yield
    finally:
        _BATCH_AXES, _MODEL_AXIS = old


def register_mesh(mesh) -> None:
    """The ``DeviceMesh`` the constraints place on (None to forget it)."""
    global _MESH
    _MESH = mesh


def _sizes() -> dict:
    return dict(zip(_MESH.mesh_dim_names, _MESH.mesh.shape))


def _axis_prod(axes) -> int:
    sizes = _sizes()
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _active(x) -> bool:
    from torch.distributed.tensor import DTensor
    return (_BATCH_AXES is not None and _MESH is not None
            and isinstance(x, DTensor) and x.device_mesh == _MESH)


def _place(x, dims):
    """Redistribute ``x`` so each mesh axis named in ``dims`` ({axis:
    tensor dim}) shards that dim and every other mesh dim replicates."""
    from torch.distributed.tensor import Replicate, Shard
    placements = [Shard(dims[a]) if a in dims else Replicate()
                  for a in _MESH.mesh_dim_names]
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(_MESH, placements)


def constrain_batch(x):
    """Pin dim 0 to the batch axes, the rest replicated."""
    if not _active(x) or x.shape[0] % _axis_prod(_BATCH_AXES) != 0:
        return x
    return _place(x, {a: 0 for a in _BATCH_AXES})


def constrain_logits(x):
    """(B, S, V): batch over the data axes, vocab over model -- and the
    gradient that comes back placed the same way (the loss's backward may
    otherwise split the sequence over model too, which the head's weight
    gradient cannot take)."""
    if not _active(x):
        return x
    dims = {}
    if x.shape[0] % _axis_prod(_BATCH_AXES) == 0:
        dims.update({a: 0 for a in _BATCH_AXES})
    if _MODEL_AXIS and x.shape[-1] % _axis_prod((_MODEL_AXIS,)) == 0:
        dims[_MODEL_AXIS] = x.ndim - 1
    x = _place(x, dims)
    if x.requires_grad:
        mesh, placements = _MESH, tuple(x.placements)
        x.register_hook(lambda g: g if tuple(g.placements) == placements
                        else g.redistribute(mesh, placements))
    return x


def unshard(x, *dims):
    """``x`` with tensor dims ``dims`` whole on every rank: each mesh dim
    that shards one of them (or holds a partial sum) turns ``Replicate``,
    an explicit collective where an op has no sharding rule for a split
    dim.  The identity on a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    want = {d % x.ndim for d in dims}
    placements = [Replicate() if (isinstance(p, Shard) and p.dim in want)
                  or p.is_partial() else p for p in x.placements]
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _as_dtensor(t, mesh):
    """A plain tensor every rank holds whole (positions, masks) as a
    replicated DTensor on ``mesh``; a DTensor or None as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_rows(fn, args, dims, out_dims, batch: int, heads: int):
    """``fn(*args)`` on DTensors as one ``local_map`` body.  ``dims[i]`` is
    (batch dim, head dim or None) of ``args[i]`` (None for an argument
    that is None); rows shard over the batch axes when ``batch`` divides
    by them, heads over the model axis when ``heads`` divides by it, and
    every other mesh dim replicates -- an explicit redistribute of each
    input (a context-sharded cache is gathered along T), after which each
    rank computes its own rows and heads with no collective inside.  The
    result has ``out_dims``'s placements (a tuple of them for a tuple of
    results)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if hasattr(a, "device_mesh")).device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.mesh.shape))
    batch_axes = set(_BATCH_AXES or ())
    n_b = 1
    for a in batch_axes:
        n_b *= sizes.get(a, 1)

    def placements(dim_b, dim_h):
        out = []
        for a in names:
            if a in batch_axes and batch % n_b == 0:
                out.append(Shard(dim_b))
            elif a == _MODEL_AXIS and dim_h is not None \
                    and heads % sizes[a] == 0:
                out.append(Shard(dim_h))
            else:
                out.append(Replicate())
        return out

    outs = (tuple(placements(*d) for d in out_dims)
            if isinstance(out_dims[0], tuple) else placements(*out_dims))
    ins = tuple(None if d is None else placements(*d) for d in dims)
    # an input without a head dim meets only this rank's heads, so with the
    # heads split its gradient is a partial sum over the model axis
    split = heads % sizes.get(_MODEL_AXIS, 1) == 0
    grads = tuple(None if d is None else
                  [Partial() if a == _MODEL_AXIS and split and d[1] is None
                   else p for a, p in zip(names, pl)]
                  for d, pl in zip(dims, ins))
    return local_map(
        fn, out_placements=outs, in_placements=ins, in_grad_placements=grads,
        device_mesh=mesh, redistribute_inputs=True)(
            *[_as_dtensor(a, mesh) for a in args])


def local_attention(fn, q, k, v, q_pos, k_pos, window=None, k_valid=None):
    """``fn(q, k, v, q_pos, k_pos, window, k_valid)`` (an attention of
    ``flash``'s layout: q (B,S,G,Qh,D), k/v (B,T,G,Dv)) on DTensors as one
    :func:`local_rows` body: each rank attends its own rows and KV
    groups."""
    heads, rows = (0, 2), (0, None)

    def body(q, k, v, q_pos, k_pos, k_valid):
        return fn(q, k, v, q_pos, k_pos, window, k_valid)

    return local_rows(body, (q, k, v, q_pos, k_pos, k_valid),
                      (heads, heads, heads, rows, rows,
                       None if k_valid is None else rows),
                      heads, q.shape[0], q.shape[2])


def _local(t, mesh, placements):
    """The local tensor of ``t`` redistributed to ``placements`` (a plain
    tensor every rank holds whole is taken as replicated)."""
    return _as_dtensor(t, mesh).redistribute(mesh, placements).to_local()


def write_slots(leaf, x, start, wrap: Optional[int] = None) -> None:
    """Write ``x`` (B, n, ...) into the DTensor cache leaf (B, T, ...) at
    positions ``start + k`` (``start`` a scalar or (B, 1); modulo ``wrap``
    for a ring), in place, as a local body: DTensor's in-place rules may
    want ``leaf`` placed otherwise and cannot move it.  ``x`` and ``start``
    are redistributed to the leaf's rows, whole along dim 1 where the leaf
    shards it (an explicit collective); each rank then writes the slots of
    its own chunk with no collective.  One new position (a decode) is a
    scatter of one slot a row; more (a prefill, a verify window) a gather
    from ``x`` over the chunk, so no two writes meet in one slot."""
    from torch.distributed.tensor import Replicate
    mesh = leaf.device_mesh
    pl = [Replicate() if p.is_shard() and p.dim % leaf.ndim == 1 else p
          for p in leaf.placements]
    x_loc = _local(x, mesh, pl)
    rows = [p if p.is_shard() and p.dim % leaf.ndim == 0 else Replicate()
            for p in leaf.placements]
    st = _local(start, mesh, rows) if getattr(start, "ndim", 0) \
        else _local(start, mesh, [Replicate()] * mesh.ndim)
    loc = leaf.to_local()
    # this rank's first slot along dim 1: chunks are even (the specs shard
    # it only where the axis size divides it), major mesh dim first
    offset, span = 0, leaf.shape[1]
    for d, p in enumerate(leaf.placements):
        if p.is_shard() and p.dim % leaf.ndim == 1:
            span //= mesh.size(d)
            offset = offset + mesh.get_local_rank(d) * span
    b_loc, n = x_loc.shape[0], x_loc.shape[1]
    st = st.reshape(-1, 1).expand(b_loc, 1).long()
    trail = (1,) * (x_loc.dim() - 2)
    if n == 1:
        slot = st % wrap if wrap else st
        i = slot - offset
        mine = ((i >= 0) & (i < span)).reshape((b_loc, 1) + trail)
        i = torch.clamp(i, 0, span - 1)
        r = torch.arange(b_loc, device=loc.device)[:, None]
        loc[r, i] = torch.where(mine, x_loc, loc[r, i])
        return
    j = offset + torch.arange(span, device=loc.device)[None, :] - st
    if wrap:
        j = j % wrap
    valid = ((j >= 0) & (j < n)).reshape((b_loc, span) + trail)
    j = torch.clamp(j, 0, n - 1).reshape((b_loc, span) + trail)
    got = torch.gather(x_loc, 1, j.expand((b_loc, span) + x_loc.shape[2:]))
    loc.copy_(torch.where(valid, got, loc))


def vocab_embed(embed, tokens):
    """``embed[tokens]`` from a vocab-sharded DTensor table as one
    ``local_map`` body: each rank looks the tokens up in its own rows
    (others read as zero), and the result is a partial sum over the mesh
    dims that shard the vocabulary -- the explicit form of a vocab-parallel
    embedding, where an index would gather the whole table."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = embed.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    vocab = [d for d, p in enumerate(embed.placements)
             if p.is_shard() and p.dim == 0]
    out_pl = [Partial() if d in vocab
              else Shard(0) if tokens.placements[d] == Shard(0)
              else Replicate() for d in range(mesh.ndim)]

    def body(emb, tok):
        shard = 0
        for d in vocab:                      # major mesh dim first
            shard = shard * mesh.size(d) + mesh.get_local_rank(d)
        i = tok - shard * emb.shape[0]
        ok = (i >= 0) & (i < emb.shape[0])
        rows = emb[torch.clamp(i, 0, emb.shape[0] - 1)]
        return rows * ok[..., None].to(rows.dtype)

    # the table's gradient from this rank's rows is a partial sum over the
    # mesh dims that split the batch and not the table
    grad_pl = [Partial() if tokens.placements[d] == Shard(0)
               and not embed.placements[d].is_shard() else p
               for d, p in enumerate(embed.placements)]
    return local_map(body, out_placements=out_pl,
                     in_placements=(embed.placements, tokens.placements),
                     in_grad_placements=(grad_pl, tokens.placements),
                     device_mesh=mesh)(embed, tokens)


def vocab_parallel_nll_terms(logits, labels):
    """(logsumexp, gold logit) over the last dim of DTensor ``logits``
    (B, S, V) without gathering the vocabulary: a max, a sum of
    exponentials and a masked sum, each reduced across the vocab shards
    (collectives of (B, S) values) -- where ``logsumexp`` and a gather
    would need every rank to hold whole rows.  The max is a shift only,
    so it carries no gradient."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    m = logits.detach().amax(dim=-1, keepdim=True)
    logz = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    # the vocabulary's ids, placed as the logits' last dim is
    last = logits.ndim - 1
    ids_pl = [Shard(0) if p.is_shard() and p.dim % logits.ndim == last
              else Replicate() for p in logits.placements]
    ids = distribute_tensor(torch.arange(logits.shape[-1],
                                         device=logits.device),
                            logits.device_mesh, ids_pl, src_data_rank=None)
    hit = ids == torch.clamp(labels, min=0).long()[..., None]
    gold = torch.where(hit, logits, torch.zeros_like(logits)).sum(dim=-1)
    return logz, gold
