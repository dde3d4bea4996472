"""Sharding rules of the port: param/cache/batch trees -> spec trees, and
specs -> DTensor placements.

The rules are ``repro.launch.sharding``'s (MaxText-flavoured 2D):
 - ``model`` axis: tensor/expert parallelism -- attention heads and d_ff
   columns, MoE experts, mamba channels, vocab (embedding/lm_head);
 - ``data`` axis (x ``pod``): batch for activations; FSDP for weights --
   the second weight dim shards over ``data``, so per-rank parameter
   memory scales with the full rank count.

A spec is a tuple with one entry a tensor dim: a mesh-axis name, a tuple of
names (the dim sharded over their product, major axis first) or ``None``
(not sharded) -- framework-free, like JAX's ``PartitionSpec``, so the JAX
package's specs compare with these entry for entry.  The port's param trees
are per layer (``models/convert.py``): a repeated group's leaf has no
leading ``reps`` axis, so it takes the rule of its own rank, and
``convert.reference_layout(specs, ..., stack=stack_specs)`` puts the axis
back for a comparison.  The rules read only ``.shape`` and ``.ndim``, so
they run on fake or meta tensors.

Caches: batch over the data axes when divisible; KV heads over ``model``
when divisible, else the sequence dim (context sharding).  The group's
cache keeps its ``reps`` axis in the port too, never sharded.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.convert import tree_items, tree_map

Spec = Tuple[Any, ...]

# -- parameter rules: (last-key name, rank) -> spec ------------------------------

_MATRIX_RULES = {
    # attention
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    # mlp
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    # mla
    "wq_a": ("data", None),
    "wq_b": (None, "model"),
    "wkv_a": ("data", None),
    "wkv_b": (None, "model"),
    # moe router
    "router": ("data", None),
    # mamba
    "in_proj": ("data", "model"),
    "z_proj": ("data", "model"),
    "xbc_proj": ("data", "model"),
    "dt_in_proj": ("data", "model"),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "conv_w": (None, "model"),
    "A_log": ("model", None),
    "out_proj": ("model", "data"),
}

_EXPERT_RULES = {  # rank-3 (E, d, f) MoE expert weights
    "w_gate": ("model", None, "data"),
    "w_up": ("model", None, "data"),
    "w_down": ("model", "data", None),
}

_VECTOR_RULES = {
    "conv_b": ("model",),
    "dt_bias": ("model",),
    "D": ("model",),
    "scale": (),         # norms replicated
}

_AXIS_SIZES = {"data": 16, "model": 16, "pod": 2}


def _name(path) -> str:
    return next((k for k in reversed(path) if isinstance(k, str)), "")


def _spec_for_leaf(leaf, path) -> Spec:
    name = _name(path)
    nd = leaf.ndim
    if name == "embed":
        # vocab-parallel only: FSDP'ing D here puts the contraction dim of
        # the (tied) logits matmul on 'data', which conflicts with the
        # model-axis activations
        spec = ("model", None)
    elif name == "lm_head":
        spec = (None, "model")
    elif nd == 3 and name in _EXPERT_RULES:
        spec = _EXPERT_RULES[name]
    elif nd == 2 and name in _MATRIX_RULES:
        spec = _MATRIX_RULES[name]
    elif nd == 1 and name in _VECTOR_RULES:
        spec = _VECTOR_RULES[name]
    elif nd <= 1:
        spec = ()
    else:
        spec = (None,) * nd
    return _guard(spec, tuple(leaf.shape))


def _guard(spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Drop the axes that do not divide their dim; the spec comes back
    padded with ``None`` to the rank of ``shape``."""
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        fixed.append(None if ax is None or dim % _axis_size(ax) else ax)
    return tuple(fixed)


def _axis_size(ax) -> int:
    if isinstance(ax, (tuple, list)):
        s = 1
        for a in ax:
            s *= _AXIS_SIZES.get(a, 1)
        return s
    return _AXIS_SIZES.get(ax, 1)


def set_axis_sizes(mesh_or_sizes) -> None:
    """Record the mesh's axis sizes (a ``DeviceMesh`` or a {name: size}
    dict) for the divisibility guard."""
    global _AXIS_SIZES
    _AXIS_SIZES = (dict(mesh_or_sizes) if isinstance(mesh_or_sizes, dict)
                   else axis_sizes(mesh_or_sizes))


def _drop(spec: Spec, axis: str) -> Spec:
    return tuple(None if ax == axis or (isinstance(ax, tuple) and axis in ax)
                 else ax for ax in spec)


def param_specs(cfg: ModelConfig, params, fsdp: bool = True) -> Any:
    """Spec tree matching a params tree (of tensors, fake or meta tensors
    or anything with ``.shape`` and ``.ndim``).

    ``fsdp=False`` (serve mode) drops the 'data' axis from weight specs:
    weights replicate across the data axis instead of being gathered every
    step.  Use fsdp=True for training (parameters and optimizer state must
    scale with all ranks).
    """
    tree = tree_map(_spec_for_leaf, params, with_path=True)
    if not cfg.tensor_parallel:
        # keep the (padded) vocab dim model-sharded even when block weights
        # replicate: the (B,S,V) logits are the fat tensors of a small-width
        # model
        tree = tree_map(lambda s, path: s if _name(path) in ("embed",
                                                             "lm_head")
                        else _drop(s, "model"), tree, with_path=True)
    if not fsdp:
        tree = tree_map(lambda s: _drop(s, "data"), tree)
    return tree


def stack_specs(specs) -> Spec:
    """``reference_layout``'s ``stack`` for spec trees: the per-layer specs
    of a group slot (all equal) behind an unsharded leading ``reps`` axis,
    as the JAX package lays the group out."""
    first = specs[0]
    if any(s != first for s in specs):
        raise ValueError(f"a group's layers take different specs: {specs}")
    return (None,) + tuple(first)


# -- caches ------------------------------------------------------------------------


def _batch_axis(batch: int, dp: Tuple[str, ...]):
    dp_size = _axis_size(tuple(dp))
    if batch % dp_size or batch < dp_size:
        return None
    # one axis is named alone, as ``PartitionSpec`` normalizes ("data",)
    return dp[0] if len(dp) == 1 else tuple(dp)


def cache_specs(cfg: ModelConfig, cache, batch: int,
                dp: Tuple[str, ...]) -> Any:
    """Spec tree for a decode cache (``kvcache.init_cache``'s layout: the
    group's leaves carry a leading ``reps`` axis, never sharded)."""
    b_ax = _batch_axis(batch, dp)
    m_size = _AXIS_SIZES.get("model", 1)

    def leaf(s, path):
        name = _name(path)
        stacked = "group" in path
        shape = tuple(s.shape[1:] if stacked else s.shape)
        if name == "len":
            spec = ()
        elif name == "pos":                      # (B, W) slot->position map
            spec = (b_ax, None)
        elif name in ("k", "v", "xk", "xv"):     # (B, T, nkv, dh)
            if shape[2] % m_size == 0:
                spec = (b_ax, None, "model", None)
            elif shape[1] % m_size == 0:
                spec = (b_ax, "model", None, None)
            else:
                spec = (b_ax, None, None, None)
        elif name in ("k_scale", "v_scale"):     # (B, T, nkv)
            if shape[2] % m_size == 0:
                spec = (b_ax, None, "model")
            elif shape[1] % m_size == 0:
                spec = (b_ax, "model", None)
            else:
                spec = (b_ax, None, None)
        elif name == "ckv":                      # (B, T, r)
            spec = (b_ax, "model" if shape[1] % m_size == 0 else None, None)
        elif name == "krope":                    # (B, T, 1, dr)
            spec = (b_ax, "model" if shape[1] % m_size == 0 else None,
                    None, None)
        elif name == "conv":                     # (B, K-1, C)
            spec = (b_ax, None, "model" if shape[2] % m_size == 0 else None)
        elif name == "ssm":                      # (B, d, N) | (B, nh, hd, N)
            spec = (b_ax, "model" if shape[1] % m_size == 0 else None,
                    *([None] * (len(shape) - 2)))
        else:
            spec = (None,) * len(shape)
        return (None,) + spec if stacked else spec

    return tree_map(leaf, cache, with_path=True)


def batch_specs(cfg: ModelConfig, batch_tree, batch: int,
                dp: Tuple[str, ...]) -> Any:
    """Dim 0 over the data axes when they divide ``batch``."""
    b_ax = _batch_axis(batch, dp)
    return tree_map(lambda s: (b_ax,) + (None,) * (len(s.shape) - 1),
                    batch_tree)


def opt_state_specs(param_spec_tree) -> Dict[str, Any]:
    """AdamW m/v shard exactly like the params (ZeRO-style)."""
    return {"m": param_spec_tree, "v": param_spec_tree, "step": ()}


# -- DTensor placements ----------------------------------------------------------


def to_placements(mesh, spec: Spec) -> list:
    """A spec -> one DTensor placement a mesh dim: ``Shard(d)`` on every
    mesh dim that tensor dim ``d`` names (a tuple of names shards the dim
    over all of them, major first, as JAX does), ``Replicate`` on the mesh
    dims that shard nothing."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
            if a in names:
                if not isinstance(out[names.index(a)], Replicate):
                    raise ValueError(f"mesh axis {a!r} shards two dims of "
                                     f"{spec}")
                out[names.index(a)] = Shard(d)
    return out


def shard_tree(mesh, tree, specs):
    """Every leaf of ``tree`` distributed over ``mesh`` by its spec.  Every
    rank passes the same full tensors (the same seed or file), so each
    keeps its own chunk and nothing crosses ranks -- which also lets a
    fake tensor of any size be sharded without a collective."""
    from torch.distributed.tensor import distribute_tensor
    flat = dict(tree_items(specs))
    return tree_map(lambda t, path: distribute_tensor(
        t, mesh, to_placements(mesh, flat[path]), src_data_rank=None),
        tree, with_path=True)


def gather_tree(tree):
    """DTensor leaves -> full plain tensors on every rank (others as
    they are)."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def local_bytes(mesh_or_sizes, tree, specs) -> int:
    """Bytes one rank holds of ``tree`` sharded by ``specs``: each leaf's
    bytes over the product of the axis sizes its spec names."""
    sizes = (dict(mesh_or_sizes) if isinstance(mesh_or_sizes, dict)
             else axis_sizes(mesh_or_sizes))
    flat = dict(tree_items(specs))
    total = 0
    for path, t in tree_items(tree):
        div = 1
        for ax in flat[path]:
            for a in (ax if isinstance(ax, (tuple, list)) else
                      (() if ax is None else (ax,))):
                div *= sizes.get(a, 1)
        total += t.numel() * t.element_size() // div
    return total
