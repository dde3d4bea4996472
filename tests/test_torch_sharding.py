"""The port's sharding rules (``repro_torch.launch.sharding``) and
activation constraints against the JAX package's on the CPU.

Spec parity: the port's per-layer param specs, stacked back into the JAX
package's layout (``reference_layout`` with ``stack_specs``), its cache
specs and its batch specs equal ``repro.launch.sharding``'s
``PartitionSpec``s entry for entry -- every architecture of ``ALIASES`` at
its smoke config under 2 x 2 axis sizes, and the published configs whose
shape-only init is cheap at 16 x 16, both ``fsdp`` values.  The reference's
param shapes come from ``jax.eval_shape(model.init, ...)``, the port's from
``model.init`` under ``FakeTensorMode`` (nothing allocated).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ALIASES, get_config
from repro.launch import sharding as j_shr
from repro.models import build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import sharding as shr
from repro_torch.models import act_sharding
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import reference_layout, tree_items

SMOKE_SIZES = {"data": 2, "model": 2}
FULL_SIZES = {"data": 16, "model": 16}
# published configs whose shape-only init takes about a second or less
FULL_ARCHS = ("gemma3-27b", "yi-34b", "zamba2-1.2b", "whisper-tiny",
              "stablelm-1.6b", "falcon-mamba-7b")


@contextlib.contextmanager
def axis_sizes(sizes):
    """Both packages' divisibility guards on ``sizes``; the JAX package's
    module-level sizes put back after."""
    old_j, old_t = j_shr._AXIS_SIZES, shr._AXIS_SIZES
    j_shr._AXIS_SIZES, shr._AXIS_SIZES = dict(sizes), dict(sizes)
    try:
        yield
    finally:
        j_shr._AXIS_SIZES, shr._AXIS_SIZES = old_j, old_t


def _ref_tree(spec_tree):
    return jax.tree.map(tuple, spec_tree, is_leaf=lambda x: isinstance(x, P))


def _assert_same(want, got):
    w, g = dict(tree_items(want)), dict(tree_items(got))
    assert sorted(map(str, w)) == sorted(map(str, g))
    bad = [(path, w[path], g[path]) for path in w if w[path] != g[path]]
    assert not bad, bad[:5]


def _configs(arch, smoke):
    return get_config(arch, smoke=smoke), t_get_config(arch, smoke=smoke)


def _port_params(tcfg):
    with FakeTensorMode():
        return t_build_model(tcfg).init(device="cpu")


def _param_case(arch, smoke, fsdp):
    cfg, tcfg = _configs(arch, smoke)
    want = _ref_tree(j_shr.param_specs(
        cfg, jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0)),
        fsdp=fsdp))
    got = reference_layout(shr.param_specs(tcfg, _port_params(tcfg),
                                           fsdp=fsdp),
                           lambda s: s, shr.stack_specs)
    _assert_same(want, got)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_param_specs_match_reference_smoke(arch, fsdp):
    with axis_sizes(SMOKE_SIZES):
        _param_case(arch, True, fsdp)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", FULL_ARCHS)
def test_param_specs_match_reference_full(arch, fsdp):
    with axis_sizes(FULL_SIZES):
        _param_case(arch, False, fsdp)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_cache_and_batch_specs_match_reference_smoke(arch, batch):
    cfg, tcfg = _configs(arch, True)
    with axis_sizes(SMOKE_SIZES):
        want = _ref_tree(j_shr.cache_specs(
            cfg, build_model(cfg).cache_spec(batch, 64), batch, ("data",)))
        cache = t_build_model(tcfg).init_cache(batch, 64, device="meta")
        got = shr.cache_specs(tcfg, cache, batch, ("data",))
        _assert_same(want, got)
        inputs = {"tokens": jax.ShapeDtypeStruct((batch, 17), np.int32),
                  "prefix": jax.ShapeDtypeStruct((batch, 3, 8), np.float32)}
        want = _ref_tree(j_shr.batch_specs(cfg, inputs, batch, ("data",)))
        got = shr.batch_specs(tcfg, {k: torch.empty(v.shape, device="meta")
                                     for k, v in inputs.items()},
                              batch, ("data",))
        assert want == got


@pytest.mark.parametrize("arch", ["yi-34b", "stablelm-1.6b",
                                  "falcon-mamba-7b", "gemma3-27b"])
def test_cache_specs_match_reference_full(arch):
    cfg, tcfg = _configs(arch, False)
    dp = ("pod", "data")
    with axis_sizes({"pod": 2, **FULL_SIZES}):
        want = _ref_tree(j_shr.cache_specs(
            cfg, build_model(cfg).cache_spec(128, 1024), 128, dp))
        cache = t_build_model(tcfg).init_cache(128, 1024, device="meta")
        _assert_same(want, shr.cache_specs(tcfg, cache, 128, dp))


def test_divisibility_guard_and_opt_state():
    with axis_sizes(FULL_SIZES):
        assert shr._guard(("model",), (6,)) == (None,)
        assert shr._guard((None, "model"), (10, 32)) == (None, "model")
        assert shr._guard((("pod", "data"),), (32,)) == (("pod", "data"),)
        assert shr._guard((), (3, 4)) == (None, None)
    tree = {"w": ("data", "model")}
    assert shr.opt_state_specs(tree) == {"m": tree, "v": tree, "step": ()}


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert shr.to_placements(Mesh, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert shr.to_placements(Mesh, (None, "model")) == [
        Replicate(), Replicate(), Shard(1)]
    assert shr.to_placements(Mesh, ()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="shards two dims"):
        shr.to_placements(Mesh, ("model", "model"))


def test_local_bytes_counts_each_rank_share():
    t = {"a": torch.empty((32, 64), device="meta"),
         "b": torch.empty((6,), dtype=torch.float16, device="meta")}
    specs = {"a": (("pod", "data"), "model"), "b": (None,)}
    assert shr.local_bytes({"pod": 2, "data": 4, "model": 8}, t, specs) \
        == 32 * 64 * 4 // 64 + 12


def test_constraints_are_identity_on_plain_tensors():
    x = torch.randn(4, 3, 8)
    with act_sharding.activation_sharding(("data",)):
        assert act_sharding.constrain_batch(x) is x
        assert act_sharding.constrain_logits(x) is x
        assert act_sharding.unshard(x, -1) is x


def test_production_and_host_meshes(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch import mesh
    for multi_pod, shape, axes in ((False, (16, 16), ("data", "model")),
                                   (True, (2, 16, 16),
                                    ("pod", "data", "model"))):
        mesh.start_fake_world(512 if multi_pod else 256)
        try:
            m = mesh.make_production_mesh(multi_pod=multi_pod)
            assert tuple(m.mesh.shape) == shape
            assert m.mesh_dim_names == axes
            assert mesh.data_axes(m) == axes[:-1]
            assert mesh.axis_sizes(m) == dict(zip(axes, shape))
        finally:
            dist.destroy_process_group()
    mesh.start_fake_world(4)
    try:
        with pytest.raises(RuntimeError, match="start_fake_world"):
            mesh.make_production_mesh()
    finally:
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        m = mesh.make_host_mesh("cpu")
        assert tuple(m.mesh.shape) == (1, 1)
        assert mesh.data_axes(m) == ("data",)
    finally:
        dist.destroy_process_group()
