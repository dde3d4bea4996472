"""The port's sharded training against the JAX package's single-device
step on the CPU.

One world of 4 spawned gloo ranks on a 2 x 2 (data, model) mesh takes one
AdamW step of the port for a dense (stablelm-1.6b), an MLA + MoE
(deepseek-v3-671b, its experts sharded over model) and an SSM
(falcon-mamba-7b) smoke config: the JAX package's init bridged with
``params_from_numpy``, sharded by ``launch.sharding``'s rules as DTensors,
the batch split over data.  The gathered params, the loss and the grad norm
equal ``repro.training.train_loop.make_train_step``'s on one device with
the 3-step loss tolerance of ``test_torch_training.py`` (atol = rtol =
1e-4).  AdamW runs with eps 1e-3: at the first step Adam moves an element
by about lr times the sign of its gradient, so a gradient within float32
noise of zero (whose sign the two frameworks may round apart) would move
by 2 lr; with eps 1e-3 such an element moves by at most lr * 1e-6 while a
gradient above 1e-3 still moves its element by about lr (1e-2, a hundred
times the tolerance).

The trainer CLI's ``--mesh 2x2 --fake-devices 4 --device cpu`` gives the
``--mesh host`` losses, and ``--fake-devices`` without ``--device cpu``
is refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import build_model
from repro.training import optimizer as j_opt
from repro.training.train_loop import make_train_step as j_make_step
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import sharding as shr
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import tree_items
from repro_torch.launch.mesh import join_gloo_world, start_gloo_world
from torch_cases import sharded_train_step

TOL = dict(atol=1e-4, rtol=1e-4)
OPT = dict(lr=1e-2, eps=1e-3, schedule="constant", warmup_steps=1)
ARCHS = ("stablelm-1.6b", "deepseek-v3-671b", "zamba2-1.2b")
MESH = (2, 2)


def _case(i, arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(t_get_config(arch, smoke=True),
                               dtype="float32")
    params = jax.tree.map(np.asarray, build_model(cfg).init(
        jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(i).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32)
    return cfg, tcfg, params, tokens


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """{arch: (reference (params, loss, grad norm), port (gathered params,
    loss, grad norm, param bytes a rank), the port's config)}; the
    reference steps run while the world does."""
    cases = [_case(i, arch) for i, arch in enumerate(ARCHS)]
    world = start_gloo_world(4, sharded_train_step, (
        [(arch, tcfg, params, {"tokens": tokens})
         for arch, (_, tcfg, params, tokens) in zip(ARCHS, cases)],
        MESH, OPT), tmp_path_factory.mktemp("world"))
    want = {}
    for arch, (cfg, _, params, tokens) in zip(ARCHS, cases):
        m = build_model(cfg)
        jparams = jax.tree.map(jnp.asarray, params)
        new, _, met = j_make_step(m, j_opt.AdamWConfig(**OPT))(
            jparams, j_opt.init_state(jparams),
            {"tokens": jnp.asarray(tokens)})
        want[arch] = (jax.tree.map(np.asarray, new), float(met["loss"]),
                      float(met["grad_norm"]))
    got = join_gloo_world(world, timeout=240)[0]
    return {arch: (want[arch], got[arch], tcfg)
            for arch, (_, tcfg, _, _) in zip(ARCHS, cases)}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_reference(sharded_steps, arch):
    (jparams, jloss, jnorm), (tparams, tloss, tnorm, _), _ = \
        sharded_steps[arch]
    np.testing.assert_allclose(tloss, jloss, **TOL)
    np.testing.assert_allclose(tnorm, jnorm, **TOL)
    flat = dict(tree_items(tparams))
    paths = [p for p, _ in tree_items(jparams)]
    assert sorted(map(str, paths)) == sorted(map(str, flat))
    for path, w in tree_items(jparams):
        np.testing.assert_allclose(flat[path], np.asarray(w), err_msg=str(path),
                                   **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_holds_each_rank_share(sharded_steps, arch):
    """A rank holds the bytes the specs give it: a quarter of every leaf
    sharded on both axes, half of one sharded on one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _, (_, _, _, local), tcfg = sharded_steps[arch]
    with FakeTensorMode():
        params = t_build_model(tcfg).init(device="cpu")
    shr.set_axis_sizes({"data": 2, "model": 2})
    specs = shr.param_specs(tcfg, params)
    assert local == shr.local_bytes({"data": 2, "model": 2}, params, specs)
    total = sum(p.numel() * 4 for _, p in tree_items(params))
    assert total / 4 < local < total


def test_trainer_fake_devices_match_host():
    from repro_torch.launch import train
    flags = ["--smoke", "--steps", "2", "--batch", "4", "--seq", "32",
             "--device", "cpu"]
    host = train.main(flags)
    mesh = train.main(flags + ["--mesh", "2x2", "--fake-devices", "4"])
    np.testing.assert_allclose(mesh["losses"], host["losses"], **TOL)
    np.testing.assert_allclose(mesh["grad_norms"], host["grad_norms"], **TOL)


def test_trainer_refuses_fake_devices_without_the_cpu():
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="--device cpu"):
        train.main(["--smoke", "--mesh", "2x2", "--fake-devices", "4"])
    with pytest.raises(ValueError, match="as many ranks"):
        train.main(["--smoke", "--mesh", "2x1", "--fake-devices", "4",
                    "--device", "cpu"])
    with pytest.raises(RuntimeError, match="--fake-devices 4 or torchrun"):
        train.main(["--smoke", "--mesh", "2x2", "--device", "cpu"])
