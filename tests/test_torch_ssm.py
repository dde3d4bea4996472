"""The port's SSM path (``repro_torch.models.ssm`` and the scan kernels'
plain versions) against ``repro``'s on the same numpy inputs:

 - the plain versions of the Mamba1 selective scan and the Mamba2 SSD scan
   against the JAX package's refs and its Pallas kernels in interpret mode,
   and chunked continuity (two calls that carry the state equal one call);
 - ``mamba1_apply`` / ``mamba2_apply`` with carried conv and ssm state at
   S in {1, 5}, kernel route on and off;
 - whole models (a Mamba1 stack, and a Mamba2 + shared-attention hybrid):
   prefill and three ragged decode steps, kernel route on and off;
 - the parameter bridge: shared attention weights carried across, the
   float32 SSM leaves kept float32 in a bf16 config.

float32 throughout; atol = rtol = 1e-4 covers the different summation
orders (sequential vs chunked scans, the frameworks' matmuls).  The
hand-written kernels are held against the plain versions on the card in
``test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig, SSMConfig
from repro.kernels.mamba_scan.kernel import mamba_scan_pallas
from repro.kernels.mamba_scan.ref import mamba_scan_ref
from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.models import build_model
from repro.models import ssm as jssm
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import SSMConfig as TSSMConfig
from repro_torch.kernels.mamba_scan import kernel as mamba_kernel
from repro_torch.kernels.mamba_scan import ref as mamba_ref
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import build_model as t_build_model
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy
from torch_cases import mamba_inputs, ssd_inputs

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", max_seq_len=64)
# tests/test_models.py's SSM families
FAMILIES = {
    "mamba1": dict(family="ssm", group=("mamba1",),
                   ssm=dict(d_state=8, version=1)),
    "hybrid": dict(family="hybrid",
                   group=("mamba2", "mamba2", "shared_attn"),
                   ssm=dict(d_state=8, version=2, head_dim=16)),
}


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _close(a, b):
    np.testing.assert_allclose(b.numpy() if isinstance(b, torch.Tensor)
                               else b, np.asarray(a), **TOL)


# -- kernels' plain versions --------------------------------------------------


@pytest.mark.parametrize("b,s,d,n,bd,bs", [
    (2, 64, 32, 8, 16, 16), (1, 128, 512, 16, 512, 128),
    (2, 100, 48, 8, 48, 100), (1, 256, 64, 16, 32, 64),
    # ragged: 130 channels, N not a multiple of 4 or above 16, odd S
    (2, 33, 130, 5, 130, 11), (1, 37, 130, 5, 65, 37),
    (2, 33, 130, 12, 65, 33), (1, 37, 130, 12, 130, 37),
    (2, 33, 130, 64, 130, 33), (1, 37, 130, 64, 65, 37)])
def test_mamba_scan_matches_jax(b, s, d, n, bd, bs):
    inp = mamba_inputs(b, s, d, n, seed=s + d)
    y, h = mamba_scan(*_t(inp))
    y_ref, h_ref = mamba_scan_ref(*map(jnp.asarray, inp))
    _close(y_ref, y)
    _close(h_ref, h)
    y_k, h_k = mamba_scan_pallas(*map(jnp.asarray, inp), block_d=bd,
                                 block_s=bs, interpret=True)
    _close(y_k, y)
    _close(h_k, h)


@pytest.mark.parametrize("n", [1, 4, 5, 12, 16, 33, 64])
@pytest.mark.parametrize("d", [1, 5, 130, 8192])
@pytest.mark.parametrize("s", [1, 31, 32, 33, 300, 2048])
def test_scan_plan(s, d, n):
    """The kernel's layout, from shapes alone: the fewest power-of-two
    lanes holding every state, whole warps of at most SCAN_THREADS threads,
    every channel in exactly one block, time tiles of whole groups of lanes
    steps covering S, and nothing staged at S = 1."""
    lanes, chans, tile = mamba_ref.scan_plan(s, d, n)
    # the fewest power-of-two lanes that hold the states
    per_lane = mamba_ref.STATES_A_LANE
    assert lanes & (lanes - 1) == 0 and lanes * per_lane >= n
    assert lanes == 1 or lanes * per_lane // 2 < n
    threads = chans * lanes
    assert threads % 32 == 0 and threads <= mamba_ref.SCAN_THREADS
    assert chans % 4 == 0
    n_blocks = -(-d // chans)
    owners = [blk * chans + c for blk in range(n_blocks)
              for c in range(chans) if blk * chans + c < d]
    assert owners == list(range(d))
    n_tiles = -(-s // tile)
    assert n_tiles * tile >= s > (n_tiles - 1) * tile
    assert (tile == 1) == (s == 1)
    if s > 1:   # whole groups of lanes steps, none wholly past S
        assert tile % lanes == 0 and tile <= mamba_ref.TIME_TILE
        assert tile - s < lanes


def test_scan_plan_of_falcon():
    """falcon-mamba-7b (d_inner 8192, N 16): 4 lanes a channel, 64 channels
    a block; its decode step stages nothing, its prompts 32 steps a tile."""
    assert mamba_ref.scan_plan(1, 8192, 16) == (4, 64, 1)
    assert mamba_ref.scan_plan(2048, 8192, 16) == (4, 64, 32)


@pytest.mark.parametrize("b,s,h,d,n,bh,ck", [
    (2, 128, 8, 16, 8, 4, 32), (1, 64, 4, 32, 16, 4, 64),
    (2, 96, 6, 8, 4, 3, 32), (1, 256, 2, 64, 64, 2, 64)])
def test_ssd_scan_matches_jax(b, s, h, d, n, bh, ck):
    inp = ssd_inputs(b, s, h, d, n, seed=s + h)
    y, hT = ssd_scan(*_t(inp), chunk=ck)
    y_ref, h_ref = ssd_scan_ref(*map(jnp.asarray, inp), chunk=ck)
    _close(y_ref, y)
    _close(h_ref, hT)
    y_k, h_k = ssd_scan_pallas(*map(jnp.asarray, inp), block_h=bh, chunk=ck,
                               interpret=True)
    _close(y_k, y)
    _close(h_k, hT)


def _split(xs, cut):
    return [x[:, :cut] for x in xs], [x[:, cut:] for x in xs]


@pytest.mark.parametrize("d", [2, 7, 32])
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("b", [1, 3])
def test_mamba_scan_continuity(b, chunks, d):
    """Scanning chunk by chunk with the state carried equals one scan, and
    both equal the JAX package's ref."""
    s = chunks * 16
    *seq, a, h0 = _t(mamba_inputs(b, s, d, 4, seed=100 + b * d + chunks))
    y_full, h_full = mamba_scan(*seq, a, h0)
    h, ys = h0, []
    for c in range(chunks):
        y_c, h = mamba_scan(*[x[:, c * 16:(c + 1) * 16] for x in seq], a, h)
        ys.append(y_c)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, **TOL)
    torch.testing.assert_close(h, h_full, **TOL)
    y_ref, h_ref = mamba_scan_ref(*[jnp.asarray(x.numpy())
                                    for x in (*seq, a, h0)])
    _close(y_ref, y_full)
    _close(h_ref, h_full)


@pytest.mark.parametrize("d", [2, 7, 32])
@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("b", [1, 3])
def test_ssd_scan_continuity(b, chunks, d):
    """The same for the SSD scan, whose plain version is itself chunked:
    16-step calls with the state carried equal one call of chunk 32."""
    s = chunks * 16
    *seq, h0 = _t(ssd_inputs(b, s, 3, d, 8, seed=200 + b * d + chunks))
    y_full, h_full = ssd_scan(*seq, h0, chunk=32)
    h, ys = h0, []
    for c in range(chunks):
        y_c, h = ssd_scan(*[x[:, c * 16:(c + 1) * 16] for x in seq], h,
                          chunk=16)
        ys.append(y_c)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, **TOL)
    torch.testing.assert_close(h, h_full, **TOL)
    y_ref, h_ref = ssd_scan_ref(*[jnp.asarray(x.numpy())
                                  for x in (*seq, h0)], chunk=32)
    _close(y_ref, y_full)
    _close(h_ref, h_full)


def test_cpu_tensors_take_the_plain_scans():
    """On CPU tensors the dispatch runs the plain versions and leaves the
    launch counters alone; the launch wrappers refuse CPU tensors."""
    before = (mamba_kernel.mamba_scan_cuda.launches,
              ssd_kernel.ssd_scan_cuda.launches)
    m_in = _t(mamba_inputs(1, 3, 4, 2, seed=1))
    s_in = _t(ssd_inputs(1, 3, 2, 4, 2, seed=2))
    assert mamba_scan(*m_in)[0].shape == (1, 3, 4)
    assert ssd_scan(*s_in)[0].shape == (1, 3, 2, 4)
    assert (mamba_kernel.mamba_scan_cuda.launches,
            ssd_kernel.ssd_scan_cuda.launches) == before == (0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_kernel.mamba_scan_cuda(*m_in)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan_cuda(*s_in)


# -- blocks ---------------------------------------------------------------------


def _cfgs(family, kernels, dtype="float32"):
    f = FAMILIES[family]
    kw = dict(BASE, dtype=dtype, family=f["family"], group=f["group"],
              use_pallas_kernels=kernels)
    return (ModelConfig(arch_id="t-ssm", ssm=SSMConfig(**f["ssm"]), **kw),
            TModelConfig(arch_id="t-ssm", ssm=TSSMConfig(**f["ssm"]), **kw))


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_block_matches_jax_with_carried_state(kind, s, kernels):
    """Two calls in a row, the second fed the first's conv and ssm states,
    which start from nonzero values."""
    family = "mamba1" if kind == "mamba1" else "hybrid"
    cfg, tcfg = _cfgs(family, kernels)
    init, apply = ((jssm.mamba1_init, jssm.mamba1_apply) if kind == "mamba1"
                   else (jssm.mamba2_init, jssm.mamba2_apply))
    t_apply = tssm.mamba1_apply if kind == "mamba1" else tssm.mamba2_apply
    p = init(jax.random.PRNGKey(3), cfg)
    tp = _tree(jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(s)
    spec_conv = p["conv_w"].shape[1]
    d_in = cfg.ssm.expand * cfg.d_model
    state_shape = ((2, d_in, cfg.ssm.d_state) if kind == "mamba1" else
                   (2, d_in // cfg.ssm.head_dim, cfg.ssm.head_dim,
                    cfg.ssm.d_state))
    conv = rng.normal(size=(2, cfg.ssm.d_conv - 1, spec_conv)) \
        .astype(np.float32)
    state = rng.normal(size=state_shape).astype(np.float32) * 0.5
    j_st, t_st = (jnp.asarray(conv), jnp.asarray(state)), \
        (torch.from_numpy(conv), torch.from_numpy(state))
    for step in range(2):
        x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
        y1, j_st = apply(p, cfg, jnp.asarray(x), *j_st)
        y2, t_st = t_apply(tp, tcfg, torch.from_numpy(x), *t_st)
        _close(y1, y2)
        _close(j_st[0], t_st[0])
        _close(j_st[1], t_st[1])


# -- models ---------------------------------------------------------------------


def _pair(family, kernels):
    cfg, tcfg = _cfgs(family, kernels)
    m, tm = build_model(cfg), t_build_model(tcfg)
    params = m.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return m, params, tm, tparams


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_prefill_and_ragged_decode_match(family, kernels):
    m, params, tm, tparams = _pair(family, kernels)
    toks = np.random.default_rng(1).integers(0, 128, (2, 9)).astype(np.int32)
    c1 = m.init_cache(2, 32)
    c2 = tm.init_cache(2, 32, device="cpu")
    l1, c1 = m.prefill(params, {"tokens": jnp.asarray(toks[:, :6])}, c1)
    l2, c2 = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :6])},
                        c2)
    _close(l1, l2)
    # per-row lengths, as the batching scheduler produces
    c1["len"] = jnp.asarray([6, 4], jnp.int32)
    c2["len"] = torch.tensor([6, 4], dtype=torch.int32)
    for i in range(6, 9):
        d1, c1 = m.decode_step(params, c1, jnp.asarray(toks[:, i:i + 1]))
        d2, c2 = tm.decode_step(tparams, c2,
                                torch.from_numpy(toks[:, i:i + 1]))
        _close(d1, d2)
    np.testing.assert_array_equal(np.asarray(c1["len"]), c2["len"].numpy())
    for name in ("conv", "ssm"):
        _close(c1["group"]["b0"][name], c2["group"]["b0"][name])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cache_layout_matches_jax(family):
    """Leaf names, shapes and dtypes of the dense cache equal the JAX
    package's: conv in the config's dtype, ssm in float32, the group's
    leading reps axis, k/v stripes for the shared attention slot."""
    cfg, tcfg = _cfgs(family, False, dtype="bfloat16")
    c1 = build_model(cfg).init_cache(3, 16)
    c2 = t_build_model(tcfg).init_cache(3, 16, device="cpu")
    assert set(c1["group"]) == set(c2["group"])
    for slot, blk in c1["group"].items():
        assert set(blk) == set(c2["group"][slot])
        for name, leaf in blk.items():
            got = c2["group"][slot][name]
            assert tuple(got.shape) == leaf.shape, (slot, name)
            assert str(got.dtype).split(".")[-1] == str(leaf.dtype), \
                (slot, name)


def test_converted_params_keep_float32_ssm_leaves_and_shared_block():
    """In a bf16 config ``A_log``, ``D`` and ``dt_bias`` stay float32 (and
    exact), every other leaf is bf16, and the shared attention block is
    carried across once; the port's own init agrees on both."""
    cfg, tcfg = _cfgs("hybrid", False, dtype="bfloat16")
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), params)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    mamba = tp["stack"]["group"]["b0"][1]["mamba"]
    for name in ("A_log", "D", "dt_bias"):
        assert mamba[name].dtype == torch.float32
        np.testing.assert_array_equal(
            mamba[name].numpy(), tree["stack"]["group"]["b0"]["mamba"][name][1])
    assert mamba["z_proj"].dtype == torch.bfloat16
    shared = tp["stack"]["shared_attn"]
    np.testing.assert_array_equal(
        shared["attn"]["wq"].float().numpy(),
        tree["stack"]["shared_attn"]["attn"]["wq"])
    assert tp["stack"]["group"]["b2"] == []
    own = t_build_model(tcfg).init(device="cpu")
    assert own["stack"]["group"]["b2"] == []
    assert set(own["stack"]["shared_attn"]) == set(shared)
    for name in ("A_log", "D", "dt_bias"):
        assert own["stack"]["group"]["b1"][0]["mamba"][name].dtype \
            == torch.float32
    f32_m1 = t_build_model(_cfgs("mamba1", False, "bfloat16")[1]) \
        .init(device="cpu")["stack"]["group"]["b0"][0]["mamba"]
    np.testing.assert_allclose(
        f32_m1["A_log"].numpy(),
        np.log(np.tile(np.arange(1, 9, dtype=np.float32), (128, 1))))
