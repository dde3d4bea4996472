"""The port's multi-head latent attention against ``repro``'s on the same
weights and inputs: ``mla_compress``, full MLA (prefill), absorbed MLA
(decode) on its plain route and on its kernel route (the JAX split-score
kernel in interpret mode, the port's plain version on the CPU), the
split-score decode attention itself (paged and contiguous, S in {1, 2},
split == concatenated), the bfloat16 kernel's key-split algorithm in plain
PyTorch (partials and merge, S in {1, 2, 9}, its plan from shapes alone),
and the ``mla`` and ``mla-moe`` model configs
through prefill and dense, ragged and paged decode.  float32; atol = rtol
= 1e-4 (the two frameworks sum the matmuls in other orders)."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.models import build_model
from repro.models import layers as jl
from repro_torch.configs.base import MLAConfig as TMLAConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (
    MAX_SCORE_SPLIT_PAGES, MAX_SCORE_SPLITS, SCORE_TILE_KEYS,
    decode_attention_ref, gather_pages, key_split_partials, merge_key_splits,
    split_score_plan)
from repro_torch.models import build_model as t_build_model
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_numpy
from torch_cases import MP, PS, split_case

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
            vocab_size=128, dtype="float32", max_seq_len=64)
MLA = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
           qk_rope_head_dim=8, v_head_dim=16)
MOE = dict(n_experts=4, top_k=2, d_ff_expert=64, n_shared_experts=1,
           capacity_factor=2.0)
# tests/test_paged_kv.py's "mla" (dense family) and tests/test_models.py's
# "mla-moe"
ARCHS = {
    "mla": dict(family="dense", group=("mla",)),
    "mla-moe": dict(family="moe", group=("moe",), moe=MOE),
}


def _pair(arch="mla-moe", kernels=False):
    a = ARCHS[arch]
    kw = dict(BASE, arch_id=f"tm-{arch}", family=a["family"],
              group=a["group"], use_pallas_kernels=kernels)
    cfg = ModelConfig(mla=MLAConfig(**MLA), moe=(MoEConfig(**a["moe"])
                                                 if "moe" in a else None),
                      **kw)
    tcfg = TModelConfig(mla=TMLAConfig(**MLA),
                        moe=(TMoEConfig(**a["moe"]) if "moe" in a else None),
                        **kw)
    m, tm = build_model(cfg), t_build_model(tcfg)
    params = m.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return m, params, tm, tparams


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


def _layer0(params, tparams):
    """Layer 0's MLA params on both sides."""
    jp = jax.tree.map(lambda a: a[0], params["stack"]["group"]["b0"]["mla"])
    return jp, tparams["stack"]["group"]["b0"][0]["mla"]


def _x(b, s, seed):
    return np.random.default_rng(seed).normal(size=(b, s, 64)).astype(
        np.float32)


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


def test_mla_compress_matches():
    m, params, tm, tparams = _pair()
    jp, tp = _layer0(params, tparams)
    x, pos = _x(2, 5, 1), _pos(2, 5, 3)
    c1, r1 = jl.mla_compress(jp, m.cfg, jnp.asarray(x), jnp.asarray(pos))
    c2, r2 = tl.mla_compress(tp, tm.cfg, torch.from_numpy(x),
                             torch.from_numpy(pos))
    assert tuple(r2.shape) == r1.shape == (2, 5, 1, 8)
    _close(c1, c2)
    _close(r1, r2)


def test_mla_apply_matches():
    """Full MLA (Dk = 24 != Dv = 16) with a key-validity mask."""
    m, params, tm, tparams = _pair()
    jp, tp = _layer0(params, tparams)
    x, pos = _x(2, 7, 2), _pos(2, 7)
    valid = np.ones((2, 7), bool)
    valid[1, 5:] = False
    lat1 = jl.mla_compress(jp, m.cfg, jnp.asarray(x), jnp.asarray(pos))
    lat2 = tl.mla_compress(tp, tm.cfg, torch.from_numpy(x),
                           torch.from_numpy(pos))
    o1 = jl.mla_apply(jp, m.cfg, jnp.asarray(x), jnp.asarray(pos), lat1,
                      jnp.asarray(pos), jnp.asarray(valid))
    o2 = tl.mla_apply(tp, tm.cfg, torch.from_numpy(x), torch.from_numpy(pos),
                      lat2, torch.from_numpy(pos), torch.from_numpy(valid))
    _close(o1, o2)


@pytest.mark.parametrize("s_win", [1, 2])
@pytest.mark.parametrize("route", ["plain", "kernel", "kernel-paged"])
def test_mla_apply_absorbed_matches(route, s_win):
    """Absorbed MLA of an S-token window over ragged latents: the plain
    read (dense latents, validity mask), or the split-score kernel route
    over contiguous stripes or a paged pool."""
    kernels = route != "plain"
    m, params, tm, tparams = _pair(kernels=kernels)
    jp, tp = _layer0(params, tparams)
    rng = np.random.default_rng(3 + s_win)
    b, t = 2, 24
    lens = np.array([13, 6], np.int32)          # keys before the window
    ckv = rng.normal(size=(b, t, 16)).astype(np.float32)
    krope = rng.normal(size=(b, t, 1, 8)).astype(np.float32)
    x = _x(b, s_win, 4 + s_win)
    q_pos = lens[:, None] + np.arange(s_win, dtype=np.int32)[None]
    if route == "plain":
        k_pos = _pos(b, t)
        valid = k_pos < (lens[:, None] + s_win)
        o1 = jl.mla_apply_absorbed(jp, m.cfg, jnp.asarray(x),
                                   jnp.asarray(q_pos),
                                   (jnp.asarray(ckv), jnp.asarray(krope)),
                                   jnp.asarray(k_pos), jnp.asarray(valid))
        o2 = tl.mla_apply_absorbed(tp, tm.cfg, torch.from_numpy(x),
                                   torch.from_numpy(q_pos),
                                   (torch.from_numpy(ckv),
                                    torch.from_numpy(krope)),
                                   torch.from_numpy(k_pos),
                                   torch.from_numpy(valid))
        _close(o1, o2)
        return
    tbl = None
    lat = (ckv, krope)
    if route == "kernel-paged":
        ps = 8
        tbl = np.array([[4, 1, 6], [2, 0, -1]], np.int32)
        pools = [np.full((7, ps) + a.shape[2:], 1e3, np.float32)
                 for a in lat]
        for i in range(b):
            for j, pg in enumerate(tbl[i]):
                if pg > 0:
                    for pool, a in zip(pools, lat):
                        pool[pg] = a[i, j * ps:(j + 1) * ps]
        lat = tuple(pools)
    ln = lens + 1                               # the kernel route's lengths
    o1 = jl.mla_apply_absorbed(
        jp, m.cfg, jnp.asarray(x), jnp.asarray(q_pos),
        tuple(jnp.asarray(a) for a in lat), None, None,
        lengths=jnp.asarray(ln),
        block_tables=None if tbl is None else jnp.asarray(tbl))
    o2 = tl.mla_apply_absorbed(
        tp, tm.cfg, torch.from_numpy(x), torch.from_numpy(q_pos),
        tuple(torch.from_numpy(a) for a in lat), None, None,
        lengths=torch.from_numpy(ln),
        block_tables=None if tbl is None else torch.from_numpy(tbl))
    _close(o1, o2)


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("s_win", [1, 2])
def test_split_decode_attention_matches_jax_kernel(s_win, paged):
    """The split-score plain version (and the dispatch on the CPU) against
    the JAX kernel in interpret mode, garbage in pages no row owns."""
    q, q2, lat, rp, ln, tbl = split_case(s_win, seed=30 + s_win)
    scale = 0.19
    if not paged:
        t_tbl = torch.from_numpy(tbl)
        lat = gather_pages(torch.from_numpy(lat), t_tbl).numpy()
        rp = gather_pages(torch.from_numpy(rp), t_tbl).numpy()
    kw = dict(block_tables=jnp.asarray(tbl)) if paged else dict(block_t=PS)
    want = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(lat), jnp.asarray(lat), jnp.asarray(ln),
        interpret=True, scale=scale, q2=jnp.asarray(q2), k2=jnp.asarray(rp),
        **kw)
    lat_t = torch.from_numpy(lat)
    got = decode_attention(torch.from_numpy(q), lat_t, lat_t,
                           torch.from_numpy(ln), scale=scale,
                           q2=torch.from_numpy(q2), k2=torch.from_numpy(rp),
                           block_tables=(torch.from_numpy(tbl) if paged
                                         else None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert np.all(got.numpy()[0, 0] == 0)       # row 0, position 0: no key


def test_split_equals_concatenated():
    """Split score == one score over [q || q2] . [k || k2], values = k."""
    q, q2, lat, rp, ln, tbl = split_case(2, seed=40)
    t = torch.from_numpy
    split = decode_attention_ref(t(q), t(lat), t(lat), t(ln), scale=0.3,
                                 q2=t(q2), k2=t(rp), block_tables=t(tbl))
    cat = decode_attention_ref(
        torch.cat([t(q), t(q2)], -1),
        torch.cat([t(lat), t(rp)], -1), t(lat), t(ln), scale=0.3,
        block_tables=t(tbl))
    torch.testing.assert_close(split, cat, atol=1e-5, rtol=1e-5)


# Lengths for the split-score key-split cases, over PS = 8-key pages and
# MP * PS = 64 keys of capacity: 0 (no key), 16 and 32 (on page and split
# boundaries), 7 (every split after the first wholly past the frontier);
# and windows from 15, 30 and 55 that cross split boundaries (55 + 8 = 63
# keys at S = 9, one short of the capacity).
SCORE_LENS = {"boundaries": [0, 16, 32, 7], "windows": [0, 15, 30, 55]}


def _score_split_merge(q, q2, lat, rp, ln, split_len, scale, tbl=None):
    cap = lat.shape[1] * (1 if tbl is None else tbl.shape[1])
    n_split = -(-cap // split_len)
    m, l, acc = key_split_partials(q, lat, lat, ln, n_split, split_len,
                                   scale=scale, block_tables=tbl, q2=q2,
                                   k2=rp)
    assert m.shape[0] == n_split
    return merge_key_splits(m, l, acc, q.dtype), (m, l, acc)


@pytest.mark.parametrize("lens", sorted(SCORE_LENS))
@pytest.mark.parametrize("s_win", [1, 2, 9])
@pytest.mark.parametrize("paged", [True, False])
def test_split_score_key_split_matches_jax_kernel(paged, s_win, lens):
    """The split score's partials over 8-, 16-, 32- and 64-key splits,
    merged, equal the Pallas kernel in interpret mode (and the plain
    version); a split wholly past a row's frontier holds the empty state."""
    q, q2, lat, rp, ln, tbl = split_case(s_win, seed=80 + s_win, h=3,
                                         lens=SCORE_LENS[lens])
    scale = 0.19
    t = torch.from_numpy
    tt = t(tbl)
    if not paged:
        lat = gather_pages(t(lat), tt).numpy()
        rp = gather_pages(t(rp), tt).numpy()
        tt = None
    kw = dict(block_tables=jnp.asarray(tbl)) if paged else dict(block_t=PS)
    want = np.asarray(decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(lat), jnp.asarray(lat), jnp.asarray(ln),
        interpret=True, scale=scale, q2=jnp.asarray(q2), k2=jnp.asarray(rp),
        **kw))
    ref = decode_attention_ref(t(q), t(lat), t(lat), t(ln), scale=scale,
                               q2=t(q2), k2=t(rp), block_tables=tt)
    np.testing.assert_allclose(ref.numpy(), want, atol=1e-5, rtol=0)
    for split_len in (8, 16, 32, 64):
        got, (m, l, acc) = _score_split_merge(t(q), t(q2), t(lat), t(rp),
                                              t(ln), split_len, scale, tt)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        assert torch.all(got[0, 0] == 0)         # row 0 sees no key at s=0
        front = np.minimum(ln + s_win - 1, MP * PS)
        for j in range(m.shape[0]):
            dead = torch.from_numpy(j * split_len >= front)
            assert torch.all(m[j][dead] == -1e30)
            assert torch.all(l[j][dead] == 0)
            assert torch.all(acc[j][dead] == 0)


@pytest.mark.parametrize("b,g,rows,ps,n_tiles,paged,want", [
    (4, 1, 128, 64, 16, True, (8, 128)),     # deepseek-v3's decode, main
    (4, 1, 128, 64, 20, True, (8, 160)),     # 1000 keys a row
    (4, 1, 128, 64, 256, True, (8, 2048)),   # 16384 keys a row
    (4, 1, 1152, 64, 16, True, (1, 1024)),   # a 9-token window: 144 blocks
    (4, 1, 96, 64, 16, True, (11, 96)),      # 12 blocks a split
    (4, 1, 6, 8, 8, True, (2, 32)),          # the small test case
    (4, 1, 128, 1, 8192, True, (18, 480)),   # one-key pages: span capped
    (1, 1, 16, 1, 4096, True, (64, 64)),     # one block a split: 64 splits
    (2, 1, 16, 4096, 1, False, (64, 64)),    # contiguous: split count capped
])
def test_split_score_plan(b, g, rows, ps, n_tiles, paged, want):
    """The plan covers the capacity in whole tiles, spans at most
    MAX_SCORE_SPLIT_PAGES table entries a split, takes at most
    MAX_SCORE_SPLITS splits, and aims for many blocks."""
    n_split, split_len = split_score_plan(b, g, rows, ps, n_tiles, paged)
    assert (n_split, split_len) == want
    cap = ps * n_tiles
    assert split_len % SCORE_TILE_KEYS == 0
    assert (n_split - 1) * split_len < cap <= n_split * split_len
    assert n_split <= MAX_SCORE_SPLITS
    if paged:
        assert (split_len - 1) // ps + 2 <= MAX_SCORE_SPLIT_PAGES


def test_split_score_plan_depends_on_shapes_only():
    """The plan takes the shapes and nothing else, so the card never has to
    report the lengths: rows of any lengths get one plan, and its partials
    merge to the plain version for each."""
    params = list(inspect.signature(split_score_plan).parameters)
    assert params == ["b", "g", "rows", "page_size", "n_tiles", "paged"]
    plan = split_score_plan(4, 1, 2 * 3, PS, MP, True)
    assert plan[0] > 1
    rng = np.random.default_rng(11)
    for lens in ([0, 0, 0, 0], [51, 25, 1, 1], [63, 1, 32, 33],
                 list(rng.integers(0, 63, 4))):
        q, q2, lat, rp, ln, tbl = split_case(2, seed=12, h=3, lens=lens)
        assert split_score_plan(q.shape[0], q.shape[2],
                                q.shape[1] * q.shape[3], lat.shape[1],
                                tbl.shape[1], True) == plan
        t = torch.from_numpy
        got, _ = _score_split_merge(t(q), t(q2), t(lat), t(rp), t(ln),
                                    plan[1], 0.25, t(tbl))
        want = decode_attention_ref(t(q), t(lat), t(lat), t(ln), scale=0.25,
                                    q2=t(q2), k2=t(rp), block_tables=t(tbl))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)


def _toks(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("ragged,width", [(False, 1), (True, 1), (True, 3)])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_prefill_and_dense_decode_match(arch, kernels, ragged, width):
    m, params, tm, tparams = _pair(arch, kernels)
    toks = _toks(2, 18)
    c1 = m.init_cache(2, 32)
    c2 = tm.init_cache(2, 32, device="cpu")
    l1, c1 = m.prefill(params, {"tokens": jnp.asarray(toks[:, :6])}, c1)
    l2, c2 = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :6])},
                        c2)
    _close(l1, l2)
    if ragged:
        c1["len"] = jnp.asarray([6, 4], jnp.int32)
        c2["len"] = torch.tensor([6, 4], dtype=torch.int32)
    i = 6
    for _ in range(3):
        d1, c1 = m.decode_step(params, c1, jnp.asarray(toks[:, i:i + width]))
        d2, c2 = tm.decode_step(tparams, c2,
                                torch.from_numpy(toks[:, i:i + width]))
        _close(d1, d2)
        i += width
    for name in ("ckv", "krope"):
        _close(c1["group"]["b0"][name], c2["group"]["b0"][name])


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_paged_decode_matches(arch, kernels):
    """Decode into paged latent/rope pools through shuffled block tables
    (vacancies at -1 and 0), ragged lengths, widths 5, 1 and 2."""
    m, params, tm, tparams = _pair(arch, kernels)
    toks = _toks(2, 16, seed=3)
    tbl = np.array([[3, 1, 5, -1], [2, 8, 4, 0]], np.int32)
    c1 = m.init_cache(2, 32, page_size=8, n_pages=9)
    c2 = tm.init_cache(2, 32, page_size=8, n_pages=9, device="cpu")
    c1["pages"], c2["pages"] = jnp.asarray(tbl), torch.from_numpy(tbl)
    c1["len"] = jnp.asarray([0, 0], jnp.int32)
    c2["len"] = torch.tensor([0, 0], dtype=torch.int32)
    i = 0
    for width in (5, 1, 1, 2):
        d1, c1 = m.decode_step(params, c1, jnp.asarray(toks[:, i:i + width]))
        d2, c2 = tm.decode_step(tparams, c2,
                                torch.from_numpy(toks[:, i:i + width]))
        _close(d1, d2)
        if width == 5:
            c1["len"] = jnp.asarray([5, 3], jnp.int32)
            c2["len"] = torch.tensor([5, 3], dtype=torch.int32)
        i += width
    _close(c1["group"]["b0"]["ckv"], c2["group"]["b0"]["ckv"])


@pytest.mark.parametrize("paged", [False, True])
def test_mla_cache_layout_matches_jax(paged):
    m, _, tm, _ = _pair()
    kw = dict(page_size=8, n_pages=5) if paged else {}
    c1 = m.init_cache(2, 32, **kw)
    c2 = tm.init_cache(2, 32, device="cpu", **kw)
    assert set(c2["group"]["b0"]) == set(c1["group"]["b0"]) == \
        {"ckv", "krope"}
    for name in ("ckv", "krope"):
        assert tuple(c2["group"]["b0"][name].shape) == \
            c1["group"]["b0"][name].shape


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def test_kernel_route_bf16_casts_like_plain():
    """In bfloat16 the kernel route's context is cast to the activation
    dtype, as the plain route's is: both give bfloat16 of one shape and
    agree to bfloat16 rounding."""
    _, _, tm, tparams = _pair()
    cfg = dataclasses.replace(tm.cfg, dtype="bfloat16")
    tp = _cast(tparams["stack"]["group"]["b0"][0]["mla"], torch.bfloat16)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_x(2, 1, 7)).to(torch.bfloat16)
    lat = tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                .to(torch.bfloat16) for shape in ((2, 8, 16), (2, 8, 1, 8)))
    pos = torch.tensor([[5], [3]], dtype=torch.int32)
    k_pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    plain = tl.mla_apply_absorbed(tp, cfg, x, pos, lat, k_pos,
                                  k_pos < pos + 1)
    kern = tl.mla_apply_absorbed(
        tp, dataclasses.replace(cfg, use_pallas_kernels=True), x, pos, lat,
        None, None, lengths=pos[:, 0] + 1)
    assert plain.dtype == kern.dtype == torch.bfloat16
    assert plain.shape == kern.shape == (2, 1, 64)
    torch.testing.assert_close(kern.float(), plain.float(), atol=0.1,
                               rtol=0.05)
