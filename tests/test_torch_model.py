"""The port's dense model (``repro_torch.models``) against ``repro``'s on
the same weights: prefill, dense / ragged / paged decode, the S=3 verify
window and bucketed-length prefill, with the decode kernel route on and
off on both sides (the JAX kernel in interpret mode, the port's through its
plain version on the CPU).  float32 throughout; atol = rtol = 1e-4 covers
the two frameworks' different summation orders in the matmuls."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig
from repro.models import build_model
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import build_model as t_build_model
from repro_torch.models.convert import params_from_numpy

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=128, dtype="float32", max_seq_len=64)
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(kernels: bool):
    cfg = ModelConfig(arch_id="tp", family="dense", **BASE,
                      use_pallas_kernels=kernels)
    tcfg = TModelConfig(arch_id="tp", family="dense", **BASE,
                        use_pallas_kernels=kernels)
    m, tm = build_model(cfg), t_build_model(tcfg)
    params = m.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                device="cpu")
    return m, params, tm, tparams


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


def _toks(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("ragged,width", [(False, 1), (True, 1), (True, 3)])
def test_prefill_and_dense_decode_match(kernels, ragged, width):
    m, params, tm, tparams = _pair(kernels)
    toks = _toks(2, 18)
    c1 = m.init_cache(2, 32)
    c2 = tm.init_cache(2, 32, device="cpu")
    l1, c1 = m.prefill(params, {"tokens": jnp.asarray(toks[:, :6])}, c1)
    l2, c2 = tm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :6])},
                        c2)
    _close(l1, l2)
    if ragged:
        # per-row lengths, as the batching scheduler produces
        c1["len"] = jnp.asarray([6, 4], jnp.int32)
        c2["len"] = torch.tensor([6, 4], dtype=torch.int32)
    i = 6
    for _ in range(3):
        d1, c1 = m.decode_step(params, c1, jnp.asarray(toks[:, i:i + width]))
        d2, c2 = tm.decode_step(tparams, c2,
                                torch.from_numpy(toks[:, i:i + width]))
        _close(d1, d2)
        i += width
    np.testing.assert_array_equal(np.asarray(c1["len"]), c2["len"].numpy())


@pytest.mark.parametrize("kernels", [False, True])
def test_paged_decode_matches(kernels):
    """Decode into a paged pool through shuffled block tables (vacancies
    at -1 and 0), ragged lengths, widths 5, 1 and 3."""
    m, params, tm, tparams = _pair(kernels)
    toks = _toks(2, 16, seed=3)
    tbl = np.array([[3, 1, 5, -1], [2, 8, 4, 0]], np.int32)
    c1 = m.init_cache(2, 32, page_size=8, n_pages=9)
    c2 = tm.init_cache(2, 32, page_size=8, n_pages=9, device="cpu")
    c1["pages"] = jnp.asarray(tbl)
    c2["pages"] = torch.from_numpy(tbl)
    c1["len"] = jnp.asarray([0, 0], jnp.int32)
    c2["len"] = torch.tensor([0, 0], dtype=torch.int32)
    i = 0
    for width in (5, 1, 1, 3):
        d1, c1 = m.decode_step(params, c1, jnp.asarray(toks[:, i:i + width]))
        d2, c2 = tm.decode_step(tparams, c2,
                                torch.from_numpy(toks[:, i:i + width]))
        _close(d1, d2)
        if width == 5:      # make the rows ragged
            c1["len"] = jnp.asarray([5, 3], jnp.int32)
            c2["len"] = torch.tensor([5, 3], dtype=torch.int32)
        i += width
    _close(c1["group"]["b0"]["k"], c2["group"]["b0"]["k"])


def test_bucketed_length_prefill_matches():
    """A prompt right-padded to a power-of-two bucket with a true
    ``length``: logits at the true last token, ``len`` = length."""
    m, params, tm, tparams = _pair(False)
    toks = _toks(1, 8, seed=5)
    c1 = m.init_cache(1, 32)
    c2 = tm.init_cache(1, 32, device="cpu")
    l1, c1 = m.prefill(params, {"tokens": jnp.asarray(toks),
                                "length": jnp.asarray(5, jnp.int32)}, c1)
    l2, c2 = tm.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                  "length": 5}, c2)
    _close(l1, l2)
    assert int(c2["len"]) == int(c1["len"]) == 5
    d1, c1 = m.decode_step(params, c1, jnp.asarray(toks[:, 5:6]))
    d2, c2 = tm.decode_step(tparams, c2, torch.from_numpy(toks[:, 5:6]))
    _close(d1, d2)


def test_rollback_rewinds_len():
    _, _, tm, _ = _pair(False)
    c = tm.init_cache(2, 32, device="cpu")
    c["len"] = torch.tensor([7, 3], dtype=torch.int32)
    assert tm.rollback(c, 2)["len"].tolist() == [5, 1]


def test_paged_cache_layout_matches_jax():
    """Pool leaves (reps, n_pages, ps, n_kv, dh), a (B, max_pages) table
    of trash-page zeros, and ``page_size_of`` reading ps back."""
    from repro.models.kvcache import page_size_of
    from repro_torch.models.kvcache import page_size_of as t_page_size_of
    m, _, tm, _ = _pair(False)
    c1 = m.init_cache(2, 32, page_size=8, n_pages=5)
    c2 = tm.init_cache(2, 32, page_size=8, n_pages=5, device="cpu")
    for name in ("k", "v"):
        assert tuple(c2["group"]["b0"][name].shape) == \
            c1["group"]["b0"][name].shape
    np.testing.assert_array_equal(np.asarray(c1["pages"]),
                                  c2["pages"].numpy())
    assert t_page_size_of(c2) == page_size_of(c1) == 8
    assert t_page_size_of(tm.init_cache(2, 32, device="cpu")) is None


def test_entry_points_default_to_the_card():
    """Without a card, init and init_cache refuse the default device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    tm = t_build_model(TModelConfig(arch_id="tp", family="dense", **BASE))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_cache(1, 32)


def test_unported_block_kinds_raise():
    """A block kind the JAX package does not know either is refused at
    ``build_model`` (every kind it knows builds in the port: the
    sliding-window, encoder-decoder and int8 paths are held to the
    reference in ``tests/test_torch_archs.py``)."""
    kw = dict(arch_id="tp-conv", family="dense", group=("conv",), **BASE)
    with pytest.raises(ValueError, match="unknown block kinds"):
        t_build_model(TModelConfig(**kw))
    with pytest.raises(ValueError, match="conv"):
        build_model(ModelConfig(**kw)).init(jax.random.PRNGKey(0))
