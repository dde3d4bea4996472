"""The port's decode attention (plain version, and the dispatch on the CPU)
against ``repro``'s Pallas kernel ``decode_attention_pallas`` in interpret
mode: paged through shuffled block tables with vacancies and contiguous,
S in {1, 3}, windows of more than 16 query rows (Qh = 7, S in {3, 9}),
ragged lengths including 0, garbage in pages no row owns.
float32, atol 1e-5 (only the summation order differs).  The plain-score
kernel's key-split algorithm (per-split partial states, then their merge)
is held against both in plain PyTorch, and its plan shown to depend on
shapes alone.  The hand-written kernel is held against the plain version
in ``test_torch_kernels_cuda.py``."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (
    MAX_SPLIT_PAGES, TILE_KEYS, decode_attention_ref, gather_pages,
    key_split_partials, key_split_plan, merge_key_splits)
from torch_cases import B, MP, PS, paged_case


@pytest.mark.parametrize("s_win", [1, 3])
def test_paged_matches_jax_kernel(s_win):
    q, kp, vp, ln, tbl = paged_case(s_win, seed=s_win)
    want = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ln),
        interpret=True, block_tables=jnp.asarray(tbl))
    qq = q[:, 0] if s_win == 1 else q            # rank-4 S=1 form too
    got = decode_attention(torch.from_numpy(qq), torch.from_numpy(kp),
                           torch.from_numpy(vp), torch.from_numpy(ln),
                           block_tables=torch.from_numpy(tbl))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(),
                               want[:, 0] if s_win == 1 else want,
                               atol=1e-5, rtol=0)
    if s_win == 1:                               # row 0 sees no key
        assert np.all(got.numpy()[0] == 0)


@pytest.mark.parametrize("s_win", [1, 3])
def test_contiguous_matches_jax_kernel(s_win):
    q, kp, vp, ln, tbl = paged_case(s_win, seed=10 + s_win)
    kd = gather_pages(torch.from_numpy(kp), torch.from_numpy(tbl)).numpy()
    vd = gather_pages(torch.from_numpy(vp), torch.from_numpy(tbl)).numpy()
    want = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), jnp.asarray(ln),
        block_t=PS, interpret=True)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kd),
                           torch.from_numpy(vd), torch.from_numpy(ln))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_scalar_length_broadcasts():
    q, kp, vp, _, tbl = paged_case(1, seed=5)
    kd = gather_pages(torch.from_numpy(kp), torch.from_numpy(tbl))
    vd = gather_pages(torch.from_numpy(vp), torch.from_numpy(tbl))
    a = decode_attention_ref(torch.from_numpy(q), kd, vd, 7)
    b = decode_attention_ref(torch.from_numpy(q), kd, vd,
                             torch.full((B,), 7, dtype=torch.int32))
    assert torch.equal(a, b)


# Lengths for the key-split cases, over PS = 8-key pages and MP * PS = 64
# keys of capacity: 0 (no key), 16 and 32 (on page and split boundaries of
# 8- and 16-key splits), 7 (every split after the first wholly past the
# frontier); and with S = 3, windows 15..17 and 30..32 that cross split
# boundaries, 61..63 up to the capacity.
SPLIT_LENS = {"boundaries": [0, 16, 32, 7], "windows": [0, 15, 30, 61]}


def _split_merge(q, k, v, ln, split_len, block_tables=None):
    cap = k.shape[1] * (1 if block_tables is None else block_tables.shape[1])
    n_split = -(-cap // split_len)
    m, l, acc = key_split_partials(q, k, v, ln, n_split, split_len,
                                   block_tables=block_tables)
    assert m.shape[0] == n_split
    return merge_key_splits(m, l, acc, q.dtype), (m, l, acc)


@pytest.mark.parametrize("lens", sorted(SPLIT_LENS))
@pytest.mark.parametrize("qh", [1, 2])
@pytest.mark.parametrize("s_win", [1, 3])
@pytest.mark.parametrize("paged", [True, False])
def test_key_split_merge_matches_jax_kernel(paged, s_win, qh, lens):
    """Partials over 8-, 16-, 24- and 64-key splits, merged, equal the plain
    version and the Pallas kernel in interpret mode."""
    q, kp, vp, ln, tbl = paged_case(s_win, seed=40 + s_win + 2 * qh,
                                    lens=SPLIT_LENS[lens], qh=qh)
    qt, kt, vt, lt, tt = map(torch.from_numpy, (q, kp, vp, ln, tbl))
    if paged:
        want = decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(ln), interpret=True, block_tables=jnp.asarray(tbl))
        ref = decode_attention_ref(qt, kt, vt, lt, block_tables=tt)
    else:
        kt, vt = gather_pages(kt, tt), gather_pages(vt, tt)
        tt = None
        want = decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(kt.numpy()), jnp.asarray(vt.numpy()),
            jnp.asarray(ln), block_t=PS, interpret=True)
        ref = decode_attention_ref(qt, kt, vt, lt)
    want = np.asarray(want)
    np.testing.assert_allclose(ref.numpy(), want, atol=1e-5, rtol=0)
    for split_len in (8, 16, 24, 64):
        got, (m, l, acc) = _split_merge(qt, kt, vt, lt, split_len, tt)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=0)
        assert torch.all(got[0, 0] == 0)         # row 0 sees no key at s=0
        # a split wholly past a row's frontier holds the empty state
        front = np.minimum(ln + s_win - 1, MP * PS)
        for j in range(m.shape[0]):
            dead = j * split_len >= front
            assert torch.all(m[j][torch.from_numpy(dead)] == -1e30)
            assert torch.all(l[j][torch.from_numpy(dead)] == 0)
            assert torch.all(acc[j][torch.from_numpy(dead)] == 0)


@pytest.mark.parametrize("b,g,ps,n_tiles,paged,want", [
    (4, 32, 64, 16, True, (4, 256)),      # stablelm's paged decode
    (4, 32, 1024, 1, False, (4, 256)),    # zamba2's contiguous stripes
    (4, 32, 64, 20, True, (5, 256)),      # 1000 keys a row
    (4, 32, 64, 64, True, (5, 832)),      # 4096 keys a row
    (1, 1, 8, 8, True, (1, 64)),          # one tile of capacity
    (1, 2, 1, 4096, True, (64, 64)),      # one-key pages
    (64, 64, 16, 512, True, (5, 1984)),   # wide batch: one split's pages
    (2, 4, 4096, 1, False, (64, 64)),
])
def test_key_split_plan(b, g, ps, n_tiles, paged, want):
    """The plan covers the capacity in whole tiles, spans at most
    MAX_SPLIT_PAGES table entries a split, and aims for many blocks."""
    n_split, split_len = key_split_plan(b, g, ps, n_tiles, paged)
    assert (n_split, split_len) == want
    cap = ps * n_tiles
    assert split_len % TILE_KEYS == 0
    assert (n_split - 1) * split_len < cap <= n_split * split_len
    if paged:
        assert (split_len - 1) // ps + 2 <= MAX_SPLIT_PAGES


def test_key_split_plan_depends_on_shapes_only():
    """The plan takes the shapes and nothing else, so the card never has to
    report the lengths: rows of any lengths at stablelm's decode shapes get
    one plan, and its partials merge to the plain version for each."""
    params = list(inspect.signature(key_split_plan).parameters)
    assert params == ["b", "g", "page_size", "n_tiles", "paged"]
    plan = key_split_plan(4, 32, 64, 16, True)
    rng = np.random.default_rng(7)
    for lens in ([0, 0, 0, 0], [51, 25, 24, 29], [1024, 1, 128, 129],
                 list(rng.integers(0, 1025, 4))):
        q, kp, vp, ln, tbl = paged_case(1, seed=9, lens=lens, qh=1, g=32,
                                        d=16, ps=64, mp=16)
        assert key_split_plan(q.shape[0], q.shape[2], kp.shape[1],
                              tbl.shape[1], True) == plan
        qt, kt, vt, lt, tt = map(torch.from_numpy, (q, kp, vp, ln, tbl))
        got, _ = _split_merge(qt, kt, vt, lt, plan[1], tt)
        want = decode_attention_ref(qt, kt, vt, lt, block_tables=tt)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("s_win", [3, 9])
def test_wide_window_matches_jax_kernel(s_win, paged):
    """Windows of more than 16 query rows: Qh = 7 (yi-34b's and
    arctic-480b's 56 heads over 8 kv heads) at S = 3 and at a 9-token
    verify window, 21 and 63 rows.  The plain version, and the key-split
    partials merged over 8- and 24-key splits, against the Pallas kernel in
    interpret mode."""
    q, kp, vp, ln, tbl = paged_case(s_win, seed=70 + s_win, qh=7)
    qt, kt, vt, lt, tt = map(torch.from_numpy, (q, kp, vp, ln, tbl))
    if paged:
        want = decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(ln), interpret=True, block_tables=jnp.asarray(tbl))
    else:
        kt, vt = gather_pages(kt, tt), gather_pages(vt, tt)
        tt = None
        want = decode_attention_pallas(
            jnp.asarray(q), jnp.asarray(kt.numpy()), jnp.asarray(vt.numpy()),
            jnp.asarray(ln), block_t=PS, interpret=True)
    want = np.asarray(want)
    got = decode_attention(qt, kt, vt, lt, block_tables=tt)
    assert got.shape == (B, s_win, 2, 7, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    for split_len in (8, 24):
        merged, _ = _split_merge(qt, kt, vt, lt, split_len, tt)
        np.testing.assert_allclose(merged.numpy(), want, atol=1e-5, rtol=0)
    assert torch.all(got[0, 0] == 0)             # row 0 sees no key at s=0
