"""The port's decode attention (plain version, and the dispatch on the CPU)
against ``repro``'s Pallas kernel ``decode_attention_pallas`` in interpret
mode: paged through shuffled block tables with vacancies and contiguous,
S in {1, 3}, ragged lengths including 0, garbage in pages no row owns.
float32, atol 1e-5 (only the summation order differs).  The hand-written
kernel is held against the plain version in ``test_torch_kernels_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      gather_pages)
from torch_cases import B, PS, paged_case


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
