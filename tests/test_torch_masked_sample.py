"""The port's packed masked argmax (plain version, and the dispatch on the
CPU) against ``repro``'s: the jnp oracle ``masked_argmax_ref`` and the
Pallas kernel ``masked_argmax_pallas_packed`` in interpret mode.  Same
inputs from a numpy seed; idx and val must be equal (bitwise), including
ties, all-illegal rows and odd vocabulary sizes.  The hand-written kernel
is held against the plain version in ``test_torch_kernels_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.masked_sample.kernel import (masked_argmax_pallas,
                                                masked_argmax_pallas_packed)
from repro.kernels.masked_sample.ref import masked_argmax_ref
from repro_torch.kernels.masked_sample.ops import masked_argmax
from repro_torch.kernels.masked_sample.ref import (masked_argmax_ref as
                                                   t_masked_argmax_ref,
                                                   unpack_bits)
from torch_cases import byte_mask_case, mask_case


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("v", [1, 31, 32, 33, 420, 4099])
def test_plain_version_matches_jax(b, v):
    logits, words = mask_case(b, v, seed=v * 10 + b)
    i_ref, v_ref = masked_argmax_ref(jnp.asarray(logits), jnp.asarray(words))
    i_pl, v_pl = masked_argmax_pallas_packed(
        jnp.asarray(logits), jnp.asarray(words), block_v=256,
        interpret=True)
    i_t, v_t = masked_argmax(torch.from_numpy(logits),
                             torch.from_numpy(words.view(np.int32)))
    assert i_t.dtype == torch.int32 and v_t.dtype == torch.float32
    for i_j, v_j in ((i_ref, v_ref), (i_pl, v_pl)):
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    if b > 1:
        assert i_t[1] == 0 and v_t[1] == np.float32(-1e30)


def test_byte_mask_matches_packed_on_cpu():
    logits, words = mask_case(3, 420, seed=9)
    bits = torch.from_numpy(words.view(np.int32))
    mask = unpack_bits(bits, 420)
    a = t_masked_argmax_ref(torch.from_numpy(logits), bits)
    c = t_masked_argmax_ref(torch.from_numpy(logits), mask)
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


def test_unpack_reads_the_sign_bit():
    words = torch.tensor([[np.int32(-2 ** 31), 1]], dtype=torch.int32)
    got = unpack_bits(words, 40)
    assert got[0].nonzero().flatten().tolist() == [31, 32]


@pytest.mark.parametrize("mask_dtype", ["bool", "int8"])
@pytest.mark.parametrize("b,v", [(3, 31), (3, 403), (4, 4099)])
def test_byte_mask_matches_jax_kernel(b, v, mask_dtype):
    """A (B, V) bool/int8 mask through the port's op on the CPU against the
    JAX byte-mask kernel (interpret mode) and oracle, bitwise, and against
    the packed form of the same mask: row 1 all illegal, row 2 ties."""
    logits, mask, words = byte_mask_case(b, v, seed=v + b)
    mask = mask.astype(mask_dtype)
    if mask_dtype == "int8":
        mask = mask * np.int8(-3)            # any nonzero byte is legal
    i_pl, v_pl = masked_argmax_pallas(jnp.asarray(logits), jnp.asarray(mask),
                                      block_v=256, interpret=True)
    i_ref, v_ref = masked_argmax_ref(jnp.asarray(logits), jnp.asarray(mask))
    i_t, v_t = masked_argmax(torch.from_numpy(logits), torch.from_numpy(mask))
    i_p, v_p = masked_argmax(torch.from_numpy(logits),
                             torch.from_numpy(words.view(np.int32)))
    for i_j, v_j in ((i_pl, v_pl), (i_ref, v_ref)):
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert torch.equal(i_t, i_p) and torch.equal(v_t, v_p)
    assert i_t[1] == 0 and v_t[1] == np.float32(-1e30)
    assert i_t[2] == 0 and v_t[2] == np.float32(5.0)    # first of the ties
