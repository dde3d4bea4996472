"""The port's packed masked argmax (plain version, and the dispatch on the
CPU) against ``repro``'s: the jnp oracle ``masked_argmax_ref`` and the
Pallas kernels ``masked_argmax_pallas_packed`` and ``masked_argmax_pallas``
in interpret mode; and the kernel's split plan (``argmax_plan``) and its
split-and-merge emulated on the CPU (``masked_argmax_split``).  Same inputs
from a numpy seed; idx and val must be equal (bitwise), including ties,
ties across a split edge, all-illegal rows, odd vocabulary sizes and
bfloat16 / float16 logits.  The hand-written kernel
is held against the plain version in ``test_torch_kernels_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.masked_sample.kernel import (masked_argmax_pallas,
                                                masked_argmax_pallas_packed)
from repro.kernels.masked_sample.ref import masked_argmax_ref
from repro_torch.kernels.masked_sample.ops import masked_argmax
from repro_torch.kernels.masked_sample.ref import (MAX_SPLIT, MIN_SPLIT,
                                                   ONE_BLOCK_V, ArgmaxPlan,
                                                   argmax_plan,
                                                   masked_argmax_ref as
                                                   t_masked_argmax_ref,
                                                   masked_argmax_split,
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


def _edge_case(b, v, split_len, seed):
    """``byte_mask_case`` rows with, in row 0, two legal tokens of an equal
    maximum on either side of the first split edge (the lower must win)."""
    logits, mask, words = byte_mask_case(b, v, seed)
    edge = min(split_len, v - 1)
    for t in (edge - 1, edge):
        logits[0, t] = 7.0
        mask[0, t] = True
        words[0, t // 32] |= np.uint32(1 << (t % 32))
    return logits, mask, words


@pytest.mark.parametrize("layout", ["packed", "bool"])
@pytest.mark.parametrize("split_len", [32, 1024, None])
@pytest.mark.parametrize("v", [31, 33, 4099, 8193])
def test_split_emulation_matches_jax(v, split_len, layout):
    """The kernel's split-and-merge, emulated on the CPU with the plan's
    splits (``None``) or narrower ones, against the JAX oracle and the
    Pallas kernel of the same layout (interpret mode, block_v=256),
    bitwise: ties at the maximum on either side of a split edge (row 0),
    an all-illegal row (1) and ties spread over every split (2)."""
    b = 3
    plan = argmax_plan(b, v) if split_len is None else \
        ArgmaxPlan(-(-v // split_len), split_len)
    logits, mask, words = _edge_case(b, v, plan.split_len, seed=v)
    m_np = words if layout == "packed" else mask
    m_t = torch.from_numpy(words.view(np.int32) if layout == "packed"
                           else mask)
    pallas = (masked_argmax_pallas_packed if layout == "packed"
              else masked_argmax_pallas)
    i_pl, v_pl = pallas(jnp.asarray(logits), jnp.asarray(m_np), block_v=256,
                        interpret=True)
    i_ref, v_ref = masked_argmax_ref(jnp.asarray(logits), jnp.asarray(m_np))
    i_s, v_s = masked_argmax_split(torch.from_numpy(logits), m_t, plan)
    for i_j, v_j in ((i_pl, v_pl), (i_ref, v_ref)):
        np.testing.assert_array_equal(i_s.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(v_s.numpy(), np.asarray(v_j))
    edge = min(plan.split_len, v - 1)
    assert i_s[0] == edge - 1 and v_s[0] == np.float32(7.0)
    assert i_s[1] == 0 and v_s[1] == np.float32(-1e30)
    assert i_s[2] == 0 and v_s[2] == np.float32(5.0)


@pytest.mark.parametrize("b", [1, 3, 4, 64, 200])
@pytest.mark.parametrize("v", [0, 1, 31, 33, 403, 4096, 4097, 8193, 32000,
                               100352, 129280, 262144, 10 ** 6])
def test_argmax_plan_covers(b, v):
    """Every token lies in exactly one split, edges fall on multiples of 32
    tokens, one split a row up to ``ONE_BLOCK_V`` tokens, and otherwise
    splits of ``MIN_SPLIT`` to ``MAX_SPLIT`` tokens."""
    plan = argmax_plan(b, v)
    assert plan.split_len % 32 == 0 and plan.split_len > 0
    assert (plan.n_split - 1) * plan.split_len < max(v, 1) \
        <= plan.n_split * plan.split_len
    if v <= ONE_BLOCK_V:
        assert plan.n_split == 1
    else:
        assert MIN_SPLIT <= plan.split_len <= MAX_SPLIT


@pytest.mark.parametrize("b,v,blocks", [(4, 100352, 264), (4, 129280, 264),
                                        (64, 262144, 512), (4, 403, 4)])
def test_argmax_plan_of_the_models(b, v, blocks):
    """About two blocks an SM of the card's 132 at B=4 and the models' real
    vocabularies; 32768-token splits at B=64, V=262144; one block a row at
    the smoke's 403 tokens."""
    plan = argmax_plan(b, v)
    assert b * plan.n_split == blocks


@pytest.mark.parametrize("layout", ["packed", "bool"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("v", [403, 4099])
def test_half_logits_match_jax_kernels(v, dtype, layout):
    """bfloat16 and float16 logits through the port's op (on the CPU, its
    plain version) and the split emulation against the Pallas kernel of the
    same layout and the JAX oracle on the same values, bitwise: both widen
    to float32 before they compare."""
    b = 3
    logits, mask, words = _edge_case(b, v, argmax_plan(b, v).split_len,
                                     seed=v + 1)
    lg_t = torch.from_numpy(logits).to(getattr(torch, dtype))
    lg_j = jnp.asarray(lg_t.float().numpy()).astype(getattr(jnp, dtype))
    m_np = words if layout == "packed" else mask
    m_t = torch.from_numpy(words.view(np.int32) if layout == "packed"
                           else mask)
    pallas = (masked_argmax_pallas_packed if layout == "packed"
              else masked_argmax_pallas)
    i_pl, v_pl = pallas(lg_j, jnp.asarray(m_np), block_v=256, interpret=True)
    i_ref, v_ref = masked_argmax_ref(lg_j, jnp.asarray(m_np))
    i_t, v_t = masked_argmax(lg_t, m_t)
    i_s, v_s = masked_argmax_split(lg_t, m_t, argmax_plan(b, v))
    assert v_t.dtype == torch.float32
    for i_j, v_j in ((i_pl, v_pl), (i_ref, v_ref)):
        for i_p, v_p in ((i_t, v_t), (i_s, v_s)):
            np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
            np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_j))
