"""The Mamba2 SSD scan kernel's host side and the plain version of its
chunked path, on the CPU:

 - ``ssd_plan``: the path and slices the kernel takes from shapes alone
   (decode at S = 1; slices of the D rows otherwise), at zamba2-1.2b's
   width and at the widest head;
 - ``tf32_split``: the operand split of the error-compensated TF32
   ("3xTF32") products, bit for bit as ``cvt.rna.tf32.f32`` rounds;
 - ``ssd_scan_chunked`` (the kernel's order: zero-padded last chunk,
   cumulative decay, four products as 0 or 3 TF32 passes) against the JAX
   package's ``ssd_scan_pallas`` in interpret mode and its ``ssd_scan_ref``,
   with ragged last chunks, D and N that are not multiples of 8, and
   D = N = 128;
 - at zamba2's width over a 300-step prompt, that one TF32 pass misses the
   1e-4 the kernel is held to while three passes hold it: the reason for
   the design.

atol = rtol = 1e-4 in float32, the tolerance of the kernel on the card
(``tests/test_torch_kernels_cuda.py``): the chunked forms sum in other
orders than the references.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro_torch.kernels.ssd_scan import ref
from torch_cases import ssd_inputs

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _close(want, got):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


# -- the plan -------------------------------------------------------------------


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("s", [1, 37, 300, 2048])
def test_ssd_plan_of_zamba2(s, width):
    """zamba2-1.2b (64 heads, D = N = 64): decode at S = 1; a prompt with
    each head's D rows in two slices, 128 blocks at B=1 on the 132 SMs.
    The widest head (D = N = 128) is sliced the same way (the kernel drops
    its chunk to 32 there, to fit a block's shared memory)."""
    plan = ref.ssd_plan(s, 64, width, width)
    if s == 1:
        assert plan == ("decode", 1)
        return
    assert plan == ("chunked", 2)
    assert 64 * plan.d_split <= ref.SMS
    assert ref.slice_rows(width, plan.d_split) == width // 2


@pytest.mark.parametrize("h,d,n", [(1, 1, 1), (3, 7, 5), (2, 128, 128),
                                   (64, 128, 128), (200, 128, 128),
                                   (64, 100, 96), (32, 48, 16), (8, 127, 3),
                                   (16, 64, 64)])
@pytest.mark.parametrize("s", [2, 33, 300])
def test_ssd_plan_covers(s, h, d, n):
    """A prompt's plan fills at most the card's SMs at B=1 (or takes one
    slice), and its slices (whole 8-row tiles but the last) cover the D rows
    once."""
    plan = ref.ssd_plan(s, h, d, n)
    assert plan.path == "chunked" and plan.d_split in ref.D_SPLITS
    assert plan.d_split == 1 or h * plan.d_split <= ref.SMS
    rows = ref.slice_rows(d, plan.d_split)
    assert rows % 8 == 0 and (plan.d_split - 1) * rows < d <= \
        plan.d_split * rows


# -- the TF32 split -------------------------------------------------------------


def test_tf32_split_rounds_as_cvt_rna():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero; lo is a - hi rounded the same; hi + lo holds 21 bits of a."""
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                         3 * 2 ** -20], dtype=torch.float32)
    hi, _ = ref.tf32_split(ties)
    assert hi.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3 * 2 ** -20]
    a = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32) * 100)
    hi, lo = ref.tf32_split(a)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi - a).abs() <= a.abs() * 2 ** -11).all()
    assert ((hi + lo - a).abs() <= a.abs() * 2 ** -21).all()


# -- the chunked plain version --------------------------------------------------


@pytest.mark.parametrize("passes", [0, 3])
@pytest.mark.parametrize("b,s,h,d,n,chunk", [
    (2, 65, 3, 7, 5, 64), (2, 129, 3, 7, 5, 64), (2, 129, 3, 7, 5, 32),
    (1, 65, 2, 128, 128, 32), (1, 100, 4, 16, 8, 64)])
def test_ssd_scan_chunked_matches_jax(b, s, h, d, n, chunk, passes):
    """A ragged last chunk, D and N not multiples of 8, and the widest
    head: the kernel's chunked order, in float32 and in 3xTF32, equals the
    JAX package's Pallas kernel (interpret mode) and its ref, each run as one
    chunk of all S steps."""
    inp = ssd_inputs(b, s, h, d, n, seed=s + h + d)
    y, hT = ref.ssd_scan_chunked(*_t(inp), chunk=chunk, tf32_passes=passes)
    y_r, h_r = jax_ssd_scan_ref(*map(jnp.asarray, inp), chunk=s)
    _close(y_r, y)
    _close(h_r, hT)
    y_k, h_k = ssd_scan_pallas(*map(jnp.asarray, inp), block_h=1, chunk=s,
                               interpret=True)
    _close(y_k, y)
    _close(h_k, hT)


@pytest.mark.parametrize("passes", [1, 3])
def test_ssd_scan_tf32_passes_at_zamba2_width(passes):
    """At zamba2-1.2b's width (H = D = N = 64) over a 300-step prompt, at the
    kernel's chunk of 64: one TF32 pass misses atol = rtol = 1e-4 against
    the plain version (and the JAX package's ref), three passes hold it."""
    inp = ssd_inputs(1, 300, 64, 64, 64, seed=364)
    want = ref.ssd_scan_ref(*_t(inp), chunk=150)
    y_j, h_j = jax_ssd_scan_ref(*map(jnp.asarray, inp), chunk=150)
    got = ref.ssd_scan_chunked(*_t(inp), chunk=64, tf32_passes=passes)
    holds = [torch.allclose(g, w, **TOL) for g, w in zip(got, want)]
    if passes == 1:
        assert not all(holds)
        return
    assert all(holds)
    _close(y_j, got[0])
    _close(h_j, got[1])


@pytest.mark.parametrize("b,s,h,d,n,cut", [(1, 300, 4, 64, 64, 150),
                                           (2, 129, 3, 7, 5, 50)])
def test_ssd_scan_chunked_carries(b, s, h, d, n, cut):
    """A call split in two that carries hT equals one call (the chunk
    boundaries move, so within the tolerance)."""
    x, bm, cm, ld, dt, h0 = _t(ssd_inputs(b, s, h, d, n, seed=cut))
    y, hT = ref.ssd_scan_chunked(x, bm, cm, ld, dt, h0)
    y1, h1 = ref.ssd_scan_chunked(*[t[:, :cut] for t in (x, bm, cm, ld, dt)],
                                  h0)
    y2, h2 = ref.ssd_scan_chunked(*[t[:, cut:] for t in (x, bm, cm, ld, dt)],
                                  h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **TOL)
    torch.testing.assert_close(h2, hT, **TOL)


def test_ssd_scan_chunked_empty_sequence():
    """S = 0: no output rows, and the state passes through."""
    x, bm, cm, ld, dt, h0 = _t(ssd_inputs(2, 0, 3, 7, 5, seed=0))
    y, hT = ref.ssd_scan_chunked(x, bm, cm, ld, dt, h0)
    assert y.shape == (2, 0, 3, 7) and torch.equal(hT, h0)
