"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card, and the model's kernel route against its plain route.  Every
test here is marked ``cuda`` and skips without a card; the file imports
neither ``jax`` nor ``repro`` so that it runs on a machine with only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the argmax is bitwise (byte mask and packed mask alike, on
float32, bfloat16 and float16 logits);
float32 attention atol 1e-5 (only the summation order differs), the split
score of absorbed MLA atol = rtol = 1e-4 (576-long dot products in another
order); bfloat16 attention, both scores (the split score's products on the
tensor cores), atol = rtol = 2e-2 in float32, about one bf16
ulp of the output; the two scans atol = rtol = 1e-4 in
float32 (the Mamba1 kernel walks the recurrence step by step; the SSD
kernel computes the chunked form on the tensor cores in error-compensated
TF32, with other chunks than the plain version; the orders of the sums
differ)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.kernels.decode_attention import kernel as attn_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      gather_pages)
from repro_torch.kernels.masked_sample import kernel as mask_kernel
from repro_torch.kernels.masked_sample.ops import masked_argmax
from repro_torch.kernels.masked_sample.ref import (argmax_plan,
                                                   masked_argmax_ref,
                                                   unpack_bits)
from repro_torch.kernels.mamba_scan import kernel as mamba_kernel
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked, ssd_scan_ref
from repro_torch.models import build_model
from torch_cases import (byte_mask_case, mamba_inputs, mask_case,
                         paged_case, split_case, ssd_inputs)

SCAN_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,v", [(1, 400), (4, 100352), (64, 1001)])
def test_masked_argmax_kernel_matches_plain(cuda_device, b, v):
    logits, words = mask_case(b, v, seed=b + v)
    wide = np.zeros((b, v + 64), np.float32)
    wide[:, :v] = logits
    lg = torch.from_numpy(wide).to(cuda_device)[:, :v]   # strided rows
    bits = torch.from_numpy(words.view(np.int32)).to(cuda_device)
    before = mask_kernel.masked_argmax_packed.launches
    i_k, v_k = masked_argmax(lg, bits)
    assert mask_kernel.masked_argmax_packed.launches == before + 1
    i_p, v_p = masked_argmax_ref(lg, bits)
    assert torch.equal(i_k, i_p) and torch.equal(v_k, v_p)


def _argmax_case(device, b, v, dtype=torch.float32, stride_pad=64, col0=0,
                 seed=None):
    """``mask_case`` on the card: logits in ``dtype`` as a view of rows
    ``v + stride_pad`` wide starting at column ``col0`` (an odd pad or col0
    leaves rows that are not 16-byte aligned), packed int32 words and the
    same mask as bools."""
    logits, words = mask_case(b, v, seed=b + v if seed is None else seed)
    wide = np.zeros((b, col0 + v + stride_pad), np.float32)
    wide[:, col0:col0 + v] = logits
    lg = torch.from_numpy(wide).to(device=device, dtype=dtype)[:, col0:col0 + v]
    bits = torch.from_numpy(words.view(np.int32)).to(device)
    return lg, bits, unpack_bits(bits, v)


def _both_equal_plain(lg, bits, mask):
    """Both kernels, one launch each, bitwise equal to the plain version
    and to each other; returns the packed kernel's result."""
    before = (mask_kernel.masked_argmax_packed.launches,
              mask_kernel.masked_argmax_bytes.launches)
    got_p = masked_argmax(lg, bits)
    got_b = masked_argmax(lg, mask)
    assert (mask_kernel.masked_argmax_packed.launches,
            mask_kernel.masked_argmax_bytes.launches) == \
        (before[0] + 1, before[1] + 1)
    want = masked_argmax_ref(lg, bits)
    for got in (got_p, got_b):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got_p


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("stride_pad,col0", [(64, 0), (1, 0), (3, 1),
                                             (0, 5)])
@pytest.mark.parametrize("b,v", [(4, 403), (3, 4099), (4, 100352),
                                 (4, 129280)])
def test_masked_argmax_kernels_strides_and_dtypes(cuda_device, b, v, dtype,
                                                  stride_pad, col0):
    """Packed and byte-mask kernels on float32, bfloat16 and float16 logits,
    with row strides that are odd and rows that start off a 16-byte
    boundary (the scalar head and tail around the vectors), against the
    plain version bitwise: row 1 all illegal, row 2 ties over the row."""
    lg, bits, mask = _argmax_case(cuda_device, b, v, dtype, stride_pad, col0)
    i_k, v_k = _both_equal_plain(lg, bits, mask)
    assert i_k[1].item() == 0 and v_k[1].item() == np.float32(-1e30)
    assert i_k[2].item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,v", [(4, 100352), (2, 8193), (64, 262144)])
def test_masked_argmax_ties_across_split_edges(cuda_device, b, v, dtype):
    """An equal maximum on either side of each of the plan's split edges
    (row 0), and in the last token of one split and the first of the next
    only (row 1): the lowest index wins."""
    plan = argmax_plan(b, v)
    assert plan.n_split > 1
    lg, bits, mask = _argmax_case(cuda_device, b, v, dtype, stride_pad=3)
    edges = [s * plan.split_len for s in range(1, plan.n_split)]
    for r, toks in ((0, [t for e in edges for t in (e - 1, e)]),
                    (1, [edges[-1] - 1, edges[-1]])):
        for t in toks:
            lg[r, t] = 9.0
            bits[r, t // 32] |= torch.tensor(1 << (t % 32), dtype=torch.int64
                                             ).to(torch.int32).item()
            mask[r, t] = True
    i_k, v_k = _both_equal_plain(lg, bits, mask)
    assert i_k[0].item() == edges[0] - 1 and v_k[0].item() == 9.0
    assert i_k[1].item() == edges[-1] - 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,v", [(4, 403), (4, 100352), (64, 262144)])
def test_masked_argmax_nan_row(cuda_device, b, v, dtype):
    """A legal NaN in one split of row 0 never wins: row 0 equals the
    plain version with that logit at -inf, the other rows the plain
    version."""
    lg, bits, mask = _argmax_case(cuda_device, b, v, dtype)
    t = v // 3                                # a legal NaN
    lg[0, t] = float("nan")
    bits[0, t // 32] |= torch.tensor(1 << (t % 32), dtype=torch.int64
                                     ).to(torch.int32).item()
    mask[0, t] = True
    lg_inf = lg.clone()
    lg_inf[0, t] = float("-inf")
    want = masked_argmax_ref(lg_inf, bits)
    for m in (bits, mask):
        i_k, v_k = masked_argmax(lg, m)
        assert torch.equal(i_k, want[0]) and torch.equal(v_k, want[1])
    i_p, v_p = masked_argmax_ref(lg, bits)
    assert torch.equal(i_k[1:], i_p[1:]) and torch.equal(v_k[1:], v_p[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("b,v", [(4, 100352), (64, 262144)])
def test_masked_argmax_large(cuda_device, b, v):
    """B=64 at gemma3-27b's 262144-token vocabulary (67 MB of float32
    logits, above the L2) and B=4 at stablelm's: both kernels bitwise equal
    to the plain version, two calls bitwise equal."""
    lg, bits, mask = _argmax_case(cuda_device, b, v, stride_pad=0)
    first = _both_equal_plain(lg, bits, mask)
    for m in (bits, mask):
        again = masked_argmax(lg, m)
        assert torch.equal(first[0], again[0]) and \
            torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,v", [(4, 403), (4, 100352)])
def test_masked_argmax_reads_nothing_to_host(cuda_device, b, v):
    """A call (one split a row, or several merged) makes no host sync and
    leaves this stream's merge counters zero."""
    lg, bits, mask = _argmax_case(cuda_device, b, v)
    for m in (bits, mask):
        masked_argmax(lg, m)                  # build, load and allocate
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [masked_argmax(lg, m) for m in (bits, mask)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = masked_argmax_ref(lg, bits)
    for i_k, v_k in got:
        assert torch.equal(i_k, want[0]) and torch.equal(v_k, want[1])
    key = (cuda_device.index or 0,
           torch.cuda.current_stream(cuda_device).cuda_stream)
    if argmax_plan(b, v).n_split > 1:
        counters, _ = mask_kernel._SCRATCH[key]
        assert int(counters.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s_win", [1, 3])
def test_decode_attention_kernel_matches_plain(cuda_device, dtype, tol,
                                               s_win):
    """Paged with NaN in every page no row owns (the kernel must never read
    past a row's frontier), and contiguous over the gathered stripes."""
    q, kp, vp, ln, tbl = paged_case(s_win, seed=20 + s_win,
                                    garbage=float("nan"))
    clean = paged_case(s_win, seed=20 + s_win)

    def dev(x):
        return torch.from_numpy(x).to(cuda_device)
    q_d, ln_d, tbl_d = dev(q).to(dtype), dev(ln), dev(tbl)
    before = attn_kernel.decode_attention_cuda.launches
    got = decode_attention(q_d, dev(kp).to(dtype), dev(vp).to(dtype), ln_d,
                           block_tables=tbl_d)
    assert attn_kernel.decode_attention_cuda.launches == before + 1
    kc, vc = dev(clean[1]).to(dtype), dev(clean[2]).to(dtype)
    want = decode_attention_ref(q_d, kc, vc, ln_d, block_tables=tbl_d)
    rtol = 0 if dtype == torch.float32 else tol
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=rtol)
    if s_win == 1:                               # row 0 sees no key
        assert torch.all(got[0] == 0)
    kd = gather_pages(kc, tbl_d).contiguous()
    vd = gather_pages(vc, tbl_d).contiguous()
    torch.testing.assert_close(
        decode_attention(q_d, kd, vd, ln_d).float(),
        decode_attention_ref(q_d, kd, vd, ln_d).float(), atol=tol, rtol=rtol)


# Long rows over 64-key pages at stablelm's widths (G=32, D=64), and short
# pages at small widths, with lengths that leave splits of the key-split
# plan empty (0, 5), and that fall on split and page boundaries (64, 128)
# or one short of them.
LONG_CASES = {
    "1000": dict(lens=[1000, 0, 128, 999], g=32, d=64, ps=64),
    "4096": dict(lens=[4096, 5, 2048, 4095], g=32, d=64, ps=64),
    "pages8": dict(lens=[0, 64, 129, 511], g=2, d=32, ps=8),
}


def _long_case(case, s_win, qh, device):
    """A clean case on the card, and the same pools with NaN in every page
    no row owns (the trash page included)."""
    c = LONG_CASES[case]
    mp = -(-(max(c["lens"]) + s_win - 1) // c["ps"])
    q, kp, vp, ln, tbl = paged_case(s_win, seed=60 + s_win + len(case),
                                    lens=c["lens"], qh=qh, g=c["g"],
                                    d=c["d"], ps=c["ps"], mp=mp)
    foreign = np.ones(kp.shape[0], bool)
    foreign[tbl[tbl > 0]] = False
    kn, vn = kp.copy(), vp.copy()
    kn[foreign] = np.nan
    vn[foreign] = np.nan
    return [torch.from_numpy(x).to(device)
            for x in (q, kp, vp, kn, vn, ln, tbl)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s_win,qh", [(1, 1), (3, 2), (3, 7), (9, 7)])
@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_decode_attention_kernel_matches_plain_long_rows(cuda_device, dtype,
                                                         tol, s_win, qh,
                                                         case):
    """Keys split across blocks: paged (NaN-poisoned pools bitwise equal to
    clean ones), two calls bitwise equal, rows that see no key exactly 0,
    and contiguous over the gathered stripes.  Qh = 7 at S = 3 and 9 gives
    windows of 21 and 63 query rows, in tiles of 16."""
    q, kp, vp, kn, vn, ln, tbl = _long_case(case, s_win, qh, cuda_device)
    q, kp, vp, kn, vn = (x.to(dtype) for x in (q, kp, vp, kn, vn))
    before = attn_kernel.decode_attention_cuda.launches
    got = decode_attention(q, kn, vn, ln, block_tables=tbl)
    assert attn_kernel.decode_attention_cuda.launches == before + 1
    want = decode_attention_ref(q, kp, vp, ln, block_tables=tbl)
    rtol = 0 if dtype == torch.float32 else tol
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=rtol)
    assert torch.equal(got, decode_attention(q, kn, vn, ln,
                                             block_tables=tbl))
    assert torch.equal(got, decode_attention(q, kp, vp, ln,
                                             block_tables=tbl))
    empty = ln == 0
    assert torch.all(got[empty][:, 0] == 0)
    for counters in attn_kernel._COUNTERS.values():  # left zero for the next
        assert torch.count_nonzero(counters).item() == 0
    kd = gather_pages(kp, tbl).contiguous()
    vd = gather_pages(vp, tbl).contiguous()
    got_c = decode_attention(q, kd, vd, ln)
    torch.testing.assert_close(
        got_c.float(), decode_attention_ref(q, kd, vd, ln).float(), atol=tol,
        rtol=rtol)
    assert torch.equal(got_c, decode_attention(q, kd, vd, ln))


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False])
def test_decode_attention_kernel_reads_nothing_to_host(cuda_device, paged):
    """With lengths and tables on the card, a call (keys split across
    blocks, scratch allocated) makes no host sync."""
    q, kp, vp, _, _, ln, tbl = _long_case("1000", 1, 1, cuda_device)
    q, kp, vp = (x.to(torch.bfloat16) for x in (q, kp, vp))
    if not paged:
        kp = gather_pages(kp, tbl).contiguous()
        vp = gather_pages(vp, tbl).contiguous()
        tbl = None
    decode_attention(q, kp, vp, ln, block_tables=tbl)   # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = decode_attention(q, kp, vp, ln, block_tables=tbl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = decode_attention_ref(q, kp, vp, ln, block_tables=tbl)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_paged_decode_kernel_route_matches_plain_route(cuda_device):
    """A small float32 model decodes ragged rows into a paged pool through
    the kernel and through the plain path: the logits agree."""
    cfg = ModelConfig(arch_id="tp", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                      dtype="float32", max_seq_len=64)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    plain = build_model(cfg)
    params = plain.init(gen, device=cuda_device)
    kern = build_model(dataclasses.replace(cfg, use_pallas_kernels=True))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (2, 12))).to(cuda_device)
    caches = []
    for _ in range(2):
        c = plain.init_cache(2, 32, page_size=8, n_pages=9,
                             device=cuda_device)
        c["pages"] = torch.tensor([[3, 1, 5, -1], [2, 8, 4, 0]],
                                  dtype=torch.int32, device=cuda_device)
        c["len"] = torch.tensor([0, 3], dtype=torch.int32,
                                device=cuda_device)
        caches.append(c)
    before = attn_kernel.decode_attention_cuda.launches
    i = 0
    for width in (5, 1, 3):
        a, caches[0] = plain.decode_step(params, caches[0],
                                         toks[:, i:i + width])
        b, caches[1] = kern.decode_step(params, caches[1],
                                        toks[:, i:i + width])
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
        i += width
    assert attn_kernel.decode_attention_cuda.launches == before + 3 * 2


# #1 contiguous at the widths of the new paths: whisper-tiny's decoder
# self-attention (6 KV heads of 64, Qh = 1) and gemma3-27b's global layers
# (16 KV heads of 128, Qh = 2), over ragged rows of a dense stripe
CONTIG_SHAPES = {"whisper": dict(g=6, qh=1, d=64),
                 "gemma3": dict(g=16, qh=2, d=128)}


def _contig_case(shape, s_win, t, lens, device, seed=0):
    """q (B,S,G,Qh,D), a clean k/v stripe (B,T,G,D), the same stripe with
    garbage (K 1e3, V -1e3, as ``paged_case`` puts in foreign pages) at
    every position no window row may read (t >= len + S - 1), and lengths
    (B,), on the card in float32."""
    c = CONTIG_SHAPES[shape]
    rng = np.random.default_rng(seed)
    b = len(lens)
    q = rng.normal(size=(b, s_win, c["g"], c["qh"], c["d"]))
    k = rng.normal(size=(b, t, c["g"], c["d"]))
    v = rng.normal(size=(b, t, c["g"], c["d"]))
    kn, vn = k.copy(), v.copy()
    for i, ln in enumerate(lens):
        kn[i, ln + s_win - 1:] = 1e3
        vn[i, ln + s_win - 1:] = -1e3
    return [torch.from_numpy(np.asarray(x, np.float32)).to(device)
            for x in (q, k, v, kn, vn)] + [
        torch.tensor(lens, dtype=torch.int32, device=device)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s_win", [1, 5])
@pytest.mark.parametrize("shape", sorted(CONTIG_SHAPES))
def test_decode_attention_contiguous_at_new_widths(cuda_device, shape,
                                                   s_win, dtype, tol):
    """#1 over a dense stripe at whisper's and gemma3's head widths: ragged
    rows (one empty, one ending on a split edge), the garbage past every
    frontier never weighed, two calls bitwise equal."""
    q, k, v, kn, vn, ln = _contig_case(shape, s_win, 1040,
                                       [0, 1, 517, 1024], cuda_device)
    q, k, v, kn, vn = (x.to(dtype) for x in (q, k, v, kn, vn))
    before = attn_kernel.decode_attention_cuda.launches
    got = decode_attention(q, kn, vn, ln)
    assert attn_kernel.decode_attention_cuda.launches == before + 1
    want = decode_attention_ref(q, k, v, ln)
    rtol = 0 if dtype == torch.float32 else tol
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=rtol)
    assert torch.equal(got, decode_attention(q, kn, vn, ln))
    if s_win == 1:
        assert torch.all(got[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", sorted(CONTIG_SHAPES))
def test_decode_attention_on_dequantized_int8(cuda_device, shape, dtype,
                                              tol):
    """An int8 KV cache's read: K/V quantized per (token, head) as the
    model writes them, dequantized whole in plain code, then #1 against
    the plain version on the same dequantized operands."""
    from repro_torch.models.transformer import (_dequantize_kv,
                                                _quantize_kv)
    q, k, v, _, _, ln = _contig_case(shape, 3, 600, [5, 0, 300, 597],
                                     cuda_device, seed=4)
    (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
    assert kq.dtype == torch.int8 and ks.dtype == torch.bfloat16
    kd, vd = _dequantize_kv(kq, ks, dtype), _dequantize_kv(vq, vs, dtype)
    q = q.to(dtype)
    before = attn_kernel.decode_attention_cuda.launches
    got = decode_attention(q, kd, vd, ln)
    assert attn_kernel.decode_attention_cuda.launches == before + 1
    rtol = 0 if dtype == torch.float32 else tol
    torch.testing.assert_close(
        got.float(), decode_attention_ref(q, kd, vd, ln).float(), atol=tol,
        rtol=rtol)


ARCH_CASES = {
    "swa+attn": dict(group=("swa", "attn"), sliding_window=8),
    "xattn": dict(family="audio", group=("xattn",), is_encoder_decoder=True,
                  n_encoder_layers=2, encoder_seq_len=12),
    "int8": dict(kv_cache_dtype="int8"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ARCH_CASES))
def test_new_paths_kernel_route_matches_plain_route(cuda_device, case):
    """A small float32 model of each new path decodes ragged dense rows
    through #1 and through the plain path: the logits agree, and #1
    launches once a full-attention layer a step (a ring layer never)."""
    kw = dict(dict(arch_id="tp", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                   dtype="float32", max_seq_len=64), **ARCH_CASES[case])
    cfg = ModelConfig(**kw)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    plain = build_model(cfg)
    params = plain.init(gen, device=cuda_device)
    kern = build_model(dataclasses.replace(cfg, use_pallas_kernels=True))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 128, (2, 24))).to(cuda_device)
    inp = {"tokens": toks[:, :6]}
    if cfg.is_encoder_decoder:
        inp["frames"] = torch.from_numpy(rng.normal(size=(
            2, 12, 64)).astype(np.float32)).to(cuda_device)
    caches = []
    for m in (plain, kern):
        c = m.init_cache(2, 32, device=cuda_device)
        _, c = m.prefill(params, inp, c)
        c["len"] = torch.tensor([6, 4], dtype=torch.int32,
                                device=cuda_device)
        caches.append(c)
    before = attn_kernel.decode_attention_cuda.launches
    i, steps = 6, 0
    for width in (1, 3, 1, 1, 1, 1, 1, 1, 1, 1):
        a, caches[0] = plain.decode_step(params, caches[0],
                                         toks[:, i:i + width])
        b, caches[1] = kern.decode_step(params, caches[1],
                                        toks[:, i:i + width])
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
        i, steps = i + width, steps + 1
    full = sum(k != "swa" for k in cfg.group) * cfg.layer_program[1]
    assert attn_kernel.decode_attention_cuda.launches == before + steps * full


def _mamba_case(device, b, s, d, n):
    return [torch.from_numpy(x).to(device)
            for x in mamba_inputs(b, s, d, n, seed=s + d)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n", [
    (4, 1, 8192, 16), (1, 37, 8192, 16), (2, 100, 48, 8), (1, 300, 256, 64),
    (3, 5, 130, 5),
    # falcon-mamba-7b's prefill of one token and a 2048-step prompt
    (1, 1, 8192, 16), (1, 2048, 8192, 16),
    # ragged: 130 channels, the scalar state path (N = 5), padding lanes
    # (N = 12), sixteen lanes (N = 64); one lane a channel (N = 4)
    (2, 33, 130, 5), (1, 37, 130, 5), (2, 33, 130, 12), (1, 37, 130, 12),
    (2, 33, 130, 64), (1, 37, 130, 64), (2, 45, 200, 4)])
def test_mamba_scan_kernel_matches_plain(cuda_device, b, s, d, n):
    """Nonzero h0, ragged channel blocks and time tiles, N below, between
    and at the limit, a prompt of 2048 steps; one launch a call; and two
    calls that carry hT equal one call."""
    inp = _mamba_case(cuda_device, b, s, d, n)
    before = mamba_kernel.mamba_scan_cuda.launches
    y, h = mamba_scan(*inp)
    assert mamba_kernel.mamba_scan_cuda.launches == before + 1
    y_p, h_p = mamba_scan_ref(*inp)
    torch.testing.assert_close(y, y_p, **SCAN_TOL)
    torch.testing.assert_close(h, h_p, **SCAN_TOL)
    if s > 1:
        cut = s // 2
        dt, x, bm, cm, a, h0 = inp
        y1, h1 = mamba_scan(dt[:, :cut].contiguous(), x[:, :cut].contiguous(),
                            bm[:, :cut].contiguous(), cm[:, :cut].contiguous(),
                            a, h0)
        y2, h2 = mamba_scan(dt[:, cut:].contiguous(), x[:, cut:].contiguous(),
                            bm[:, cut:].contiguous(), cm[:, cut:].contiguous(),
                            a, h1)
        torch.testing.assert_close(torch.cat([y1, y2], 1), y, **SCAN_TOL)
        torch.testing.assert_close(h2, h, **SCAN_TOL)


@pytest.mark.cuda
def test_mamba_scan_kernel_factor_is_torch_exp(cuda_device):
    """With h0 = 1, x = 0 and dt = 1 one step leaves hT = the kernel's
    factor exp(A), which must be the plain version's torch.exp bit for bit
    (a float32 in every 251 of (-ln 2, 0], where the decays near 1 that
    carry their rounding over many steps lie, and 2^20 values down to
    A = -80): a factor that rounds otherwise drifts from the plain
    version over a long prompt."""
    top = int(torch.tensor(0.6931472, dtype=torch.float32)
              .view(torch.int32))
    near = -torch.arange(0, top, 251, dtype=torch.int32).view(torch.float32)
    far = -torch.linspace(0.6931472, 80.0, 1 << 20, dtype=torch.float64) \
        .float()
    for a_vals in (near, far):
        a = torch.zeros(-(-a_vals.numel() // 16) * 16, dtype=torch.float32)
        a[:a_vals.numel()] = a_vals
        a = a.view(-1, 16).to(cuda_device)
        d = a.shape[0]
        dt = torch.ones((1, 1, d), device=cuda_device)
        x = torch.zeros((1, 1, d), device=cuda_device)
        bc = torch.zeros((1, 1, 16), device=cuda_device)
        h0 = torch.ones((1, d, 16), device=cuda_device)
        _, factor = mamba_scan(dt, x, bc, bc, a, h0)
        assert torch.equal(factor, torch.exp(a)[None])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n", [(4, 1, 8192, 16), (1, 300, 8192, 16),
                                     (2, 33, 130, 5), (1, 37, 130, 64)])
def test_mamba_scan_kernel_repeats_bitwise(cuda_device, b, s, d, n):
    """Two calls on the same inputs give the same bits (a fixed reduction
    order, no atomics)."""
    inp = _mamba_case(cuda_device, b, s, d, n)
    y1, h1 = mamba_scan(*inp)
    y2, h2 = mamba_scan(*inp)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,cut", [
    (1, 37, 8192, 16, 18), (1, 300, 8192, 16, 150), (2, 2, 130, 12, 1),
    (2, 3, 130, 12, 1), (2, 33, 130, 5, 16), (1, 37, 130, 12, 18),
    (2, 33, 130, 64, 16), (1, 37, 130, 64, 5)])
def test_mamba_scan_kernel_carries_bitwise(cuda_device, b, s, d, n, cut):
    """A call split in two that carries hT gives one call's bits: the
    steps round alike whatever tile they fall in, and a one-step call (no
    staging, a butterfly over the lanes) sums y as a staged call does."""
    dt, x, bm, cm, a, h0 = _mamba_case(cuda_device, b, s, d, n)
    y, h = mamba_scan(dt, x, bm, cm, a, h0)
    y1, h1 = mamba_scan(*[t[:, :cut].contiguous() for t in (dt, x, bm, cm)],
                        a, h0)
    y2, h2 = mamba_scan(*[t[:, cut:].contiguous() for t in (dt, x, bm, cm)],
                        a, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(h2, h)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 37])
def test_mamba_scan_kernel_reads_nothing_to_host(cuda_device, s):
    """A call (its plan chosen from shapes) makes no host sync."""
    inp = _mamba_case(cuda_device, 4 if s == 1 else 1, s, 8192, 16)
    mamba_scan(*inp)   # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, h = mamba_scan(*inp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    y_p, h_p = mamba_scan_ref(*inp)
    torch.testing.assert_close(y, y_p, **SCAN_TOL)
    torch.testing.assert_close(h, h_p, **SCAN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n", [(4, 1, 8192, 16), (1, 37, 8192, 16),
                                     (2, 33, 130, 5)])
def test_mamba_scan_kernel_replays_in_cuda_graph(cuda_device, b, s, d, n):
    """A call captured in a CUDA graph (it allocates only its outputs and
    reads nothing back) replays to the eager call's bits, also after its
    inputs are overwritten in place and restored."""
    inp = _mamba_case(cuda_device, b, s, d, n)
    want = mamba_scan(*inp)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mamba_scan(*inp)   # warm up on the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = mamba_kernel.mamba_scan_cuda.launches
    with torch.cuda.graph(graph):
        got = mamba_scan(*inp)
    assert mamba_kernel.mamba_scan_cuda.launches == before + 1
    saved = [t.clone() for t in inp]
    for t in inp:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    zero_y = got[0].clone()
    for t, v in zip(inp, saved):
        t.copy_(v)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(zero_y, torch.zeros_like(zero_y))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,n", [(4, 1, 64, 64, 64), (1, 37, 64, 64, 64),
                                       (1, 300, 4, 64, 64), (2, 96, 6, 8, 4),
                                       (1, 20, 2, 128, 128), (2, 17, 3, 7, 5),
                                       (1, 2048, 64, 64, 64),
                                       (1, 65, 64, 64, 64), (2, 129, 3, 7, 5)])
def test_ssd_scan_kernel_matches_plain(cuda_device, b, s, h, d, n):
    """The decode path (S = 1) and the chunked path (ragged last chunks, D
    and N not multiples of 8, D = N = 128, a 2048-step prompt) against the
    plain version, and a call split in two and carried against one call."""
    inp = _ssd_case(cuda_device, b, s, h, d, n)
    chunk = min(128, s)
    before = ssd_kernel.ssd_scan_cuda.launches
    y, hT = ssd_scan(*inp, chunk=chunk)
    assert ssd_kernel.ssd_scan_cuda.launches == before + 1
    y_p, h_p = ssd_scan_ref(*inp, chunk=chunk)
    torch.testing.assert_close(y, y_p, **SCAN_TOL)
    torch.testing.assert_close(hT, h_p, **SCAN_TOL)
    if s > 1:
        cut = s // 2
        first = [t[:, :cut].contiguous() for t in inp[:5]]
        second = [t[:, cut:].contiguous() for t in inp[:5]]
        y1, h1 = ssd_scan(*first, inp[5])
        y2, h2 = ssd_scan(*second, h1)
        torch.testing.assert_close(torch.cat([y1, y2], 1), y, **SCAN_TOL)
        torch.testing.assert_close(h2, hT, **SCAN_TOL)


def _ssd_case(device, b, s, h, d, n):
    return [torch.from_numpy(x).to(device)
            for x in ssd_inputs(b, s, h, d, n, seed=s + h)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,n", [(4, 1, 64, 64, 64), (1, 300, 64, 64, 64),
                                       (2, 129, 3, 7, 5), (1, 20, 2, 128, 128),
                                       (1, 100, 64, 128, 128)])
def test_ssd_scan_kernel_repeats_bitwise(cuda_device, b, s, h, d, n):
    """Two calls on the same inputs give the same bits (a fixed order of
    every sum, no atomics)."""
    inp = _ssd_case(cuda_device, b, s, h, d, n)
    y1, h1 = ssd_scan(*inp)
    y2, h2 = ssd_scan(*inp)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,n", [(1, 37, 64, 64, 64), (1, 300, 64, 64, 64),
                                       (1, 100, 64, 128, 128)])
def test_ssd_scan_kernel_matches_tf32_emulation(cuda_device, b, s, h, d, n):
    """At zamba2-1.2b's width (64-step chunks) and at the widest head (the
    kernel's chunk drops to 32 there, to fit shared memory) the kernel
    equals its chunked order in plain PyTorch with that chunk and three
    TF32 passes (``ssd_scan_chunked``)."""
    inp = _ssd_case(cuda_device, b, s, h, d, n)
    y, hT = ssd_scan(*inp)
    y_e, h_e = ssd_scan_chunked(*inp, chunk=64 if d == 64 else 32,
                                tf32_passes=3)
    torch.testing.assert_close(y, y_e, **SCAN_TOL)
    torch.testing.assert_close(hT, h_e, **SCAN_TOL)


@pytest.mark.cuda
def test_ssd_scan_kernel_empty_sequence(cuda_device):
    """S = 0 launches the chunked path with no chunk: hT is h0."""
    inp = _ssd_case(cuda_device, 2, 0, 3, 7, 5)
    y, hT = ssd_scan(*inp)
    assert y.shape == (2, 0, 3, 7) and torch.equal(hT, inp[5])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 37])
def test_ssd_scan_kernel_reads_nothing_to_host(cuda_device, s):
    """A call (its plan chosen from shapes) makes no host sync."""
    inp = _ssd_case(cuda_device, 4 if s == 1 else 1, s, 64, 64, 64)
    ssd_scan(*inp)   # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, h = ssd_scan(*inp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    y_p, h_p = ssd_scan_ref(*inp, chunk=min(128, s))
    torch.testing.assert_close(y, y_p, **SCAN_TOL)
    torch.testing.assert_close(h, h_p, **SCAN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("group,ssm", [
    (("mamba1",), dict(d_state=8, version=1)),
    (("mamba2", "mamba2", "shared_attn"),
     dict(d_state=8, version=2, head_dim=16))])
def test_recurrent_kernel_route_matches_plain_route(cuda_device, group, ssm):
    """A small float32 SSM / hybrid model prefills and decodes ragged rows
    through the scan (and contiguous attention) kernels and through the
    plain path: the logits agree, and each scan launches once a layer."""
    cfg = ModelConfig(arch_id="tr", family="ssm", n_layers=4, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                      dtype="float32", max_seq_len=64, group=group,
                      ssm=SSMConfig(**ssm))
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    plain = build_model(cfg)
    params = plain.init(gen, device=cuda_device)
    kern = build_model(dataclasses.replace(cfg, use_pallas_kernels=True))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (2, 9))).to(cuda_device)
    counts = (mamba_kernel.mamba_scan_cuda.launches,
              ssd_kernel.ssd_scan_cuda.launches)
    outs = []
    for model in (plain, kern):
        c = model.init_cache(2, 32, device=cuda_device)
        lg, c = model.prefill(params, {"tokens": toks[:, :6]}, c)
        got = [lg]
        c["len"] = torch.tensor([6, 4], dtype=torch.int32,
                                device=cuda_device)
        for i in range(6, 9):
            lg, c = model.decode_step(params, c, toks[:, i:i + 1])
            got.append(lg)
        outs.append(got)
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
    n_scan = 4 * 4                  # 4 SSM layers, 1 prefill + 3 decodes
    if group[0] == "mamba1":
        assert mamba_kernel.mamba_scan_cuda.launches == counts[0] + n_scan
    else:
        assert ssd_kernel.ssd_scan_cuda.launches == counts[1] + n_scan


@pytest.mark.cuda
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int8])
@pytest.mark.parametrize("b,v", [(4, 403), (4, 129280), (3, 33)])
def test_masked_argmax_byte_kernel_matches_plain_and_packed(cuda_device, b, v,
                                                            mask_dtype):
    """The byte-mask kernel (strided logits, an all-illegal row, ties)
    equals the plain version and the packed kernel on the packed form of
    the same mask, bit for bit."""
    logits, mask, words = byte_mask_case(b, v, seed=b * v)
    wide = np.zeros((b, v + 64), np.float32)
    wide[:, :v] = logits
    lg = torch.from_numpy(wide).to(cuda_device)[:, :v]
    m = torch.from_numpy(mask).to(cuda_device).to(mask_dtype)
    before = mask_kernel.masked_argmax_bytes.launches
    i_k, v_k = masked_argmax(lg, m)
    assert mask_kernel.masked_argmax_bytes.launches == before + 1
    i_p, v_p = masked_argmax_ref(lg, m)
    bits = torch.from_numpy(words.view(np.int32)).to(cuda_device)
    i_w, v_w = masked_argmax(lg, bits)
    assert torch.equal(i_k, i_p) and torch.equal(v_k, v_p)
    assert torch.equal(i_k, i_w) and torch.equal(v_k, v_w)
    assert i_k[1] == 0 and v_k[1] == -1e30


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dims", [(128, 512, 64), (4, 16, 8), (3, 24, 16)])
@pytest.mark.parametrize("s_win", [1, 2, 9])
def test_split_decode_attention_kernel_matches_plain(cuda_device, dtype, tol,
                                                     dims, s_win):
    """The split-score kernel at deepseek-v3's width (128 heads, latent 512,
    rope 64; at S = 9, 1152 query rows in 36 tiles of 32) and at small ones
    (4 and 3 heads, not a multiple of the row tile; rope 8 and latent 24
    padded to the tensor cores' depth of 16, latent 24 across two warps'
    columns): paged with NaN in every page no row owns (bitwise equal to
    clean pools), two calls bitwise equal, and contiguous over the gathered
    stripes."""
    h, r, d2 = dims
    q, q2, lat, rp, ln, tbl = split_case(s_win, seed=50 + s_win, h=h, r=r,
                                         d2=d2, garbage=float("nan"))
    clean = split_case(s_win, seed=50 + s_win, h=h, r=r, d2=d2)

    def dev(x):
        return torch.from_numpy(x).to(cuda_device)
    q_d, q2_d = dev(q).to(dtype), dev(q2).to(dtype)
    ln_d, tbl_d = dev(ln), dev(tbl)
    scale = 1.0 / np.sqrt(192.0)
    lat_d = dev(lat).to(dtype)
    before = attn_kernel.decode_attention_split_cuda.launches
    got = decode_attention(q_d, lat_d, lat_d, ln_d, scale=scale, q2=q2_d,
                           k2=dev(rp).to(dtype), block_tables=tbl_d)
    assert attn_kernel.decode_attention_split_cuda.launches == before + 1
    lat_c, rp_c = dev(clean[2]).to(dtype), dev(clean[3]).to(dtype)
    want = decode_attention_ref(q_d, lat_c, lat_c, ln_d, scale=scale,
                                q2=q2_d, k2=rp_c, block_tables=tbl_d)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.all(got[0, 0] == 0)             # row 0, position 0: no key
    assert torch.equal(got, decode_attention(
        q_d, lat_d, lat_d, ln_d, scale=scale, q2=q2_d, k2=dev(rp).to(dtype),
        block_tables=tbl_d))
    assert torch.equal(got, decode_attention(
        q_d, lat_c, lat_c, ln_d, scale=scale, q2=q2_d, k2=rp_c,
        block_tables=tbl_d))
    for counters in attn_kernel._COUNTERS.values():  # left zero for the next
        assert torch.count_nonzero(counters).item() == 0
    kd = gather_pages(lat_c, tbl_d).contiguous()
    k2d = gather_pages(rp_c, tbl_d).contiguous()
    got_c = decode_attention(q_d, kd, kd, ln_d, scale=scale, q2=q2_d, k2=k2d)
    torch.testing.assert_close(
        got_c.float(),
        decode_attention_ref(q_d, kd, kd, ln_d, scale=scale, q2=q2_d,
                             k2=k2d).float(), atol=tol, rtol=tol)
    assert torch.equal(got_c, decode_attention(q_d, kd, kd, ln_d, scale=scale,
                                               q2=q2_d, k2=k2d))


# Split-score rows long enough for many key splits (64-key pages, up to
# 1000 keys; lengths on page and split boundaries, and 0).
SPLIT_LONG_LENS = [1000, 0, 160, 319]


@pytest.mark.cuda
@pytest.mark.parametrize("s_win", [1, 9])
@pytest.mark.parametrize("paged", [True, False])
def test_split_decode_attention_kernel_long_rows(cuda_device, paged, s_win):
    """bfloat16 at deepseek-v3's width over 16 pages of 64 keys a row: the
    keys split across blocks (8 splits at S = 1), NaN-poisoned pools
    bitwise equal to clean ones, two calls bitwise equal, empty rows 0."""
    args = dict(h=128, r=512, d2=64, lens=SPLIT_LONG_LENS, ps=64, mp=16)
    q, q2, lat, rp, ln, tbl = split_case(s_win, seed=90 + s_win,
                                         garbage=float("nan"), **args)
    clean = split_case(s_win, seed=90 + s_win, **args)

    def dev(x, dtype=torch.bfloat16):
        t = torch.from_numpy(x).to(cuda_device)
        return t.to(dtype) if t.is_floating_point() else t
    q_d, q2_d, ln_d, tbl_d = dev(q), dev(q2), dev(ln), dev(tbl)
    lat_n, rp_n, lat_c, rp_c = dev(lat), dev(rp), dev(clean[2]), dev(clean[3])
    if not paged:
        lat_n = gather_pages(lat_c, tbl_d).contiguous()
        rp_n = gather_pages(rp_c, tbl_d).contiguous()
        lat_c, rp_c, tbl_d = lat_n, rp_n, None
    scale = 1.0 / np.sqrt(192.0)

    def call(lt, r):
        return decode_attention(q_d, lt, lt, ln_d, scale=scale, q2=q2_d,
                                k2=r, block_tables=tbl_d)
    before = attn_kernel.decode_attention_split_cuda.launches
    got = call(lat_n, rp_n)
    assert attn_kernel.decode_attention_split_cuda.launches == before + 1
    want = decode_attention_ref(q_d, lat_c, lat_c, ln_d, scale=scale,
                                q2=q2_d, k2=rp_c, block_tables=tbl_d)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert torch.equal(got, call(lat_n, rp_n))
    assert torch.equal(got, call(lat_c, rp_c))
    assert torch.all(got[1, 0] == 0) and got[0, 0].abs().sum() > 0
    for counters in attn_kernel._COUNTERS.values():
        assert torch.count_nonzero(counters).item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [True, False])
def test_split_decode_attention_kernel_reads_nothing_to_host(cuda_device,
                                                             paged):
    """bfloat16 at deepseek-v3's width, keys split across blocks (scratch
    allocated, counters taken): a call makes no host sync."""
    q, q2, lat, rp, ln, tbl = [
        torch.from_numpy(x).to(cuda_device) for x in split_case(
            1, seed=95, h=128, r=512, d2=64, lens=SPLIT_LONG_LENS, ps=64,
            mp=16)]
    q, q2, lat, rp = (x.to(torch.bfloat16) for x in (q, q2, lat, rp))
    if not paged:
        lat = gather_pages(lat, tbl).contiguous()
        rp = gather_pages(rp, tbl).contiguous()
        tbl = None
    kw = dict(scale=0.07, q2=q2, k2=rp, block_tables=tbl)
    decode_attention(q, lat, lat, ln, **kw)      # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = decode_attention(q, lat, lat, ln, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = decode_attention_ref(q, lat, lat, ln, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [("mla",), ("moe",)])
def test_mla_kernel_route_matches_plain_route(cuda_device, group):
    """A small float32 MLA (and MLA + MoE) model decodes ragged rows into
    a paged latent pool through the split-score kernel and through the
    plain path: the logits agree, one launch a layer a decode."""
    cfg = ModelConfig(arch_id="tm", family="moe", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128,
                      dtype="float32", max_seq_len=64, group=group,
                      mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                    qk_nope_head_dim=16, qk_rope_head_dim=8,
                                    v_head_dim=16),
                      moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                                    n_shared_experts=1, capacity_factor=2.0))
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    plain = build_model(cfg)
    params = plain.init(gen, device=cuda_device)
    kern = build_model(dataclasses.replace(cfg, use_pallas_kernels=True))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 128, (2, 12))).to(cuda_device)
    caches = []
    for _ in range(2):
        c = plain.init_cache(2, 32, page_size=8, n_pages=9,
                             device=cuda_device)
        c["pages"] = torch.tensor([[3, 1, 5, -1], [2, 8, 4, 0]],
                                  dtype=torch.int32, device=cuda_device)
        c["len"] = torch.tensor([0, 3], dtype=torch.int32,
                                device=cuda_device)
        caches.append(c)
    before = attn_kernel.decode_attention_split_cuda.launches
    i = 0
    for width in (5, 1, 2):
        a, caches[0] = plain.decode_step(params, caches[0],
                                         toks[:, i:i + width])
        b, caches[1] = kern.decode_step(params, caches[1],
                                        toks[:, i:i + width])
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
        i += width
    assert attn_kernel.decode_attention_split_cuda.launches == before + 3 * 2


@pytest.mark.cuda
def test_launches_after_engine_reset_equal_launches_before(cuda_device,
                                                           small_tokenizer):
    """An engine reset drops the merge counters and scratch of #1 and #2,
    which a launch that failed midway may have left set (poisoned here):
    the next launches allocate zeroed ones and give the bits of the
    launches before."""
    from repro_torch.core import grammars
    from repro_torch.serving import ContinuousBatchingScheduler, ServingEngine
    q, kp, vp, _, _, ln, tbl = _long_case("1000", 1, 1, cuda_device)
    lg, bits, _ = _argmax_case(cuda_device, 4, 100352)
    attn = decode_attention(q, kp, vp, ln, block_tables=tbl)
    sel = masked_argmax(lg, bits)
    assert attn_kernel._COUNTERS and mask_kernel._SCRATCH
    for buf in attn_kernel._COUNTERS.values():
        buf.fill_(1)
    for counters, _ in mask_kernel._SCRATCH.values():
        counters.fill_(1)
    cfg = ModelConfig(arch_id="tr", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=small_tokenizer.vocab_size,
                      dtype="float32", max_seq_len=256,
                      use_pallas_kernels=True)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    model = build_model(cfg)
    eng = ServingEngine(model, model.init(gen, device=cuda_device),
                        small_tokenizer, grammars.load("json"),
                        max_len=128, device=cuda_device)
    sched = ContinuousBatchingScheduler(eng, capacity=2)
    sched._engine_reset("test")
    assert not attn_kernel._COUNTERS and not mask_kernel._SCRATCH
    assert sched.n_engine_resets == 1
    assert torch.equal(decode_attention(q, kp, vp, ln, block_tables=tbl),
                       attn)
    again = masked_argmax(lg, bits)
    assert torch.equal(again[0], sel[0]) and torch.equal(again[1], sel[1])


# -- CUDA graphs: the fused decode block's replays ---------------------------


def _graph_replays_eager(cuda_device, fn, wrapper, mutate):
    """``fn`` recorded as a graph replays to the bits of an eager call, on
    its inputs and again after ``mutate()`` rewrote them in place, and each
    replay credits ``wrapper`` with the one launch it recorded."""
    from repro_torch.serving.fused import RecordedGraph
    want = fn()
    before = wrapper.launches
    graph = RecordedGraph(fn, cuda_device)
    assert wrapper.launches == before + 1          # the warm-up only
    assert graph.recorded == {wrapper: 1}
    graph.replay()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(_leaves(graph.out),
                                                  _leaves(want)))
    mutate()
    want = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_leaves(graph.out),
                                                  _leaves(want)))


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [True, False])
def test_decode_attention_kernel_replays_in_cuda_graph(cuda_device, paged,
                                                       dtype):
    """#1 with keys split across blocks (scratch and merge counters of the
    recording stream), paged and contiguous."""
    q, kp, vp, _, _, ln, tbl = _long_case("1000", 1, 1, cuda_device)
    q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
    if not paged:
        kp = gather_pages(kp, tbl).contiguous()
        vp = gather_pages(vp, tbl).contiguous()
        tbl = None
    _graph_replays_eager(
        cuda_device, lambda: decode_attention(q, kp, vp, ln,
                                              block_tables=tbl),
        attn_kernel.decode_attention_cuda,
        lambda: (q.mul_(-0.5), ln.sub_(1)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [True, False])
def test_split_decode_attention_kernel_replays_in_cuda_graph(cuda_device,
                                                             paged, dtype):
    """#1b at deepseek-v3's width (bf16: keys split, scratch allocated)."""
    q, q2, lat, rp, ln, tbl = [
        torch.from_numpy(x).to(cuda_device) for x in split_case(
            1, seed=97, h=128, r=512, d2=64, lens=SPLIT_LONG_LENS, ps=64,
            mp=16)]
    q, q2, lat, rp = (x.to(dtype) for x in (q, q2, lat, rp))
    if not paged:
        lat = gather_pages(lat, tbl).contiguous()
        rp = gather_pages(rp, tbl).contiguous()
        tbl = None
    kw = dict(scale=0.07, q2=q2, k2=rp, block_tables=tbl)
    _graph_replays_eager(
        cuda_device, lambda: decode_attention(q, lat, lat, ln, **kw),
        attn_kernel.decode_attention_split_cuda,
        lambda: (q.mul_(-0.5), q2.mul_(2.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,v", [(4, 403), (4, 100352)])
def test_masked_argmax_kernel_replays_in_cuda_graph(cuda_device, b, v,
                                                    dtype):
    """#2 at the serving paths' V=403 (one block a row) and at V=100352
    (the vocabulary split, the last block merging through counters)."""
    lg, bits, _ = _argmax_case(cuda_device, b, v, dtype=dtype)
    gen = torch.Generator(cuda_device).manual_seed(1)
    flip = torch.randperm(bits.numel(), device=cuda_device, generator=gen)

    def mutate():
        lg.neg_()
        bits.view(-1)[flip[:bits.numel() // 2]] = -1
    _graph_replays_eager(cuda_device, lambda: masked_argmax(lg, bits),
                         mask_kernel.masked_argmax_packed, mutate)


def _fused_engine(cuda_device, arch):
    """A small float32 model on the card with the JSON grammar's device
    table (the byte-level tokenizer on which it certifies clean)."""
    from repro_torch.core import grammars
    from repro_torch.core.sampling import GrammarSampler
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.tokenizer import train_bpe
    g = grammars.load("json")
    tok = train_bpe(GrammarSampler(g, seed=7).corpus(80), vocab_size=257)
    extra = {} if arch == "attn" else dict(
        family="moe", n_kv_heads=4, group=("moe",),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      n_shared_experts=1, capacity_factor=2.0))
    cfg = ModelConfig(**dict(dict(
        arch_id="tf", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=tok.vocab_size, dtype="float32",
        max_seq_len=256, use_pallas_kernels=True), **extra))
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    model = build_model(cfg)
    eng = ServingEngine(model, model.init(gen, device=cuda_device), tok, g,
                        EngineConfig(mode="domino", max_tokens=16),
                        max_len=256, device_tables=True, device=cuda_device)
    eng.precompute()
    assert eng.device_table_set is not None
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["attn", "mla_moe"])
def test_fused_block_replay_matches_eager(cuda_device, arch):
    """A small model's fused blocks on the card: replayed from one recorded
    graph, the block is bitwise equal to the same block run eagerly
    (outputs and every cache leaf); the run's ids equal the host loop's,
    every replay credits the recorded launches of #1 (or #1b) and #2, and
    an engine reset drops the graph so the next block records again."""
    from repro_torch.serving import ContinuousBatchingScheduler
    from repro_torch.serving.fused import FusedBlock
    eng = _fused_engine(cuda_device, arch)
    prompts = ["a: ", "some much longer json prompt here: ", "x",
               "record -> "]
    host = ContinuousBatchingScheduler(eng, capacity=2)
    for p in prompts:
        host.submit(p)
    want = host.run()
    sched = ContinuousBatchingScheduler(eng, capacity=2, device_loop=True,
                                        sync_n=4)
    for p in prompts:
        sched.submit(p)
    checks = []
    orig = FusedBlock.launch

    def launch(fb, cache, dts):
        if fb.graph is not None and not checks:
            checks.append(fb.replay_matches_eager(cache, dts))
        else:
            orig(fb, cache, dts)
    attn = (attn_kernel.decode_attention_cuda if arch == "attn"
            else attn_kernel.decode_attention_split_cuda)
    FusedBlock.launch = launch
    try:
        got = sched.run()
    finally:
        FusedBlock.launch = orig
    fb = sched._fused
    assert sched.sup.n_degrades == 0 and sched.n_engine_resets == 0
    assert checks == [True]
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert sched.n_device_tokens > 0 and fb.n_replays >= 2
    assert fb.graph.recorded == {attn: 2 * 4,
                                 mask_kernel.masked_argmax_packed: 4}
    sched._engine_reset("test")
    assert fb.graph is None
    for p in prompts[:2]:
        sched.submit(p)
    sched.run()
    assert fb.n_records == 2


@pytest.mark.cuda
def test_device_sampler_on_card(cuda_device):
    """The device sampler on the card: legal tokens only, TV distance to
    the host ``select_token`` under 0.06 over 4000 draws, temperature 0
    giving the masked-argmax kernel's pick."""
    from repro_torch.core import bitmask
    from repro_torch.kernels.masked_sample.ops import masked_sample_packed
    from repro_torch.serving.request import select_token
    rng = np.random.default_rng(0)
    v = 70
    logits = rng.normal(size=v).astype(np.float32) * 2.0
    legal = np.zeros(v, bool)
    legal[rng.choice(v, size=9, replace=False)] = True
    bits = bitmask.pack_bool(legal).view(np.int32)
    temp, n = 0.8, 4000
    keys = torch.tensor(np.stack([np.full(n, 5), np.arange(n)], axis=1),
                        device=cuda_device)
    lg = torch.tensor(np.tile(logits, (n, 1)), device=cuda_device)
    words = torch.tensor(np.tile(bits, (n, 1)), device=cuda_device)
    dev = masked_sample_packed(lg, words, torch.full(
        (n,), temp, device=cuda_device), keys).cpu().numpy()
    assert legal[dev].all()
    host_rng = np.random.default_rng(5)
    host = np.asarray([select_token(logits, legal, temp, host_rng)
                       for _ in range(n)])
    tv = 0.5 * np.abs(np.bincount(dev, minlength=v)[legal] / n
                      - np.bincount(host, minlength=v)[legal] / n).sum()
    assert tv < 0.06, f"TV distance {tv:.3f}"
    greedy = masked_sample_packed(lg[:4], words[:4],
                                  torch.zeros(4, device=cuda_device),
                                  keys[:4])
    assert torch.equal(greedy, masked_argmax(lg[:4], words[:4])[0])


# -- the prefix cache's cached prefill ----------------------------------------


def _tiny_cfg(arch, page_vocab=128):
    """A small float32 paged config: GQA attention, or MLA."""
    extra = {} if arch == "attn" else dict(
        family="moe", n_kv_heads=4, group=("mla",),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16))
    return ModelConfig(**dict(dict(
        arch_id="tc", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=page_vocab, dtype="float32",
        max_seq_len=256), **extra))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["attn", "mla"])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("s", [5, 16, 33])
def test_cached_prefill_kernel_route_matches_plain(cuda_device, arch,
                                                   page_size, s):
    """The scheduler's cached prefill at the model level: a tail window of
    S tokens (S - 3 real, then 3 pads, as in a length bucket) fed as one
    decode over a B=1 view of the pool, whose table maps two shared pages
    (another row's prefix), then the row's private pages (the real tail
    plus one), then zero entries (the trash page).  Through #1 (or #1b)
    the logits agree with the plain path's, and on the real tokens with a
    cold decode of the whole sequence; the shared pages are not written,
    and pad writes past the private pages land on the trash page only."""
    cfg = _tiny_cfg(arch)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    plain = build_model(cfg)
    params = plain.init(gen, device=cuda_device)
    kern = build_model(dataclasses.replace(cfg, use_pallas_kernels=True))
    ps, n_shared, n_pages, mp = page_size, 2, 24, 12
    start = n_shared * ps
    n_real = s - 3
    n_priv = -(-(n_real + 1) // ps)     # admission's +1: the first decode
    toks = torch.from_numpy(np.random.default_rng(s + ps).integers(
        0, 128, (1, start + s))).to(cuda_device)
    shared = [5, 2]
    priv = [9, 4, 7, 13, 11][:n_priv]
    # the donor row writes the shared prefix into pages 5 and 2
    pool = plain.init_cache(1, mp * ps, page_size=ps, n_pages=n_pages,
                            device=cuda_device)
    pool["pages"] = torch.zeros((1, mp), dtype=torch.int32,
                                device=cuda_device)
    pool["pages"][0, :n_shared] = torch.tensor(shared, dtype=torch.int32)
    pool["len"] = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    plain.decode_step(params, pool, toks[:, :start])

    def leaves(c):
        """Every pool leaf with its pages on axis 0 (a group's leaves carry
        a leading reps axis)."""
        return [x for part in ("head", "tail") for blk in c[part]
                for x in blk.values()] + [
            x.transpose(0, 1) for blk in c["group"].values()
            for x in blk.values()]

    table = torch.zeros((1, mp), dtype=torch.int32, device=cuda_device)
    table[0, :n_shared + n_priv] = torch.tensor(shared + priv,
                                                dtype=torch.int32)
    out = {}
    for name, model in (("plain", plain), ("kernel", kern)):
        c = {k: v for k, v in pool.items() if k not in ("head", "tail",
                                                       "group")}
        c["head"] = [{n: x.clone() for n, x in blk.items()}
                     for blk in pool["head"]]
        c["tail"] = [{n: x.clone() for n, x in blk.items()}
                     for blk in pool["tail"]]
        c["group"] = {k: {n: x.clone() for n, x in blk.items()}
                      for k, blk in pool["group"].items()}
        before = [x.clone() for x in leaves(c)]
        view = dict(c, len=torch.tensor([start], dtype=torch.int32,
                                        device=cuda_device), pages=table)
        wrapper = (attn_kernel.decode_attention_cuda if arch == "attn"
                   else attn_kernel.decode_attention_split_cuda)
        n0 = wrapper.launches
        lg, view = model.decode_step(params, view, toks[:, start:])
        if name == "kernel":
            assert wrapper.launches == n0 + cfg.n_layers
        else:
            assert wrapper.launches == n0
        assert int(view["len"][0]) == start + s
        untouched = [p for p in range(n_pages)
                     if p not in priv and p != 0]
        for a, b in zip(before, leaves(c)):
            assert torch.equal(a[untouched], b[untouched])
        out[name] = lg
    torch.testing.assert_close(out["kernel"], out["plain"], atol=1e-4,
                               rtol=1e-4)
    cold = plain.init_cache(1, mp * ps, device=cuda_device)
    cold["len"] = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    lg_cold, _ = plain.decode_step(params, cold, toks)
    torch.testing.assert_close(out["kernel"][:, :n_real],
                               lg_cold[:, start:start + n_real], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
def test_cached_admission_keeps_the_recorded_graph(cuda_device):
    """Certified greedy rows with the prefix cache and the device loop on
    the card: admissions through the cache that arrive between fused
    blocks write the pool, table and lengths in place, so the one recorded
    graph stays; the ids equal the host loop's without the cache."""
    from repro_torch.serving import (ConstraintSpec, ContinuousBatchingScheduler,
                                     DecodeParams, Request)
    eng = _fused_engine(cuda_device, "attn")
    pre = "shared device preamble common to every request: "
    reqs = [Request(pre + f"d{i} ", ConstraintSpec(grammar="default",
                                                   mode="domino"),
                    DecodeParams(max_tokens=12)) for i in range(5)]
    host = ContinuousBatchingScheduler(eng, capacity=2, page_size=8)
    want = [host.submit(r) for r in reqs]
    host.run()
    sched = ContinuousBatchingScheduler(eng, capacity=2, page_size=8,
                                        prefix_cache=True, device_loop=True,
                                        sync_n=4, debug_invariants=True)
    seen = []
    orig = ContinuousBatchingScheduler._cached_prefill

    def cached_prefill(self, *args):
        seen.append(self._fused is not None
                    and self._fused.graph is not None)
        return orig(self, *args)
    ContinuousBatchingScheduler._cached_prefill = cached_prefill
    try:
        got = [sched.submit(r) for r in reqs]
        sched.run()
    finally:
        ContinuousBatchingScheduler._cached_prefill = orig
    assert [s.result.token_ids for s in got] == \
        [s.result.token_ids for s in want]
    fb = sched._fused
    assert any(seen) and sched.n_prefix_hits > 0
    assert fb.n_records == 1 and fb.n_replays >= 2
    assert sched.n_device_tokens > 0 and sched.n_engine_resets == 0
    sched.prefix_cache.reset()
    assert sched.pool.available == sched.n_pages - 1


# -- training: the grad guard, the flash backward, a train step -------------


def wrapper_calls(torch, device, requires_grad):
    """name -> (launch wrapper, operands) for each kernel's wrapper at a
    small valid shape on ``device``, the first float operand requiring grad
    if ``requires_grad``."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, decode_attention_split_cuda)
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan_cuda
    from repro_torch.kernels.masked_sample.kernel import (
        masked_argmax_bytes, masked_argmax_packed)
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    gen = torch.Generator().manual_seed(0)

    def f(*shape, grad=False):
        t = torch.randn(shape, generator=gen).to(device)
        return t.requires_grad_(requires_grad and grad)

    lens = torch.tensor([4], dtype=torch.int32, device=device)
    lat = f(1, 8, 1, 16)
    return {
        "decode_attention": (decode_attention_cuda, (
            f(1, 1, 1, 1, 16, grad=True), f(1, 8, 1, 16), f(1, 8, 1, 16),
            lens)),
        "decode_attention_split": (decode_attention_split_cuda, (
            f(1, 1, 1, 2, 16, grad=True), lat, lat, f(1, 1, 1, 2, 8),
            f(1, 8, 1, 8), lens)),
        "masked_argmax_packed": (masked_argmax_packed, (
            f(1, 64, grad=True),
            torch.full((1, 2), -1, dtype=torch.int32, device=device))),
        "masked_argmax_bytes": (masked_argmax_bytes, (
            f(1, 64, grad=True),
            torch.ones((1, 64), dtype=torch.bool, device=device))),
        "mamba_scan": (mamba_scan_cuda, (
            f(1, 2, 4, grad=True).abs(), f(1, 2, 4), f(1, 2, 4), f(1, 2, 4),
            -f(4, 4).abs(), f(1, 4, 4))),
        "ssd_scan": (ssd_scan_cuda, (
            f(1, 2, 1, 8, grad=True), f(1, 2, 8), f(1, 2, 8),
            -f(1, 2, 1).abs(), f(1, 2, 1).abs(), f(1, 1, 8, 8))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode_attention", "decode_attention_split",
                                  "masked_argmax_packed",
                                  "masked_argmax_bytes", "mamba_scan",
                                  "ssd_scan"])
def test_kernel_wrapper_refuses_an_operand_that_requires_grad(cuda_device,
                                                              name):
    """The kernels have no backward: a launch that autograd would record
    raises, and launches nothing; under ``no_grad`` the same call runs."""
    fn, args = wrapper_calls(torch, cuda_device, requires_grad=True)[name]
    before = fn.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    assert fn.launches == before
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 48])
def test_blocked_attention_backward_on_card_matches_cpu(cuda_device, window):
    """The flash backward (tiles recomputed) on the card against the same
    function's grads on the CPU, float32, atol 2e-4, rtol 1e-3 (the JAX
    package's custom-VJP test's)."""
    from repro_torch.models.flash import blocked_attention
    rng = np.random.default_rng(11)
    b, s, g, qh, d = 2, 256, 2, 2, 32
    arrays = (rng.normal(size=(b, s, g, qh, d)), rng.normal(size=(b, s, g, d)),
              rng.normal(size=(b, s, g, d)))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    grads = []
    for dev in ("cpu", cuda_device):
        q, k, v = (torch.tensor(a, dtype=torch.float32, device=dev,
                                requires_grad=True) for a in arrays)
        p = torch.from_numpy(pos).to(dev)
        out = blocked_attention(q, k, v, p, p, window, None, 64, 128)
        grads.append([t.cpu() for t in torch.autograd.grad(
            (out ** 2).sum(), (q, k, v))])
    for a, c in zip(*grads):
        np.testing.assert_allclose(c.numpy(), a.numpy(), atol=2e-4,
                                   rtol=1e-3)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One AdamW step of the SMOKE dense model on identical batches: the
    loss and grad norm within float32 tolerance (rtol 1e-5), and the new
    params within 2 lr + 1e-6 -- at step 1 AdamW moves every element by
    about +-lr whatever its gradient's size, so a near-zero gradient whose
    sign differs between the devices' sums moves by 2 lr."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import (params_from_numpy,
                                            params_to_numpy, tree_items)
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step, to_device
    cfg = get_config("stablelm-1.6b", smoke=True)
    model = build_model(cfg)
    ocfg = opt.AdamWConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 65)).astype(np.int32)
    params = params_to_numpy(model.init(device="cpu"))
    runs = []
    for dev in ("cpu", cuda_device):
        p = params_from_numpy(params, cfg, dev)
        new, _, met = make_train_step(model, ocfg)(
            p, opt.init_state(p), to_device({"tokens": toks}, dev))
        runs.append((params_to_numpy(new), {k: float(v)
                                            for k, v in met.items()}))
    (want, wm), (got, gm) = runs
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5)
    flat = dict(tree_items(got))
    for path, w in tree_items(want):
        np.testing.assert_allclose(flat[path], w, rtol=0,
                                   atol=2 * ocfg.lr + 1e-6, err_msg=str(path))


@pytest.mark.cuda
def test_mesh_1x1_step_equals_unsharded_step(cuda_device):
    """The trainer's ``--mesh 1x1``: an NCCL world of one rank over a file
    store, the params and moments DTensors on a 1 x 1 mesh; its losses and
    grad norms equal the unsharded trainer's (rtol 1e-5, as the step
    parity above), and the world is gone after it."""
    import torch.distributed as dist

    from repro_torch.launch import train
    flags = ["--smoke", "--steps", "2", "--batch", "4", "--seq", "32",
             "--dtype", "float32"]
    plain = train.main(flags)
    mesh = train.main(flags + ["--mesh", "1x1"])
    assert not dist.is_initialized()
    np.testing.assert_allclose(mesh["losses"], plain["losses"], rtol=1e-5)
    np.testing.assert_allclose(mesh["grad_norms"], plain["grad_norms"],
                               rtol=1e-5)
    with pytest.raises(RuntimeError, match="cards"):
        train.main(flags + ["--mesh", f"{torch.cuda.device_count() + 1}x1"])
