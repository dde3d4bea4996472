"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card, and the model's kernel route against its plain route.  Every
test here is marked ``cuda`` and skips without a card; the file imports
neither ``jax`` nor ``repro`` so that it runs on a machine with only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the argmax is bitwise; float32 attention atol 1e-5 (only the
summation order differs); bfloat16 attention atol = rtol = 2e-2 in float32,
about one bf16 ulp of the output."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import kernel as attn_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      gather_pages)
from repro_torch.kernels.masked_sample import kernel as mask_kernel
from repro_torch.kernels.masked_sample.ops import masked_argmax
from repro_torch.kernels.masked_sample.ref import masked_argmax_ref
from repro_torch.models import build_model
from torch_cases import mask_case, paged_case


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
