"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. This
file imports neither jax nor the JAX package, so on the card (where jax
is not installed) it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerances: float32 pools atol 1e-4 (fp32 accumulation in another order
than the plain version's einsum); bfloat16 atol 1e-3, rtol 1e-2 (both
accumulate in fp32; the rtol covers one bf16 ulp of the rounded output). Appended rows must be bit copies and no
other pool byte may change, apart from the trash page 0."""

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.ops import paged_attention as tpa
from generativeaiexamples_tpu_torch.ops import quant


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _setup(dev, *, H, KV, hd, page, lengths, dtype, L=2, seed=0, extra_w=0):
    g = torch.Generator().manual_seed(seed)
    B = len(lengths)
    W = max(-(-(n + 1) // page) for n in lengths) + extra_w
    N = 1 + B * W

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dtype).to(dev)

    q, ck, cv = rnd(B, H, hd), rnd(B, KV, hd), rnd(B, KV, hd)
    pk, pv = rnd(L, N, KV, page, hd), rnd(L, N, KV, page, hd)
    table = (1 + torch.randperm(B * W, generator=g)).reshape(B, W).to(
        torch.int32).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    live = lens > 0
    wp = torch.where(live, table.gather(1, (lens // page)[:, None].long())
                     [:, 0], torch.zeros_like(lens)).to(torch.int32)
    off = torch.where(live, lens % page, torch.zeros_like(lens)).to(
        torch.int32)
    return q, pk, pv, table, lens, ck, cv, wp, off


CASES = [
    # (H, KV, hd, page, lengths, dtype)
    (8, 8, 128, 16, [0, 1, 15, 16, 17, 40], torch.float32),     # G = 1
    (8, 4, 64, 16, [33, 0, 31, 2], torch.float32),              # G = 2
    (16, 4, 64, 32, [1, 63, 64, 65], torch.float32),            # G = 4
    (32, 4, 128, 128, [300, 0, 129], torch.float32),            # G = 8
    (32, 32, 128, 128, [0, 127, 128, 129, 700], torch.bfloat16),
    (16, 2, 32, 8, [7, 8, 9, 0], torch.bfloat16),               # hd 32
    (8, 8, 256, 16, [5, 50], torch.bfloat16),                   # hd 256
]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd,page,lengths,dtype", CASES)
def test_kernel_matches_plain(dev, H, KV, hd, page, lengths, dtype):
    args = _setup(dev, H=H, KV=KV, hd=hd, page=page, lengths=lengths,
                  dtype=dtype)
    q, pk, pv, table, lens, ck, cv, wp, off = args
    layer = 1
    kk, kv_ = pk.clone(), pv.clone()
    before = tpa.paged_attention_decode.launches
    out = tpa.paged_attention_decode(q, kk, kv_, table, lens, ck, cv, wp,
                                     off, layer)
    assert tpa.paged_attention_decode.launches == before + 1
    rk, rv = pk.clone(), pv.clone()
    ref = tpa.paged_attention_decode_plain(q, rk, rv, table, lens, ck, cv,
                                           wp, off, layer)
    torch.cuda.synchronize()
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (1e-3, 1e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    live = (lens > 0).nonzero()[:, 0]
    touched = torch.zeros(pk.shape[:4], dtype=torch.bool, device=dev)
    touched[layer, 0] = True
    touched[layer, wp[live].long(), :, off[live].long()] = True
    for new, old, cur in ((kk, pk, ck), (kv_, pv, cv)):
        assert torch.equal(new[layer, wp[live].long(), :, off[live].long()],
                           cur[live])
        keep = ~touched[..., None].expand_as(new)
        assert torch.equal(new[keep], old[keep])


@pytest.mark.cuda
def test_kernel_reads_a_column_slice_of_the_table(dev):
    """The engine passes ``table[:, :window]``: rows keep the wide
    table's stride."""
    args = _setup(dev, H=8, KV=4, hd=64, page=16, lengths=[20, 5, 0],
                  dtype=torch.float32, extra_w=3)
    q, pk, pv, table, lens, ck, cv, wp, off = args
    window = table[:, :2]
    assert not window.is_contiguous()
    out = tpa.paged_attention_decode(q, pk.clone(), pv.clone(), window,
                                     lens, ck, cv, wp, off, 0)
    ref = tpa.paged_attention_decode_plain(q, pk.clone(), pv.clone(),
                                           window.contiguous(), lens, ck, cv,
                                           wp, off, 0)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_wrapper_raises_on_cuda_misuse(dev):
    """On CUDA tensors the wrapper launches the kernel or raises: a
    non-contiguous query, int64 tables, mixed dtypes or a geometry
    outside the gate are refused."""
    args = list(_setup(dev, H=8, KV=4, hd=64, page=16, lengths=[5, 9],
                       dtype=torch.float32)) + [1]
    bad_cases = {
        0: args[0].transpose(0, 1).contiguous().transpose(0, 1),
        3: args[3].long(),
        5: args[5].to(torch.bfloat16),
    }
    for i, bad in bad_cases.items():
        call = list(args)
        call[i] = bad
        with pytest.raises(ValueError):
            tpa.paged_attention_decode(*call)
    wide = _setup(dev, H=64, KV=4, hd=64, page=16, lengths=[5],
                  dtype=torch.float32)                         # G = 16
    with pytest.raises(ValueError, match="kernel gate"):
        tpa.paged_attention_decode(*wide, 0)
    np.testing.assert_array_equal(
        tpa.paged_attention_decode(*args).shape, (2, 8, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
def test_logits_matmul_bf16_operands_f32_result(dev, transposed):
    """``matmul_f32`` on bf16 card tensors (llama-2-7b's lm_head, or the
    tied embedding's transpose) equals the widened float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 4096, generator=g).to(torch.bfloat16).to(dev)
    w = (torch.randn(32000, 4096, generator=g) * 0.02).to(
        torch.bfloat16).to(dev)
    w = w.T if transposed else w.T.contiguous()
    out = quant.matmul_f32(x, w)
    ref = torch.matmul(x.float(), w.float())
    assert out.dtype == torch.float32 and out.shape == (2, 4, 32000)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
