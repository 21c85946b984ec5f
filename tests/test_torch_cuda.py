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


# ---------------------------------------------------------- int8 pools
#
# The int8-pool path of the paged kernel against its plain version.
# Tolerances as above; the appended int8 rows and bf16 scales must equal
# the plain version's ``quantize_rows`` bit for bit, and no other pool or
# scale byte may change apart from the trash page 0. Rows at or past each
# length, and their scales, are then poisoned: the kernel must never read
# them.

QUANT_CASES = [
    # (H, KV, hd, page, lengths, q dtype)
    (8, 8, 128, 16, [0, 1, 15, 16, 17, 40], torch.float32),     # G = 1
    (8, 4, 64, 16, [33, 0, 31, 2], torch.float32),              # G = 2
    (16, 4, 64, 128, [1, 127, 128, 129], torch.float32),        # G = 4
    (32, 4, 128, 128, [300, 0, 129], torch.bfloat16),           # G = 8
    (32, 32, 128, 128, [0, 127, 128, 129, 700], torch.bfloat16),
    (16, 16, 64, 16, [7, 8, 9, 0], torch.bfloat16),             # hd 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV,hd,page,lengths,dtype", QUANT_CASES)
def test_int8_kernel_matches_plain(dev, H, KV, hd, page, lengths, dtype):
    from generativeaiexamples_tpu_torch.ops.kv_quant import quantize_rows
    args = _setup(dev, H=H, KV=KV, hd=hd, page=page, lengths=lengths,
                  dtype=dtype)
    q, pk, pv, table, lens, ck, cv, wp, off = args
    (kq, ks), (vq, vs) = quantize_rows(pk), quantize_rows(pv)
    layer = 1
    pools = [kq.clone(), vq.clone(), ks.clone(), vs.clone()]
    before = tpa.paged_attention_decode.int8_launches
    out = tpa.paged_attention_decode(q, pools[0], pools[1], table, lens, ck,
                                     cv, wp, off, layer, pool_ks=pools[2],
                                     pool_vs=pools[3])
    assert tpa.paged_attention_decode.int8_launches == before + 1
    ref_pools = [kq.clone(), vq.clone(), ks.clone(), vs.clone()]
    ref = tpa.paged_attention_decode_quant_plain(
        q, ref_pools[0], ref_pools[1], table, lens, ck, cv, wp, off, layer,
        pool_ks=ref_pools[2], pool_vs=ref_pools[3])
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (1e-3, 1e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    live = (lens > 0).nonzero()[:, 0]
    touched = torch.zeros(pk.shape[:4], dtype=torch.bool, device=dev)
    touched[layer, 0] = True
    touched[layer, wp[live].long(), :, off[live].long()] = True
    idx = (layer, wp[live].long(), slice(None), off[live].long())
    for new, want, old in zip(pools, ref_pools, (kq, vq, ks, vs)):
        if new.dtype == torch.bfloat16:
            new, want, old = (t.view(torch.int16) for t in (new, want, old))
        assert torch.equal(new[idx], want[idx])
        keep = ~touched
        if new.dim() == 5:
            keep = keep[..., None].expand_as(new)
        assert torch.equal(new[keep], old[keep])
    # Rows at or past each length hold 127 and NaN scales (the trash page
    # too): the output stays bit-identical, so none of them was read.
    rows = torch.arange(table.shape[1] * page, device=dev)
    for b, n in enumerate(lengths):
        dead = (rows >= n).reshape(-1, page)
        for t, fill in ((kq, 127), (vq, 127), (ks, float("nan")),
                        (vs, float("nan"))):
            view = t[layer, table[b].long()]
            view[dead[:, None, :].expand(view.shape[:3])] = fill
            t[layer, table[b].long()] = view
            t[layer, 0] = fill
    out_p = tpa.paged_attention_decode(q, kq, vq, table, lens, ck, cv, wp,
                                       off, layer, pool_ks=ks, pool_vs=vs)
    torch.cuda.synchronize()
    assert torch.equal(out_p, out)


# ---------------------------------------------------------- split edges
#
# The kernel's split pass takes R = MIN_SPLIT_ROWS rows per split at these
# shapes (``split_plan``); the merge pass folds the live splits in order.
# Cases put lengths at R - 1, R, R + 1 and k * R (the last split full and
# the appended row starting a fresh page), every slot at 0, one 3000-row
# slot beside short ones, R > page (splits cross page boundaries), G = 8,
# and rows that are not a multiple of 16 bytes (narrower loads). Same
# tolerances, append and no-other-byte checks as above; under int8 pools
# the appended rows and scales equal ``quantize_rows``.

R = tpa.MIN_SPLIT_ROWS
SPLIT_CASES = [
    # (H, KV, hd, page, lengths, dtype)
    (8, 8, 128, 128, [R - 1, R, R + 1, 2 * R, 3 * R], torch.float32),
    (8, 8, 128, 16, [R - 1, R, R + 1, 2 * R, 0], torch.bfloat16),  # R > page
    (4, 4, 64, 32, [0, 0, 0], torch.float32),                   # all at 0
    (8, 8, 128, 128, [3000, 1, 5, 0], torch.bfloat16),          # one long
    (32, 4, 128, 16, [R - 1, R, R + 1, 1000], torch.bfloat16),  # G = 8
    (16, 2, 64, 8, [R - 1, R, R + 1], torch.float32),           # G = 8
    (8, 8, 36, 16, [R + 1, 7, 300], torch.bfloat16),  # 72-byte rows
    (8, 4, 33, 16, [R - 1, 64, 0], torch.float32),    # 132-byte rows
    (8, 8, 40, 16, [R + 2, 2 * R - 1], torch.bfloat16),  # int8: 40 bytes
]


def _int8_pools(pk, pv):
    from generativeaiexamples_tpu_torch.ops.kv_quant import quantize_rows
    (kq, ks), (vq, vs) = quantize_rows(pk), quantize_rows(pv)
    return [kq, vq, ks, vs]


def _call(q, pools, table, lens, ck, cv, wp, off, layer):
    scales = ({"pool_ks": pools[2], "pool_vs": pools[3]}
              if len(pools) == 4 else {})
    return tpa.paged_attention_decode(q, pools[0], pools[1], table, lens, ck,
                                      cv, wp, off, layer, **scales)


def _plain(q, pools, table, lens, ck, cv, wp, off, layer):
    if len(pools) == 4:
        return tpa.paged_attention_decode_quant_plain(
            q, pools[0], pools[1], table, lens, ck, cv, wp, off, layer,
            pool_ks=pools[2], pool_vs=pools[3])
    return tpa.paged_attention_decode_plain(q, pools[0], pools[1], table,
                                            lens, ck, cv, wp, off, layer)


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _poison(pools, table, lengths, page, layer):
    """Rows at or past each length and the trash page: NaN (int8 pools:
    127 rows and NaN scales)."""
    poisoned = [t.clone() for t in pools]
    quant = len(pools) == 4
    fills = (127, 127, float("nan"), float("nan")) if quant else (
        float("nan"), float("nan"))
    rows = torch.arange(table.shape[1] * page, device=table.device)
    for b, n in enumerate(lengths):
        dead = (rows >= n).reshape(-1, page)
        for t, fill in zip(poisoned, fills):
            view = t[layer, table[b].long()]
            view[dead[:, None, :].expand(view.shape[:3])] = fill
            t[layer, table[b].long()] = view
            t[layer, 0] = fill
    return poisoned


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("H,KV,hd,page,lengths,dtype", SPLIT_CASES)
def test_split_edges_match_plain(dev, H, KV, hd, page, lengths, dtype,
                                 quant):
    q, pk, pv, table, lens, ck, cv, wp, off = _setup(
        dev, H=H, KV=KV, hd=hd, page=page, lengths=lengths, dtype=dtype,
        seed=len(lengths) + hd)
    rows, splits = tpa.split_plan(table.shape[1], page, len(lengths), KV)
    assert rows == R and splits * rows >= table.shape[1] * page
    layer = 1
    pools = _int8_pools(pk, pv) if quant else [pk, pv]
    new = [t.clone() for t in pools]
    ref_pools = [t.clone() for t in pools]
    out = _call(q, new, table, lens, ck, cv, wp, off, layer)
    ref = _plain(q, ref_pools, table, lens, ck, cv, wp, off, layer)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.isfinite(out.float()).all()
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (1e-3, 1e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    live = (lens > 0).nonzero()[:, 0]
    touched = torch.zeros(pk.shape[:4], dtype=torch.bool, device=dev)
    touched[layer, 0] = True
    touched[layer, wp[live].long(), :, off[live].long()] = True
    idx = (layer, wp[live].long(), slice(None), off[live].long())
    for got, want, old in zip(new, ref_pools, pools):
        assert torch.equal(_bits(got[idx]), _bits(want[idx]))
        keep = ~touched
        if got.dim() == 5:
            keep = keep[..., None].expand_as(got)
        assert torch.equal(_bits(got[keep]), _bits(old[keep]))
    # A slot of length 0 attends over nothing: its output is cur_v.
    G = H // KV
    for b in (lens == 0).nonzero()[:, 0].tolist():
        assert torch.equal(out[b], cv[b].repeat_interleave(G, dim=0).to(
            out.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_launches_are_bit_identical(dev, dtype, quant):
    """The merge pass folds the splits in a fixed order: two launches on
    the same inputs give identical outputs and identical pools."""
    args = _setup(dev, H=32, KV=32, hd=128, page=128,
                  lengths=[3000, 0, 127, 128, 129, 1000], dtype=dtype)
    q, pk, pv, table, lens, ck, cv, wp, off = args
    pools = _int8_pools(pk, pv) if quant else [pk, pv]
    runs = []
    for _ in range(2):
        p = [t.clone() for t in pools]
        runs.append((_call(q, p, table, lens, ck, cv, wp, off, 0), p))
    torch.cuda.synchronize()
    (out_a, pools_a), (out_b, pools_b) = runs
    assert torch.equal(_bits(out_a), _bits(out_b))
    for a, b in zip(pools_a, pools_b):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("page", [16, 128])
def test_poison_past_lengths_across_split_edges(dev, page, quant):
    """NaN rows (int8: 127 rows, NaN scales) at and past each length, on
    both sides of split boundaries and in the trash page, leave the
    output bit-identical: masked rows are skipped, never weighted by 0."""
    lengths = [127, 128, 129, 255, 256, 257, 0, 640]
    args = _setup(dev, H=8, KV=8, hd=128, page=page, lengths=lengths,
                  dtype=torch.bfloat16)
    q, pk, pv, table, lens, ck, cv, wp, off = args
    pools = _int8_pools(pk, pv) if quant else [pk, pv]
    out = _call(q, [t.clone() for t in pools], table, lens, ck, cv, wp, off,
                1)
    out_p = _call(q, _poison(pools, table, lengths, page, 1), table, lens,
                  ck, cv, wp, off, 1)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert torch.equal(_bits(out_p), _bits(out))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
def test_misaligned_pool_base_takes_narrower_loads(dev, quant):
    """A pool that starts one element past a 16-byte boundary cannot take
    16-byte loads; the kernel narrows its loads (one element) and still
    agrees with the plain version at the bf16 tolerance."""
    args = _setup(dev, H=8, KV=8, hd=128, page=16, lengths=[300, 5, 129],
                  dtype=torch.bfloat16)
    q, pk, pv, table, lens, ck, cv, wp, off = args
    pools = _int8_pools(pk, pv) if quant else [pk, pv]
    shifted = []
    for t in pools[:2]:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        shifted.append(view)
    shifted += [t.clone() for t in pools[2:]]
    want = _plain(q, [t.clone() for t in pools], table, lens, ck, cv, wp,
                  off, 0)
    got = _call(q, shifted, table, lens, ck, cv, wp, off, 0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                               rtol=1e-2)


@pytest.mark.cuda
def test_two_streams_keep_their_own_scratch(dev):
    """Calls queued on two streams at once agree with calls on one: the
    wrapper takes each call's scratch from the current stream's
    allocator, so no two queued calls share one."""
    cases = [_setup(dev, H=32, KV=32, hd=128, page=128,
                    lengths=[2000, 129, 0, 700], dtype=torch.bfloat16,
                    seed=s) for s in (11, 12)]
    want = [_call(c[0], [c[1].clone(), c[2].clone()], *c[3:], 0)
            for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in cases]
    got = [[] for _ in cases]
    for _ in range(10):
        for c, s, outs in zip(cases, streams, got):
            with torch.cuda.stream(s):
                outs.append(_call(c[0], [c[1].clone(), c[2].clone()], *c[3:],
                                  0))
    torch.cuda.synchronize()
    for w, outs in zip(want, got):
        for o in outs:
            assert torch.equal(_bits(o), _bits(w))


# ---------------------------------------------------------- int4 matmul
#
# The int4 kernel against its plain version (float32 sums on both sides
# from identical inputs): float32 out atol 1e-4 * max|ref|, rtol 1e-4;
# bf16 out rtol 1e-2 (one bf16 ulp is 2^-8 relative) with an atol of one
# bf16 ulp of max|ref| for outputs near zero.

INT4_CASES = [
    # (M, K, N, group: 0 = per channel). bf16 x takes tensor cores when K
    # and N are multiples of 16 and the scales are per channel or groups
    # of a multiple of 128 ("tc" at M <= 8, "wg" above); other shapes
    # with M <= 8 and N % 4 == 0 the fp32 GEMV; the rest the tiled path
    # (``_path``).
    (1, 256, 96, 0), (3, 256, 96, 32), (33, 512, 200, 64),
    (8, 384, 130, 128), (1, 4096, 4096, 128), (33, 11008, 64, 128),
    (100, 96, 33, 32), (8, 250, 77, 0), (8, 250, 96, 0),
    (5, 11008, 512, 128), (3, 4096, 1024, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,group", INT4_CASES)
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_int4_kernel_matches_plain(dev, M, K, N, group, x_dtype, out_dtype):
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(M * 7 + K + N)
    w = (torch.randn(K, N, generator=g) * 0.05).to(dev)
    leaf = (quant.quantize_tensor_grouped(w, group) if group
            else quant.quantize_tensor(w, 4))
    scale = leaf["gscale"] if group else leaf["scale"]
    x = torch.randn(M, K, generator=g).to(x_dtype).to(dev)
    path = ti4._path(M, K, N, group or K, x_dtype)
    before = ti4.int4_matmul.launches
    by_path = dict(ti4.int4_matmul.launches_by_path)
    got = ti4.int4_matmul(x, leaf["q4"], scale, out_dtype=out_dtype)
    assert ti4.int4_matmul.launches == before + 1
    by_path[path] += 1
    assert ti4.int4_matmul.launches_by_path == by_path
    ref = ti4.int4_matmul_plain(x, leaf["q4"], scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    _assert_int4_close(got, ref, out_dtype)


def _assert_int4_close(got, ref, out_dtype):
    peak = ref.float().abs().max().item()
    if out_dtype == torch.float32:
        atol, rtol = 1e-4 * peak, 1e-4
    else:
        atol, rtol = peak * 2 ** -8, 1e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                               rtol=rtol)


TC_CASES = [
    # (M, K, N, group: 0 = per channel), all on the tensor-core path.
    (1, 4096, 4096, 128), (3, 4096, 11008, 128),     # odd M: empty slots
    (5, 11008, 4096, 0), (7, 4096, 1024, 0),
    (3, 4096, 208, 128),     # N = 208: a ragged last 128-column slab
    (5, 1024, 208, 128),     # two groups in each block's split-K range
    (7, 1536, 80, 384),      # groups straddle the split-K ranges
    (1, 208, 16, 0),         # one partial slab, a ragged last stage
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,group", TC_CASES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int4_tensor_core_path_matches_plain(dev, M, K, N, group, out_dtype):
    """The tensor-core path (bf16 x, M <= 8) against the plain version:
    odd M, a ragged last column slab, group boundaries inside a split-K
    range and groups that span two ranges."""
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    assert ti4._path(M, K, N, group or K, torch.bfloat16) == "tc"
    g = torch.Generator().manual_seed(M * 11 + K + N)
    w = (torch.randn(K, N, generator=g) * 0.05).to(dev)
    leaf = (quant.quantize_tensor_grouped(w, group) if group
            else quant.quantize_tensor(w, 4))
    scale = leaf["gscale"] if group else leaf["scale"]
    x = torch.randn(M, K, generator=g).to(torch.bfloat16).to(dev)
    before = ti4.int4_matmul.launches_by_path["tc"]
    got = ti4.int4_matmul(x, leaf["q4"], scale, out_dtype=out_dtype)
    assert ti4.int4_matmul.launches_by_path["tc"] == before + 1
    ref = ti4.int4_matmul_plain(x, leaf["q4"], scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert torch.isfinite(got.float()).all()
    _assert_int4_close(got, ref, out_dtype)


WG_CASES = [
    # (M, K, N, group: 0 = per channel), all on the "wg" path.
    (9, 4096, 4096, 128),       # a partial token tile, split-K
    (127, 4096, 11008, 128),
    (200, 11008, 4096, 128),    # two token tiles, the second partial
    (128, 4096, 1024, 0),       # per channel, split-K
    (1024, 4096, 4096, 0),      # per channel, the tiles fill a wave
    (128, 4096, 4096, 256),     # group boundaries inside a split-K range
    (128, 1536, 256, 384),      # groups straddle the split-K ranges
    (33, 208, 80, 0),           # a ragged last stage and column slab
    (300, 1024, 208, 128),      # a ragged last slab, three token tiles
]


def _wg_case(dev, M, K, N, group, seed):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn(K, N, generator=g) * 0.05).to(dev)
    leaf = (quant.quantize_tensor_grouped(w, group) if group
            else quant.quantize_tensor(w, 4))
    scale = leaf["gscale"] if group else leaf["scale"]
    x = torch.randn(M, K, generator=g).to(torch.bfloat16).to(dev)
    return x, leaf["q4"], scale


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,group", WG_CASES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int4_warpgroup_path_matches_plain(dev, M, K, N, group, out_dtype):
    """The warpgroup tensor-core path (bf16 x, M > 8) against the plain
    version: partial token tiles, per channel, group boundaries inside
    and across split-K ranges, ragged last stages and column slabs."""
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    assert ti4._path(M, K, N, group or K, torch.bfloat16) == "wg"
    x, q4, scale = _wg_case(dev, M, K, N, group, M * 13 + K + N)
    before = ti4.int4_matmul.launches_by_path["wg"]
    got = ti4.int4_matmul(x, q4, scale, out_dtype=out_dtype)
    assert ti4.int4_matmul.launches_by_path["wg"] == before + 1
    ref = ti4.int4_matmul_plain(x, q4, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert torch.isfinite(got.float()).all()
    _assert_int4_close(got, ref, out_dtype)


@pytest.mark.cuda
def test_int4_warpgroup_path_misaligned_x_and_repeatable(dev):
    """A bf16 x view off a 16-byte boundary (TMA needs one) is realigned
    and gives the aligned result; two launches are bit-identical (the
    split-K sum runs in a fixed order)."""
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    M, K, N = 128, 4096, 4096
    x, q4, scale = _wg_case(dev, M, K, N, 128, 5)
    buf = torch.empty(M * K + 1, dtype=torch.bfloat16, device=dev)
    shifted = buf[1:].view(M, K)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    want = ti4.int4_matmul(x, q4, scale)
    again = ti4.int4_matmul(x, q4, scale)
    got = ti4.int4_matmul(shifted, q4, scale)
    torch.cuda.synchronize()
    assert torch.equal(want, again)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_int4_path_refuses_a_shape_outside_its_gate(dev, monkeypatch):
    """A shape outside "wg"'s gate named "wg" makes the C entry point
    return cudaErrorInvalidValue (1) and the wrapper raise: nothing falls
    back to another path."""
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    M, K, N = 16, 256, 200          # N % 16 != 0: "tile"'s shape
    x, q4, scale = _wg_case(dev, M, K, N, 128, 6)
    assert ti4._path(M, K, N, 128, torch.bfloat16) == "tile"
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    err = ti4._kernel()(
        ti4._PATHS["wg"], 0, 0, x.data_ptr(), q4.data_ptr(),
        scale.data_ptr(), None, out.data_ptr(), None, 0, None, 0, M, K, N,
        128, N, N, torch.cuda.current_stream().cuda_stream)
    assert err == 1
    # Zero points on a path without the term: refused as well.
    err = ti4._kernel()(
        ti4._PATHS["tile"], 0, 0, x.data_ptr(), q4.data_ptr(),
        scale.data_ptr(), scale.data_ptr(), out.data_ptr(), None, 0, None,
        0, M, K, N, 128, N, N, torch.cuda.current_stream().cuda_stream)
    assert err == 1
    monkeypatch.setattr(ti4, "_path", lambda *args: "wg")
    before = dict(ti4.int4_matmul.launches_by_path)
    with pytest.raises(RuntimeError, match="'wg' path launch failed"):
        ti4.int4_matmul(x, q4, scale)
    assert ti4.int4_matmul.launches_by_path == before


# The split-K paths, the x dtype and an M that select each.
SPLIT_K_PATHS = [("tc", torch.bfloat16, 8), ("gemv", torch.float32, 8),
                 ("wg", torch.bfloat16, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("path,x_dtype,M", SPLIT_K_PATHS)
def test_int4_split_k_leaves_scratch_reusable(dev, path, x_dtype, M):
    """Split-K launches of different shapes in a row give the same result
    as one at a time (on the GEMV path the counters must be back at 0
    after each; the tensor-core paths reduce within a cluster)."""
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    g = torch.Generator().manual_seed(3)
    cases = []
    for K, N in ((4096, 4096), (11008, 512), (4096, 1024)):
        w = (torch.randn(K, N, generator=g) * 0.05).to(dev)
        leaf = quant.quantize_tensor_grouped(w, 128)
        x = torch.randn(M, K, generator=g).to(x_dtype).to(dev)
        assert ti4._path(M, K, N, 128, x_dtype) == path
        cases.append((x, leaf["q4"], leaf["gscale"]))
    before = ti4.int4_matmul.launches_by_path[path]
    first = [ti4.int4_matmul(*c) for c in cases]
    assert ti4.int4_matmul.launches_by_path[path] == before + len(cases)
    again = [ti4.int4_matmul(*c) for c in cases for _ in range(3)][::3]
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    if path == "gemv":   # the tensor-core paths reduce within a cluster
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _, counters = ti4._scratch[(x.device, stream)]
        assert not counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("path,x_dtype,M", SPLIT_K_PATHS)
def test_int4_split_k_streams_keep_their_own_scratch(dev, path, x_dtype, M):
    """Split-K launches queued on two streams at once agree with launches
    on one stream (on the GEMV path each stream has its own workspace and
    counters; the tensor-core paths keep no state between launches)."""
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    g = torch.Generator().manual_seed(4)
    K, N = 4096, 11008
    assert ti4._path(M, K, N, 128, x_dtype) == path
    leaf = quant.quantize_tensor_grouped(
        (torch.randn(K, N, generator=g) * 0.05).to(dev), 128)
    xs = [torch.randn(M, K, generator=g).to(x_dtype).to(dev)
          for _ in range(2)]
    want = [ti4.int4_matmul(x, leaf["q4"], leaf["gscale"]) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in xs]
    got = [[] for _ in xs]
    for _ in range(20):
        for x, s, out in zip(xs, streams, got):
            with torch.cuda.stream(s):
                out.append(ti4.int4_matmul(x, leaf["q4"], leaf["gscale"]))
    torch.cuda.synchronize()
    for w, outs in zip(want, got):
        for o in outs:
            assert torch.equal(o, w)
    if path == "gemv":   # the tensor-core paths need no scratch
        pairs = [ti4._scratch[(xs[0].device, s.cuda_stream)]
                 for s in streams]
        assert pairs[0][0].data_ptr() != pairs[1][0].data_ptr()
        assert not any(c.any() for _, c in pairs)


@pytest.mark.cuda
def test_int4_kernel_leading_dims_and_quant_matmul(dev):
    """``quant.matmul`` sends an int4 leaf on the card through the kernel
    (AWQ pre_scale folded into x), and refuses GPTQ zero points."""
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    from generativeaiexamples_tpu_torch.utils.errors import ConfigError
    g = torch.Generator().manual_seed(1)
    w = (torch.randn(256, 64, generator=g) * 0.05).to(dev)
    leaf = dict(quant.quantize_tensor_grouped(w, 64))
    leaf["pre_scale"] = torch.rand(256, generator=g).to(dev) + 0.5
    x = torch.randn(2, 3, 256, generator=g).to(dev)
    before = ti4.int4_matmul.launches
    got = quant.matmul(x, leaf)
    assert ti4.int4_matmul.launches == before + 1
    ref = quant._grouped_matmul(x, quant._unpack4(leaf["q4"]), leaf)
    assert got.shape == (2, 3, 64)
    torch.testing.assert_close(got, ref, atol=1e-4 * ref.abs().max().item(),
                               rtol=1e-4)
    # GPTQ zero points: float32 x (the "gemv"/"tile" paths) refuses them;
    # bf16 x over groups of 128 runs them through the kernel's
    # tensor-core paths, equal to the reference's _grouped_matmul.
    leaf["gbias"] = torch.zeros_like(leaf["gscale"])
    with pytest.raises(ConfigError, match="gbias"):
        quant.matmul(x, leaf)
    w = (torch.randn(256, 64, generator=g) * 0.05).to(dev)
    gl = dict(quant.quantize_tensor_grouped(w, 128))
    gl["gbias"] = torch.randn(gl["gscale"].shape, generator=g).to(dev) \
        * gl["gscale"]
    for M in (3, 40):
        xb = torch.randn(2, M, 256, generator=g).to(dev).to(torch.bfloat16)
        n0 = ti4.int4_matmul.gbias_launches
        got = quant.matmul_f32(xb, gl)
        assert ti4.int4_matmul.gbias_launches == n0 + 1
        ref = quant._grouped_matmul(xb, quant._unpack4(gl["q4"]), gl,
                                    out_dtype=torch.float32)
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-4 * ref.abs().max().item())


# GPTQ zero points on the tensor-core paths: (M, K, N); "tc" at M <= 8,
# "wg" above, with K past one stage, a ragged token tile and a head
# tile's width.
GBIAS_CASES = [(1, 256, 128), (8, 1024, 384), (5, 4096, 16000),
               (9, 512, 256), (64, 1024, 384), (200, 384, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", GBIAS_CASES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int4_gbias_matches_plain(dev, M, K, N, out_dtype):
    """#3 with GPTQ zero points against its plain version (the
    reference's _grouped_matmul, which sums float32 x: here the same bf16
    x widened, so only the fp32 order differs): float32 out rtol 1e-4,
    bf16 out rtol 1e-2, atol 1e-4 * max|ref|. The launch counts under
    its path and with zero points."""
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    g = torch.Generator().manual_seed(M * 7 + K)
    q = torch.randint(-8, 8, (K, N), generator=g, dtype=torch.int8)
    q4 = ((q[0::2] & 0x0F) | (q[1::2] << 4)).to(dev)
    s = (torch.rand((K // 128, N), generator=g) + 0.5).to(dev) * 0.01
    zb = (7 - torch.randint(0, 16, s.shape, generator=g)).to(dev) * s
    x = torch.randn(M, K, generator=g).to(dev).to(torch.bfloat16)
    path = "tc" if M <= 8 else "wg"
    n0 = (ti4.int4_matmul.launches_by_path[path],
          ti4.int4_matmul.gbias_launches)
    got = ti4.int4_matmul(x, q4, s, gbias=zb, out_dtype=out_dtype)
    assert (ti4.int4_matmul.launches_by_path[path],
            ti4.int4_matmul.gbias_launches) == (n0[0] + 1, n0[1] + 1)
    ref = ti4.int4_matmul_plain(x, q4, s, gbias=zb, out_dtype=out_dtype)
    rtol = 1e-4 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                               atol=1e-4 * ref.float().abs().max().item())


@pytest.mark.cuda
def test_int4_gbias_reads_a_head_tile_in_place(dev):
    """A vocab slice of a GPTQ head (q4, scales and zero points read at
    the head's row stride, never copied) equals the plain version on
    contiguous copies."""
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    g = torch.Generator().manual_seed(3)
    K, V, t0, tile = 512, 4096, 1024, 1024
    q4 = torch.randint(-128, 128, (K // 2, V), generator=g,
                       dtype=torch.int8).to(dev)
    s = (torch.rand((K // 128, V), generator=g) * 0.01).to(dev)
    zb = torch.randn((K // 128, V), generator=g).to(dev) * s
    x = torch.randn(4, K, generator=g).to(dev).to(torch.bfloat16)
    sl = (q4[:, t0:t0 + tile], s[:, t0:t0 + tile], zb[:, t0:t0 + tile])
    got = ti4.int4_matmul(x, *sl[:2], gbias=sl[2], out_dtype=torch.float32)
    ref = ti4.int4_matmul_plain(x, *(t.contiguous() for t in sl[:2]),
                                gbias=sl[2].contiguous(),
                                out_dtype=torch.float32)
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-4 * ref.abs().max().item())


# ------------------------------------------------------ engine CUDA graphs

# The budget is pinned so that graph and eager engines (the latter plans
# with the class defaults, not a measurement) make the same plans.
_GRAPH_KW = dict(max_slots=4, max_input_length=512, max_output_length=24,
                 prefill_buckets=(128, 512), kv_pool_tokens=None,
                 sched_round_budget_tokens=4096)


def _model(dev, mode, num_layers=2):
    """llama-2-7b's full width cut to ``num_layers``, random weights from
    seed 0: "f32" (float32, TF32 off), "bf16", or "int4" (bf16 weights
    quantized to int4_awq, group 128, over an int8 KV pool)."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(LLAMA2_7B, num_layers=num_layers)
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    params = llama.init_params(cfg, seed=0, dtype=dtype, device=dev)
    if mode == "int4":
        params = quant.quantize_params(params, "int4_awq", group_size=128)
    kw = dict(_GRAPH_KW, dtype="float32" if mode == "f32" else "bfloat16",
              kv_quant="int8" if mode == "int4" else "")
    return params, cfg, kw


def _engine_on(dev, params, cfg, **kw):
    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
    return Engine(params, cfg, ByteTokenizer(), EngineConfig(**kw),
                  device=dev)


def _drive(engine, prompts, params):
    """Submit every prompt, then run the serve loop's step on this thread
    until all finish (the same schedule on any engine). Returns the
    streams."""
    streams = [engine.submit(p, sp) for p, sp in zip(prompts, params)]
    for _ in range(200):
        if all(s.finish_reason is not None for s in streams):
            return streams
        engine._step()
    raise AssertionError("requests did not finish in 200 steps")


_PROMPTS = [[1] + [3 + (7 * i + j) % 256 for i in range(n)]
            for j, n in enumerate((126, 127, 128, 40, 300))]


def _first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int4"])
def test_graph_engine_matches_eager_engine(dev, mode):
    """The captured rounds and admissions give the eager engine's greedy
    tokens and leave the same pool bytes (every page but the trash page
    0, which takes racing writes of inactive slots and bucket overhang)
    and slot state: float32 at the 2-layer 7B width exactly, and bf16
    and int4-AWQ + int8 KV likewise (both engines issue the same kernels
    on the same inputs)."""
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    params, cfg, kw = _model(dev, mode)
    sps = [SamplingParams(max_tokens=20, top_k=1, ignore_eos=True)] * len(
        _PROMPTS)
    got = {}
    for graphs_on in (True, False):
        engine = _engine_on(dev, params, cfg, cuda_graphs=graphs_on, **kw)
        assert bool(engine._round_graphs) == graphs_on
        got[graphs_on] = ([s.token_ids for s in _drive(engine, _PROMPTS,
                                                       sps)],
                          engine._state, engine.stats["decode_steps"])
        del engine
    (tg, sg, ng), (te, se, ne) = got[True], got[False]
    for i, (a, b) in enumerate(zip(tg, te)):
        assert a == b, (f"prompt {i}: graph tokens differ from eager at "
                        f"step {_first_difference(a, b)}: {a} vs {b}")
    assert ng == ne > 0
    for name in sg["cache"]:
        assert torch.equal(_bits(sg["cache"][name][:, 1:]),
                           _bits(se["cache"][name][:, 1:])), name
    for name in ("table", "pos", "last_token", "active", "remaining",
                 "seen", "recent", "round_tokens"):
        assert torch.equal(sg[name], se[name]), name


@pytest.mark.cuda
def test_sampled_replays_follow_the_request_seed(dev):
    """Sampled requests on graph engines: two fresh engines give the same
    draws for the same request seed; another seed gives another first
    token (the admission draw); consecutive rounds of one request draw
    fresh noise (at a temperature that makes the logits irrelevant, the
    tokens of two rounds differ)."""
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
    params = llama.init_params(LLAMA_TINY, seed=0, dtype=torch.float32,
                               device=dev)
    kw = dict(max_slots=2, max_input_length=64, max_output_length=40,
              prefill_buckets=(16, 64), page_size=16, dtype="float32",
              kv_pool_tokens=None)

    def run(seed):
        engine = _engine_on(dev, params, LLAMA_TINY, **kw)
        assert engine._admit_graphs and engine._round_graphs
        sp = SamplingParams(max_tokens=33, temperature=1e4, top_k=0,
                            top_p=1.0, ignore_eos=True, random_seed=seed)
        return _drive(engine, [_PROMPTS[3][:20]], [sp])[0].token_ids

    a, b = run(5), run(5)
    assert a == b and len(a) == 33
    firsts = {run(s)[0] for s in (6, 7, 8, 9)} | {a[0]}
    assert len(firsts) > 1
    rounds = [tuple(a[1 + 8 * r:9 + 8 * r]) for r in range(4)]
    assert len(set(rounds)) == 4, rounds


@pytest.mark.cuda
def test_replays_add_their_capture_counts(dev):
    """N replays of a program add N times the launch counts its capture
    recorded: #2 once per layer per step, #3 7 per layer plus one per
    vocab tile of the fused tail (the card's 2 tiles of 16000) per step
    on the int4 path, in all and by path; an admission projects its one
    row whole."""
    from generativeaiexamples_tpu_torch.engine import graphs
    params, cfg, kw = _model(dev, "int4")
    engine = _engine_on(dev, params, cfg, **kw)
    B = engine.cfg.max_slots
    program = engine._round_graphs[(4, True, B)]
    assert engine._sampler_tile == 16000
    per_step = 7 * cfg.num_layers + cfg.vocab_size // engine._sampler_tile
    assert engine._round_graphs[(4, True, 1)].launches == program.launches
    assert program.launches == {
        "paged_attention_decode_int8": 4 * cfg.num_layers,
        "int4_matmul": 4 * per_step, "int4_matmul/tc": 4 * per_step}
    admit = engine._admit_graphs[(128, True)]
    wg = 7 * cfg.num_layers
    assert admit.launches == {"int4_matmul": wg + 1, "int4_matmul/wg": wg,
                              "int4_matmul/tc": 1}
    before = graphs.launch_counts()
    for _ in range(3):
        engine._decode_round(4, True, B)
    torch.cuda.synchronize()
    after = graphs.launch_counts()
    assert graphs.count_delta(before, after) == {
        k: 3 * n for k, n in program.launches.items()}


@pytest.mark.cuda
def test_two_admissions_in_one_step_keep_their_first_tokens(dev):
    """Two admissions of one bucket replay one program twice in one serve
    loop iteration; each request still gets its own first token (the
    eager engine's)."""
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    params, cfg, kw = _model(dev, "f32")
    prompts = [_PROMPTS[3], _PROMPTS[3][:30]]
    sps = [SamplingParams(max_tokens=1, top_k=1, ignore_eos=True)] * 2
    firsts = {}
    for graphs_on in (True, False):
        engine = _engine_on(dev, params, cfg, cuda_graphs=graphs_on, **kw)
        streams = [engine.submit(p, sp) for p, sp in zip(prompts, sps)]
        engine._step()
        assert engine.stats["prefills"] == 2
        firsts[graphs_on] = [s.token_ids for s in streams]
    assert firsts[True] == firsts[False]
    assert firsts[True][0] != firsts[True][1]


# Chunked admission on the card: buckets capped at 128 and a 256-token
# budget, so a 450-token prompt goes in 128-token chunks beside a decoding
# slot (extensions "replace", "accum", an unseeded final); then its repeat
# (3 cached pages: a seeded final) and a 428-token prompt sharing its
# first page (a "seed" extension, then "accum" and an unseeded final).
_CHUNK_KW = dict(max_prefill_bucket=128, sched_round_budget_tokens=256)
_LONG = [1] + [3 + (5 * i) % 256 for i in range(449)]
_CHUNK_PHASES = [[_PROMPTS[3], _LONG],
                 [_LONG, _LONG[:128] + [3 + (9 * i) % 256
                                        for i in range(300)]]]


def _drive_phases(engine, phases, n_new=12):
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    sp = SamplingParams(max_tokens=n_new, top_k=1, ignore_eos=True)
    out = []
    for prompts in phases:
        out.append([s.token_ids for s in _drive(engine, prompts,
                                                [sp] * len(prompts))])
        engine._step()                   # release the finished slots
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int4"])
def test_graph_chunks_match_eager_chunks(dev, mode):
    """The captured chunk programs (extension in every mode, final chunks
    seeded or not) give the eager bodies' greedy tokens and leave the same
    pool bytes (every page but the trash page 0) and slot state: float32,
    bf16 and int4-AWQ + int8 KV at the 2-layer 7B width."""
    params, cfg, kw = _model(dev, mode)
    got = {}
    for graphs_on in (True, False):
        engine = _engine_on(dev, params, cfg, cuda_graphs=graphs_on,
                            **{**kw, **_CHUNK_KW})
        assert bool(engine._final_graphs) == graphs_on
        tokens = _drive_phases(engine, _CHUNK_PHASES)
        st = engine.stats
        assert st["prefill_chunks"] == 8 and st["prefix_cache_hits"] == 2
        assert st["sched_interleaved_rounds"] > 0
        got[graphs_on] = (tokens, engine._state, st)
        del engine
    (tg, sg, stg), (te, se, ste) = got[True], got[False]
    assert tg == te
    for key in ("prefill_chunks", "prefix_cache_hit_tokens", "decode_steps"):
        assert stg[key] == ste[key], key
    for name in sg["cache"]:
        assert torch.equal(_bits(sg["cache"][name][:, 1:]),
                           _bits(se["cache"][name][:, 1:])), name
    for name in ("table", "pos", "last_token", "active", "remaining",
                 "seen", "recent"):
        assert torch.equal(sg[name], se[name]), name


@pytest.mark.cuda
def test_warm_hit_equals_cold_run_float32(dev):
    """float32 at the 2-layer 7B width: the prompts served warm (a repeat
    and a shared prefix, through captured chunk programs) give the greedy
    tokens of a cold engine that admits them in one piece."""
    params, cfg, kw = _model(dev, "f32")
    warm = _drive_phases(_engine_on(dev, params, cfg,
                                    **{**kw, **_CHUNK_KW}), _CHUNK_PHASES)
    cold = _engine_on(dev, params, cfg, prefix_cache=False, **kw)
    assert _drive_phases(cold, _CHUNK_PHASES[1:]) == warm[1:]
    assert cold.stats["prefill_chunks"] == 0
    assert warm[0][1] == warm[1][0]


@pytest.mark.cuda
def test_chunk_programs_carry_their_launch_counts(dev):
    """int4-AWQ at the 2-layer 7B width: a chunk extension runs every
    projection on #3's ``wg`` path; a final chunk adds the lm_head row on
    ``tc``; no chunk launches the decode attention kernels."""
    params, cfg, kw = _model(dev, "int4")
    engine = _engine_on(dev, params, cfg, **{**kw, **_CHUNK_KW})
    wg = 7 * cfg.num_layers
    for key, program in engine._extend_graphs.items():
        assert program.launches == {"int4_matmul": wg,
                                    "int4_matmul/wg": wg}, key
    for key, program in engine._final_graphs.items():
        assert program.launches == {"int4_matmul": wg + 1,
                                    "int4_matmul/wg": wg,
                                    "int4_matmul/tc": 1}, key
    assert len(engine._extend_graphs) == 3 and len(engine._final_graphs) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("quantization,kv_quant", [("", ""),
                                                   ("int4_awq", "int8")],
                         ids=["bf16", "int4_awq-int8kv"])
def test_default_config_7b_captures_and_serves_3000_tokens(
        dev, quantization, kv_quant):
    """llama-2-7b with the default engine config (pool sized "auto",
    prefill buckets up to 3072) captures every program at construction,
    within the reserve the pool sizing kept, and serves a 3000-token
    prompt."""
    from generativeaiexamples_tpu_torch.engine import (EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.serving.model_server import \
        build_services
    torch.cuda.empty_cache()
    engine, _ = build_services("llama-2-7b-chat", device=dev,
                               engine_cfg=EngineConfig(kv_quant=kv_quant),
                               quantization=quantization)
    assert set(engine._admit_graphs) == {
        (b, g) for b in (128, 512, 1024, 2048, 3072) for g in (True, False)}
    assert set(engine._round_graphs) == {
        (s, g, ba) for s in (8, 4, 2, 1) for g in (True, False)
        for ba in (1, 8)}
    assert 0 < engine.graph_pool_bytes <= engine._pool_reserve
    print(f"graph pool {engine.graph_pool_bytes} bytes, reserve "
          f"{engine._pool_reserve}, reserved "
          f"{torch.cuda.memory_reserved(dev)}, pool pages "
          f"{engine.stats['pool_pages']}")
    prompt = [1] + [3 + (11 * i) % 256 for i in range(2999)]
    stream = _drive(engine, [prompt], [SamplingParams(
        max_tokens=16, top_k=1, ignore_eos=True)])[0]
    assert len(stream.token_ids) == 16 and stream.finish_reason == "length"
    assert all(0 <= t < engine.model_cfg.vocab_size
               for t in stream.token_ids)


@pytest.mark.cuda
def test_sample_keeps_the_lowest_ids_at_ties_on_the_card(dev):
    """Four equal top logits with top_k = 2 on the card, where an unstable
    sort may order ties any way: only ids 0 and 1 are ever drawn."""
    from generativeaiexamples_tpu_torch.ops.sampling import sample
    N = 4096
    logits = torch.full((N, 32000), -3.0, device=dev)
    logits[:, :4] = 2.0
    toks = sample(logits, torch.ones(N, device=dev),
                  torch.full((N,), 2, dtype=torch.int32, device=dev),
                  torch.zeros(N, device=dev),
                  torch.Generator(dev).manual_seed(0))
    assert set(toks.tolist()) == {0, 1}


# Head-tile products: (M, K, V, tile, group, x dtype) over every path.
HEAD_TILE_CASES = [(8, 4096, 32000, 4000, 128, torch.bfloat16),    # tc
                   (1, 4096, 32000, 4000, 0, torch.bfloat16),      # tc
                   (4, 1024, 32000, 8000, 128, torch.float32),     # gemv
                   (16, 1024, 32000, 4000, 128, torch.bfloat16),   # wg
                   (16, 256, 2000, 500, 0, torch.float32)]         # tile


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,V,tile,group,x_dtype", HEAD_TILE_CASES)
def test_int4_reads_a_column_slice_in_place(dev, M, K, V, tile, group,
                                            x_dtype):
    """A vocab tile of an int4 head (q4[:, t0:t0 + tile] and its scales)
    goes to the kernel at its row stride, uncopied, and equals the plain
    version on a contiguous copy; a stride the path cannot take raises."""
    from generativeaiexamples_tpu_torch.ops import int4_matmul as ti4
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(M + K + tile)
    w = (torch.randn(K, V, generator=g) * K ** -0.5).to(dev)
    leaf = (quant.quantize_tensor_grouped(w, group) if group
            else quant.quantize_tensor(w, 4))
    scale = leaf["gscale"] if group else leaf["scale"]
    x = torch.randn(M, K, generator=g).to(x_dtype).to(dev)
    path = ti4._path(M, K, tile, group or K, x_dtype)
    for t0 in (0, tile, V - tile):
        q4 = leaf["q4"][:, t0:t0 + tile]
        sc = scale[..., t0:t0 + tile]
        assert not q4.is_contiguous()
        before = ti4.int4_matmul.launches_by_path[path]
        got = ti4.int4_matmul(x, q4, sc, out_dtype=torch.float32)
        assert ti4.int4_matmul.launches_by_path[path] == before + 1
        ref = ti4.int4_matmul_plain(x, q4.contiguous(), sc.contiguous(),
                                    out_dtype=torch.float32)
        torch.cuda.synchronize()
        _assert_int4_close(got, ref, torch.float32)
    if path in ("tc", "wg"):
        odd = leaf["q4"][:, 8:8 + tile]           # row stride V, offset 8
        wide = torch.zeros((K // 2, V + 8), dtype=torch.int8, device=dev)
        with pytest.raises(ValueError, match="aligned"):
            ti4.int4_matmul(x, wide[:, :tile], scale[..., :tile])
        assert odd.data_ptr() % 16 == 8
        with pytest.raises(ValueError, match="boundary"):
            ti4.int4_matmul(x, odd, scale[..., 8:8 + tile])


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["bf16", "int4"])
def test_fused_tail_matches_its_oracle_on_the_card(dev, head):
    """The fused sampler over bf16 and int4 head tiles on the card gives
    the oracle's tokens on one shared noise field (8 rows of mixed
    sampling settings at llama-2-7b's head width)."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    from generativeaiexamples_tpu_torch.ops import fused_sampler as tfs
    from generativeaiexamples_tpu_torch.ops.sampling import (
        apply_repetition_penalty, pack_mask)
    D, V, B, tile = 4096, 32000, 8, 4000
    g = torch.Generator(dev).manual_seed(3)
    w = torch.randn((D, V), generator=g, device=dev).mul_(D ** -0.5)
    params = {"lm_head": w.to(torch.bfloat16) if head == "bf16"
              else quant.quantize_tensor_grouped(w, 128)}
    hn = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    knobs = dict(temp=torch.tensor([0.0, 0.7, 1.0, 1.3, 0.9, 1.0, 0.6, 2.0],
                                   device=dev),
                 top_k=torch.tensor([1, 0, 40, 0, 5, 0, 0, 3],
                                    dtype=torch.int32, device=dev),
                 top_p=torch.tensor([0.0, 0.9, 0.0, 0.95, 0.0, 0.0, 0.5,
                                     0.0], device=dev))
    rep_pen = torch.tensor([1.0, 1.2, 1.0, 1.1, 1.3, 1.0, 1.0, 1.2],
                           device=dev)
    seen = torch.rand((B, V), generator=g, device=dev) < 0.01
    banned = torch.rand((B, V), generator=g, device=dev) < 0.001
    field = tfs.tiled_gumbel(torch.Generator(dev).manual_seed(4), B, V,
                             tile, dev)
    got = tfs.fused_unembed_sample(
        lambda t0, n: llama.lm_head_tile(params, LLAMA2_7B, hn, t0, n), V,
        noise=lambda t: field[:, t * tile:(t + 1) * tile], rep_pen=rep_pen,
        seen_words=pack_mask(seen), banned_words=pack_mask(banned),
        tile=tile, cand_k=V, **knobs)
    # The oracle takes the same tile products (a whole-head product may
    # sum in another order: ulps that a near tie would show).
    logits = torch.cat([llama.lm_head_tile(params, LLAMA2_7B, hn, t0, tile)
                        for t0 in range(0, V, tile)], dim=1)
    pen = apply_repetition_penalty(logits, seen, rep_pen).masked_fill(
        banned, -1e30)
    want = tfs.sample_reference_tiled(pen, field, knobs["temp"],
                                      knobs["top_k"], knobs["top_p"], tile)
    assert torch.equal(got, want), (got, want)


@pytest.mark.cuda
def test_fused_sampled_rounds_replay_like_eager(dev):
    """Sampled requests through the fused tail: an eager engine and a
    graph engine give the same draws for one seed (a replay advances the
    registered generator once per tile draw, as the eager draws do), and
    consecutive rounds of one request draw fresh noise."""
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import GOLDEN_TINY
    params = llama.init_params(GOLDEN_TINY, seed=0, dtype=torch.float32,
                               device=dev)
    kw = dict(max_slots=2, max_input_length=64, max_output_length=40,
              prefill_buckets=(16, 64), page_size=16, dtype="float32",
              kv_pool_tokens=None, sched_round_budget_tokens=256)
    sps = [SamplingParams(max_tokens=33, temperature=1e4, top_k=0,
                          top_p=1.0, ignore_eos=True, random_seed=5),
           SamplingParams(max_tokens=33, temperature=0.8, top_k=50,
                          top_p=0.9, ignore_eos=True, random_seed=6)]
    runs = {}
    for graphs_on in (True, False):
        engine = _engine_on(dev, params, GOLDEN_TINY, cuda_graphs=graphs_on,
                            **kw)
        runs[graphs_on] = [s.token_ids for s in _drive(
            engine, [_PROMPTS[3][:20], _PROMPTS[4][:30]], sps)]
        assert engine.stats["sampler_rows_sampled"] > 0
    assert runs[True] == runs[False]
    a = runs[True][0]
    rounds = [tuple(a[1 + 8 * r:9 + 8 * r]) for r in range(4)]
    assert len(set(rounds)) == 4, rounds


@pytest.mark.cuda
def test_prewarm_shrinks_the_pool_on_a_real_out_of_memory(dev):
    """With less free card memory than prewarm's 256 MiB headroom,
    prewarm runs out of memory for real, shrinks the pool by the
    reference's rule and rebuilds at that size: the old pool's memory is
    released (the allocated bytes drop by the pages given up, so the
    rebuild does not run out on memory that is unreachable but still
    held), and the engine serves."""
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
    # 16 KiB of bf16 KV per token: a 1 GiB pool over 16 slots.
    cfg = LlamaConfig(vocab_size=32000, hidden_size=1024,
                      intermediate_size=2816, num_layers=4, num_heads=16,
                      num_kv_heads=16, head_dim=64,
                      max_position_embeddings=4096)
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    engine = _engine_on(dev, params, cfg, max_slots=16,
                        max_input_length=1024, max_output_length=3072,
                        prefill_buckets=(64, 256), max_prefill_bucket=256,
                        page_size=128, kv_pool_tokens=None)
    pages0 = engine.stats["pool_pages"]
    page_bytes = 128 * engine._kv_bytes_per_token()
    assert pages0 * page_bytes == 1 << 30
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    # Fill the card by what it really hands out (blocks of falling size
    # until each runs out), then free 160 MiB of it: less than the 256
    # MiB headroom, more than it once a fifth of the pool is given up.
    filler = []
    for size in (1 << 30, 64 << 20, 4 << 20):
        while True:
            try:
                filler.append(torch.empty((size,), dtype=torch.uint8,
                                          device=dev))
            except torch.cuda.OutOfMemoryError:
                break
    freed = 0
    while freed < 160 << 20:
        freed += filler.pop().numel()
    try:
        before = torch.cuda.memory_allocated(dev)
        engine.prewarm()
        after = torch.cuda.memory_allocated(dev)
        pages = engine.stats["pool_pages"]
        assert pages in (int(pages0 * 0.8), int(int(pages0 * 0.8) * 0.8)), (
            pages0, pages, torch.cuda.mem_get_info(dev))
        assert before - after >= 0.9 * (pages0 - pages) * page_bytes, (
            before, after)
        streams = _drive(engine, [_PROMPTS[3]],
                         [SamplingParams(max_tokens=8, top_k=1,
                                         ignore_eos=True)])
        assert len(streams[0].token_ids) == 8
        assert engine._fatal is None and engine.stats["requests"] == 1
    finally:
        del filler
        engine.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_exact_cuda_search_on_the_card_matches_its_cpu_path(dev, metric):
    """The store's device backend on the card gives its CPU path's ids,
    duplicate rows ordered lowest id first, and -1 past the live rows.
    Scores: float32 sums of the same bf16 products in another order,
    atol 1e-5 on unit-scale scores and rtol 1e-6 on the l2 scores of the
    raw queries (|score| ~ 1e3)."""
    from generativeaiexamples_tpu_torch.retrieval.cuda_search import \
        _CudaBackend
    rng = np.random.default_rng(4)
    base = rng.standard_normal((300, 1024)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    base[5:10] = base[3]
    live = np.ones(300, np.uint8)
    live[[6, 100]] = 0
    q = np.concatenate([base[[3, 40]], rng.standard_normal(
        (3, 1024)).astype(np.float32)])
    card = _CudaBackend(base, live, metric, device=dev)
    cpu = _CudaBackend(base, live, metric, device="cpu")
    for k in (1, 5, 12):
        idx, sc = card.search(q, k)
        jdx, jsc = cpu.search(q, k)
        np.testing.assert_array_equal(idx, jdx)
        np.testing.assert_allclose(sc, jsc, atol=1e-5, rtol=1e-6)
    assert list(card.search(base[3:4], 5)[0][0]) == [3, 5, 7, 8, 9]
    small = _CudaBackend(base[:3], None, metric, device=dev)
    assert list(small.search(base[:1], 5)[0][0][3:]) == [-1, -1]


@pytest.mark.cuda
def test_embedding_service_on_the_card_matches_the_cpu(dev):
    """encoder-tiny's service on its own stream on the card gives the CPU
    service's vectors on the same weights (float32, TF32 off: 1e-5)."""
    from generativeaiexamples_tpu_torch.embed.encoder import EmbeddingService
    from generativeaiexamples_tpu_torch.models import encoder as enc
    from generativeaiexamples_tpu_torch.models.configs import ENCODER_TINY
    from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
    torch.backends.cuda.matmul.allow_tf32 = False
    params = enc.init_params(ENCODER_TINY, seed=1, device="cpu")
    cpu = EmbeddingService(params, ENCODER_TINY, ByteTokenizer())
    card = EmbeddingService(
        {g: {k: v.to(dev) for k, v in t.items()} for g, t in params.items()},
        ENCODER_TINY, ByteTokenizer())
    texts = [f"passage {i}: " + "word " * i for i in range(40)]
    np.testing.assert_allclose(card.embed_documents(texts),
                               cpu.embed_documents(texts), atol=1e-5, rtol=0)
    np.testing.assert_allclose(card.embed_query("q"), cpu.embed_query("q"),
                               atol=1e-5, rtol=0)


def _fused_setup(dev, engine, n, seed=0):
    """Fused RAG on ``engine``: encoder-tiny (float32, seed 1) on the card,
    a 128-token bucket of byte-tokenizer template parts, and a seeded
    corpus of ``n`` rows; returns the spec."""
    from generativeaiexamples_tpu_torch.engine.rag_fusion import FusedRagSpec
    from generativeaiexamples_tpu_torch.models import encoder as enc
    from generativeaiexamples_tpu_torch.models.configs import ENCODER_TINY
    params = enc.init_params(ENCODER_TINY, seed=1, device=dev)
    spec = FusedRagSpec(prefix_ids=(1, 10, 11), sep_ids=(12,),
                        mid_ids=(13, 14), suffix_ids=(15,), top_k=3,
                        ctx_budget=80, bucket=128, chunk_tokens=32,
                        q_bucket=16, enc_bucket=32)
    engine.enable_fused_rag(params, ENCODER_TINY, spec)
    _fused_corpus(engine, spec, n, seed)
    return spec


def _fused_corpus(engine, spec, n, seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, 64)).astype(np.float32)
    toks = rng.integers(3, 250, size=(n, spec.chunk_tokens)).astype(np.int32)
    lens = rng.integers(1, spec.chunk_tokens + 1, size=(n,)).astype(np.int32)
    engine.set_rag_corpus(emb, toks, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int4"])
def test_fused_admission_captured_matches_eager(dev, mode):
    """The fused admission's captured programs give the eager engine's
    greedy tokens, retrieved rows and assembled lengths, beside a plain
    request, before and after the corpus outgrows its capacity (8 rows,
    then 20: new buffers, captured again), at the 2-layer 7B width."""
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    params, cfg, kw = _model(dev, mode)
    sp = SamplingParams(max_tokens=12, top_k=1, ignore_eos=True)
    got = {}
    for graphs_on in (True, False):
        engine = _engine_on(dev, params, cfg, cuda_graphs=graphs_on, **kw)
        spec = _fused_setup(dev, engine, 5)
        assert len(engine._rag_graphs) == (2 if graphs_on else 0)
        runs = []
        for n in (5, 20):
            if n == 20:
                _fused_corpus(engine, spec, n, 0)
                assert engine._fused_rag.capacity == 32
                assert len(engine._rag_graphs) == (2 if graphs_on else 0)
            fused = engine.submit_rag([40, 41, 42], [7, 8, 9, 10], sp)
            plain = engine.submit(_PROMPTS[3], sp)
            for _ in range(200):
                if fused.finish_reason and plain.finish_reason:
                    break
                engine._step()
            runs.append((fused.token_ids, fused.source_ids, fused.rag_length,
                         plain.token_ids))
        got[graphs_on] = runs
        assert engine.stats["rag_admissions"] == 2
        del engine
    assert got[True] == got[False]
    assert all(len(r[0]) == 12 and len(r[1]) == 3 for r in got[True])


@pytest.mark.cuda
def test_in_place_corpus_upload_leaves_a_round_in_flight_alone(dev):
    """With the harvest worker running, a corpus upload of the same
    capacity after every step (each lands while the step's round is in
    flight) leaves a decoding request's greedy tokens as they were
    without uploads; the uploads stay in place (same buffers, no new
    capture), and a fused request afterwards reads the last corpus (its
    rows equal an eager engine's over that corpus)."""
    import time

    from generativeaiexamples_tpu_torch.engine import SamplingParams
    params, cfg, kw = _model(dev, "bf16")
    sp = SamplingParams(max_tokens=40, top_k=1, ignore_eos=True)
    engine = _engine_on(dev, params, cfg, **kw)
    spec = _fused_setup(dev, engine, 600)
    programs = dict(engine._rag_graphs)
    ptr = engine._fused_rag.corpus["emb"].data_ptr()

    def serve(upload):
        engine.clear_prefix_cache()
        engine._start_harvest(2)
        k = 0
        try:
            stream = engine.submit(_PROMPTS[4], sp)
            deadline = time.monotonic() + 120
            while stream.finish_reason is None:
                assert time.monotonic() < deadline, "no finish in 120 s"
                engine._wake.clear()
                if not engine._step():
                    engine._wake.wait(0.05)
                if upload:
                    k += 1
                    _fused_corpus(engine, spec, 600, k)
            return stream.token_ids, k
        finally:
            # Retires the finished request too, so the next run's
            # clear_prefix_cache evicts its pages and it admits cold.
            engine.stop()

    quiet, _ = serve(False)
    busy, last = serve(True)
    assert busy == quiet and len(busy) == 40 and last > 1
    assert engine._fused_rag.corpus["emb"].data_ptr() == ptr
    assert engine._rag_graphs == programs
    rows = {}
    eager = _engine_on(dev, params, cfg, cuda_graphs=False, **kw)
    _fused_corpus(eager, _fused_setup(dev, eager, 600), 600, last)
    for name, e in (("graph", engine), ("eager", eager)):
        fused = e.submit_rag([40, 41], [7, 8, 9], sp)
        for _ in range(200):
            if fused.finish_reason:
                break
            e._step()
        rows[name] = fused.source_ids
    assert rows["graph"] == rows["eager"] and len(rows["graph"]) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int4"])
def test_verify_rounds_captured_match_eager(dev, mode):
    """Speculative decoding's captured verify rounds (per page window,
    greedy flag and rung) give the eager engine's greedy tokens, drafts
    and accepted counts, and leave the same pool bytes (every page but the
    trash page 0), at the 2-layer 7B width; a sampled request keeps its
    length."""
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    params, cfg, kw = _model(dev, mode)
    copy = [1] + [40, 41, 42, 43, 44, 45] * 20
    sp = SamplingParams(max_tokens=20, top_k=1, ignore_eos=True)
    sampled = SamplingParams(max_tokens=17, temperature=0.8, top_k=40,
                             ignore_eos=True, random_seed=4)
    got = {}
    for graphs_on in (True, False):
        engine = _engine_on(dev, params, cfg, cuda_graphs=graphs_on,
                            spec_decode=True, **kw)
        assert bool(engine._verify_graphs) == graphs_on
        streams = _drive(engine, [copy, _PROMPTS[3], copy[:60]],
                         [sp, sp, sampled])
        stats = engine.stats
        assert stats["spec_verify_rounds"] > 0
        assert len(streams[2].token_ids) == 17
        pool = {k: v[:, 1:].clone() for k, v in
                engine._state["cache"].items()}
        got[graphs_on] = ([s.token_ids for s in streams[:2]],
                          stats["spec_draft_tokens"],
                          stats["spec_accepted_tokens"], pool)
        del engine
    a, b = got[True], got[False]
    assert a[:3] == b[:3]
    for name in a[3]:
        assert torch.equal(a[3][name], b[3][name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int4"])
def test_tier_pages_round_trip_through_pinned_memory(dev, mode):
    """On the card an evicted prefix goes out through pinned memory on a
    side stream and comes back bit for bit: the restored pages equal the
    offloaded ones and the warm turn gives the prefix hit's tokens; the
    page copies are timed by CUDA events (positive D2H and H2D ms)."""
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    from generativeaiexamples_tpu_torch.engine.prefix_cache import \
        hash_blocks
    params, cfg, kw = _model(dev, mode)
    kw = dict(kw, max_slots=2, kv_pool_tokens=5 * 128,
              kv_host_pool_tokens=8192)
    engine = _engine_on(dev, params, cfg, **kw)
    sp = SamplingParams(max_tokens=8, top_k=1, ignore_eos=True)
    target = [1] + [3 + (5 * i) % 250 for i in range(300)]
    hashes = hash_blocks(target, engine.cfg.page_size)

    def pages():
        cache = engine._state["cache"]
        return {h: {k: v[:, engine._prefix_cache.page_of(h)].clone()
                    for k, v in cache.items()}
                for h in hashes if engine._prefix_cache.page_of(h)}
    _drive(engine, [target], [sp])
    hit = _drive(engine, [target], [sp])[0].token_ids
    engine._step()
    before = pages()
    assert len(before) == len(hashes) == 2
    for j in range(3):
        _drive(engine, [[1] + [7 + (11 * i + j) % 240 for i in range(300)]],
               [sp])
    assert not pages() and engine.stats["kv_tier_offload_pages"] >= 2
    warm = _drive(engine, [target], [sp])[0].token_ids
    assert engine.stats["kv_tier_restore_pages"] == 2
    assert warm == hit
    for h, leaves in pages().items():
        for name, t in leaves.items():
            assert torch.equal(t, before[h][name]), name
    d2h, h2d = engine.measure_page_io(4)
    assert d2h > 0 and h2d > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int4"])
def test_handoff_push_restores_bit_equal_pages_on_a_second_engine(dev, mode):
    """The disaggregated handoff between two engines on the card: the
    source engine's ``export_handoff`` blob goes over ``push_blob`` to the
    decode engine's chain server (``/control/kv_resume``), and the decode
    engine's admission restores it: its pool pages equal the source
    engine's bit for bit (int8 pages and their scales under int4), and
    its greedy tokens equal the source engine's own prefix hit."""
    import asyncio
    import threading
    from types import SimpleNamespace

    from aiohttp import web

    from generativeaiexamples_tpu_torch.chains.server import create_app
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    from generativeaiexamples_tpu_torch.engine import kv_tier
    from generativeaiexamples_tpu_torch.engine.prefix_cache import \
        hash_blocks
    params, cfg, kw = _model(dev, mode)
    kw = dict(kw, max_slots=2, kv_pool_tokens=8 * 128,
              kv_host_pool_tokens=8192)
    # The source is unified so it can also serve its own prefix hit, the
    # tokens the decode engine must give.
    src = _engine_on(dev, params, cfg, **kw)
    dst = _engine_on(dev, params, cfg, role="decode", **kw)
    target = [1] + [3 + (13 * i) % 250 for i in range(400)]
    hashes = hash_blocks(target, src.cfg.page_size)
    _drive(src, [target], [SamplingParams(max_tokens=1, top_k=1)])
    src._step()
    out = src.export_handoff(target)
    assert out is not None and out[1] == len(hashes) == 3
    blob = out[0]
    loop, box, started = asyncio.new_event_loop(), {}, threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def boot():
            box["runner"] = web.AppRunner(create_app(SimpleNamespace(
                llm=SimpleNamespace(engine=dst))))
            await box["runner"].setup()
            site = web.TCPSite(box["runner"], "127.0.0.1", 0)
            await site.start()
            box["port"] = box["runner"].addresses[0][1]
        loop.run_until_complete(boot())
        started.set()
        loop.run_forever()
        loop.run_until_complete(box["runner"].cleanup())

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(60)
    try:
        assert kv_tier.push_blob(f"http://127.0.0.1:{box['port']}", blob,
                                 timeout_s=60)
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
    assert dst.stats["kv_tier_resumed_blocks"] == 3
    sp = SamplingParams(max_tokens=8, top_k=1, ignore_eos=True)
    want = _drive(src, [target], [sp])[0].token_ids      # src's own hit
    got = _drive(dst, [target], [sp])[0].token_ids
    assert dst.stats["kv_tier_restore_pages"] == 3       # 400 > 3 pages
    assert got == want
    for h in hashes:
        a, b = src._prefix_cache.page_of(h), dst._prefix_cache.page_of(h)
        assert a is not None and b is not None
        for name, pool in src._state["cache"].items():
            assert torch.equal(pool[:, a], dst._state["cache"][name][:, b])


# ------------------------------------------------------ GPT-Next, close()

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int4"])
def test_nemotron_two_layers_captured_matches_eager(dev, mode):
    """Nemotron-8B's full width cut to 2 layers (layernorm1p, squared-ReLU
    MLP, V = 256000), random weights from seed 0: the captured engine's
    greedy tokens equal the eager engine's (bf16, and int4-AWQ + int8
    KV); under int4 every decode step launches #3 "tc" 6 times a layer
    plus once per head tile, and #2 once a layer."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.engine import SamplingParams, graphs
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import NEMOTRON_8B
    cfg = replace(NEMOTRON_8B, num_layers=2)
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16,
                               device=dev)
    if mode == "int4":
        params = quant.quantize_params(params, "int4_awq", group_size=128)
    kw = dict(_GRAPH_KW, dtype="bfloat16",
              kv_quant="int8" if mode == "int4" else "")
    sps = [SamplingParams(max_tokens=12, top_k=1, ignore_eos=True)] * 3
    got = {}
    for graphs_on in (True, False):
        engine = _engine_on(dev, params, cfg, cuda_graphs=graphs_on, **kw)
        graphs.set_launch_counts(dict.fromkeys(graphs.launch_counts(), 0))
        streams = _drive(engine, _PROMPTS[:3], sps)
        counts = graphs.launch_counts()
        steps, prefills = (engine.stats["decode_steps"],
                           engine.stats["prefills"])
        tiles = cfg.vocab_size // engine._sampler_tile
        got[graphs_on] = [s.token_ids for s in streams]
        engine.close()
        if mode == "int4":
            assert counts["int4_matmul/tc"] == (6 * 2 + tiles) * steps \
                + prefills
            assert counts["paged_attention_decode_int8"] == 2 * steps
        else:
            assert counts["paged_attention_decode"] == 2 * steps
    assert got[True] == got[False]


@pytest.mark.cuda
def test_close_returns_the_engines_memory(dev, monkeypatch):
    """``Engine.close`` hands back everything the engine allocated (pool,
    state, captured programs and their graph pool) and its hold on the
    parameters: with the weights dropped, ``memory_allocated`` is back at
    its baseline. cuBLAS keeps a workspace per stream for the process's
    life (the captured programs point into it), so both engines here
    capture on one stream and the baseline is taken after the first."""
    import gc
    from generativeaiexamples_tpu_torch.engine import SamplingParams
    stream = torch.cuda.Stream(dev)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: stream)

    def life() -> int:
        params, cfg, kw = _model(dev, "bf16", num_layers=1)
        engine = _engine_on(dev, params, cfg, **kw)
        del params
        _drive(engine, _PROMPTS[:2], [SamplingParams(
            max_tokens=4, top_k=1, ignore_eos=True)] * 2)
        peak = torch.cuda.memory_allocated(dev)
        engine.close()
        assert engine.params is None
        engine.close()                               # a second close: no-op
        gc.collect()
        return peak

    life()
    base = torch.cuda.memory_allocated(dev)
    assert life() > base + (768 << 20)           # 0.92 GB of weights
    assert torch.cuda.memory_allocated(dev) == base


def _front_end_call(url, body=None, data=None, headers=None):
    """The body of a GET, a JSON POST or a raw POST, decoded."""
    import json
    import urllib.request
    if body is not None:
        data = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
    req = urllib.request.Request(url, data=data, headers=headers or {})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.read().decode()


def _kernels_in(fn, mode):
    """Run ``fn`` with the launch counts set to 0 before it; assert that
    the mode's kernels launched inside it."""
    from generativeaiexamples_tpu_torch.engine import graphs
    graphs.set_launch_counts(dict.fromkeys(graphs.launch_counts(), 0))
    out = fn()
    torch.cuda.synchronize()
    counts = graphs.launch_counts()
    if mode == "bf16":
        assert counts["paged_attention_decode"] > 0, counts
    else:
        assert counts["paged_attention_decode_int8"] > 0, counts
        assert counts["int4_matmul/tc"] > 0, counts
        assert counts["int4_matmul/wg"] > 0, counts
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int4"])
def test_front_ends_on_the_card_give_the_completions_text(dev, mode,
                                                          tmp_path,
                                                          monkeypatch):
    """The model server's Triton generate and stream and its job routes
    (a 202 then a poll), and the web frontend's /api/generate in front of
    a chain server, over a 1-layer 7B-width graph engine on the card with
    golden-tiny's 32,000-piece vocabulary: each greedy text is the one
    /v1/completions (or the chain server's /generate) gives, and the
    mode's kernels launch inside each request's window."""
    import asyncio
    import contextlib
    import json
    import os
    import threading
    import zipfile

    from aiohttp import web

    from generativeaiexamples_tpu_torch.chains.examples.developer_rag import \
        QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.chains.server import create_app
    from generativeaiexamples_tpu_torch.embed.encoder import HashEmbedder
    from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
    from generativeaiexamples_tpu_torch.frontend.chat_client import (
        ChatClient, multipart_body)
    from generativeaiexamples_tpu_torch.frontend.server import \
        create_app as frontend_app
    from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.serving import jobs_api
    from generativeaiexamples_tpu_torch.serving.client import (
        JobsClient, TritonShimClient)
    from generativeaiexamples_tpu_torch.serving.model_server import \
        create_server_app
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import from_dict

    @contextlib.contextmanager
    def serve(app):
        loop = asyncio.new_event_loop()
        box, started = {}, threading.Event()

        def run():
            asyncio.set_event_loop(loop)

            async def boot():
                box["runner"] = web.AppRunner(app)
                await box["runner"].setup()
                site = web.TCPSite(box["runner"], "127.0.0.1", 0)
                await site.start()
                box["port"] = box["runner"].addresses[0][1]
            loop.run_until_complete(boot())
            started.set()
            loop.run_forever()
            loop.run_until_complete(box["runner"].cleanup())

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert started.wait(120)
        try:
            yield f"http://127.0.0.1:{box['port']}"
        finally:
            loop.call_soon_threadsafe(loop.stop)
            t.join(120)

    monkeypatch.setenv("GAIE_RUN_DIR", str(tmp_path))
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "fixtures", "golden_tiny")
    params, cfg, kw = _model(dev, mode, num_layers=1)
    engine = Engine(params, cfg, get_tokenizer(golden),
                    EngineConfig(**{**kw, "max_output_length": 32}),
                    device=dev)
    prompt, new = "The paged pool of the engine holds", 24
    jobs_now = web.Application()
    jobs_api.add_jobs_routes(jobs_now, engine, "llama", sync_wait=0.0)
    with serve(create_server_app(engine, None, "llama")) as base, \
            serve(jobs_now) as jobs_base:
        want = _kernels_in(lambda: json.loads(_front_end_call(
            base + "/v1/completions", {"prompt": prompt, "max_tokens": new,
                                       "temperature": 0}))["choices"][0]
            ["text"], mode)
        assert len(want) > 3
        triton = TritonShimClient(base, "llama")
        assert _kernels_in(lambda: triton.generate(prompt, new), mode) == want
        assert _kernels_in(lambda: "".join(triton.generate_stream(
            prompt, new)), mode) == want
        jobs = JobsClient(jobs_base, poll_interval=0.02)

        def job():
            snap = jobs.submit(prompt, max_tokens=new, temperature=0)
            assert snap["status"] == "running"
            return jobs.wait(snap["id"])["text"]
        assert _kernels_in(job, mode) == want
    engine.stop()
    cfg_chain = from_dict(AppConfig, {
        "embeddings": {"model_engine": "hash", "dimensions": 64},
        "text_splitter": {"chunk_size": 100, "chunk_overlap": 20},
        "retriever": {"top_k": 2, "max_context_tokens": 200}})
    bot = QAChatbot(llm=EngineLLM(engine), embedder=HashEmbedder(64),
                    config=cfg_chain, fused_rag=False)
    deck = tmp_path / "deck.pptx"
    with zipfile.ZipFile(deck, "w") as z:
        z.writestr("ppt/slides/slide1.xml", '<p:sld xmlns:p="p" xmlns:a='
                   '"http://schemas.openxmlformats.org/drawingml/2006/main">'
                   '<a:t>The paged pool holds the keys and values of every '
                   'slot.</a:t></p:sld>')
    with serve(create_app(bot, str(tmp_path / "up"))) as chain, \
            serve(frontend_app(ChatClient(chain))) as front:
        body, ctype = multipart_body(str(deck))
        assert json.loads(_front_end_call(
            front + "/api/upload", data=body,
            headers={"Content-Type": ctype}))["status"] == "ingested"
        q = {"question": "What does the paged pool hold?",
             "use_knowledge_base": True, "num_tokens": new}
        engine.stop()
        engine.clear_prefix_cache()
        direct = _kernels_in(lambda: _front_end_call(chain + "/generate", q),
                             mode)
        engine.stop()
        engine.clear_prefix_cache()
        proxied = _kernels_in(lambda: _front_end_call(
            front + "/api/generate", q), mode)
        assert proxied == direct and len(direct) > 3
        hits = json.loads(_front_end_call(front + "/api/search", {
            "content": q["question"], "num_docs": 1}))
        assert hits[0]["source"] == "deck.pptx"
    engine.close()


# ------------------------------------------ training: #3 under autograd

def _int4_train_leaf(kind, K, N, dev, seed=0):
    """A (K, N) int4 leaf on ``dev``: per channel, AWQ (groups of 128 and a
    pre-scale) or GPTQ (groups of 128 and zero points)."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((K, N), generator=g) * K ** -0.5
    if kind == "channel":
        leaf = quant.quantize_tensor(w, 4)
    else:
        leaf = quant.quantize_tensor_grouped(w, 128)
    if kind == "awq":
        leaf["pre_scale"] = torch.rand((K,), generator=g) + 0.5
    if kind == "gptq":
        leaf["gbias"] = 0.01 * torch.randn(leaf["gscale"].shape, generator=g)
    return {k: v.to(dev) for k, v in leaf.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["channel", "awq", "gptq"])
@pytest.mark.parametrize("M", [9, 300])
def test_int4_backward_matches_the_dequantized_product(dev, kind, M):
    """bf16 x through ``quant.matmul`` under autograd: the kernel forward
    ("wg") and ``int4_matmul_dx`` (counted) give autograd's dx through a
    dequantized bf16 copy of the weight, within 2e-2 x max|ref| (both
    round the weight and the result to bf16 at different points)."""
    from generativeaiexamples_tpu_torch.ops.int4_matmul import int4_matmul
    K, N = 512, 384
    leaf = _int4_train_leaf(kind, K, N, dev)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((M, K), generator=g).to(torch.bfloat16).to(dev)
    dy = torch.randn((M, N), generator=g).to(torch.bfloat16).to(dev)
    n0 = (int4_matmul.launches_by_path["wg"], int4_matmul.backward_launches)
    x1 = x.clone().requires_grad_(True)
    quant.matmul(x1, leaf).backward(dy)
    assert (int4_matmul.launches_by_path["wg"],
            int4_matmul.backward_launches) == (n0[0] + 1, n0[1] + 1)
    x2 = x.clone().requires_grad_(True)
    (x2 @ quant.dequantize(leaf, torch.bfloat16)).backward(dy)
    torch.cuda.synchronize()
    ref = x2.grad.float()
    assert (x1.grad.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["channel", "awq"])
def test_int4_backward_float32_matches_the_plain_version(dev, kind):
    """float32 x ("tile" forward, a float32 backward product) against
    autograd through the plain version on the card (rtol 1e-4: both sum
    float32 in another order)."""
    from generativeaiexamples_tpu_torch.ops.int4_matmul import (
        int4_matmul_grad, int4_matmul_plain)
    leaf = _int4_train_leaf(kind, 512, 384, dev)
    scale = leaf.get("gscale", leaf.get("scale"))
    g = torch.Generator().manual_seed(2)
    x = torch.randn((40, 512), generator=g).to(dev)
    dy = torch.randn((40, 384), generator=g).to(dev)
    x1 = x.clone().requires_grad_(True)
    int4_matmul_grad(x1, leaf["q4"], scale).backward(dy)
    x2 = x.clone().requires_grad_(True)
    int4_matmul_plain(x2, leaf["q4"], scale).backward(dy)
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-4,
                               atol=1e-4 * x2.grad.abs().max().item())


@pytest.mark.cuda
def test_logits_product_backward_runs_on_the_card(dev):
    """``matmul_f32`` of bf16 x and a raw bf16 head is one
    ``torch.mm(..., out_dtype=float32)`` on the card, which has no
    registered derivative: under autograd it goes through
    ``quant._MatmulF32Fn``, whose backward gives the float32 product's dx
    and dW (rtol 1e-2, bf16 grads)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((64, 256), generator=g).to(torch.bfloat16).to(dev)
    w = (torch.randn((256, 1000), generator=g) / 16).to(torch.bfloat16).to(
        dev)
    dy = torch.randn((64, 1000), generator=g).to(dev)
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = quant.matmul_f32(x, w)
    assert y.dtype == torch.float32
    # y is a view of the Function's (M, N) output.
    assert "_MatmulF32Fn" in type(y.grad_fn.next_functions[0][0]).__name__
    y.backward(dy)
    xf = x.detach().float().requires_grad_(True)
    wf = w.detach().float().requires_grad_(True)
    (xf @ wf).backward(dy)
    for got, ref in ((x.grad, xf.grad), (w.grad, wf.grad)):
        torch.testing.assert_close(got.float(), ref, rtol=1e-2,
                                   atol=1e-2 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qlora_step_on_the_card_matches_the_cpu(dev, dtype):
    """One QLoRA step (rank 8 on wq..wo over an int4_awq base of a
    2-layer 7B-shaped model, merged in the base's dtype) on the card and
    on the CPU from the same parameters and adapters: equal losses and
    first gradients (float32: rtol 1e-4 on the loss and 1e-3 relative
    error of each gradient; bf16: 1e-2 and 5e-2), and on the card every
    int4 product of the step (3 a layer and the head) launched #3 and
    its backward once."""
    from dataclasses import replace

    from generativeaiexamples_tpu_torch.lora import (init_lora,
                                                     lora_parameters,
                                                     make_lora_train_step)
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.models.configs import LLAMA2_7B
    from generativeaiexamples_tpu_torch.ops.int4_matmul import int4_matmul

    cfg = replace(LLAMA2_7B, num_layers=2, hidden_size=256,
                  intermediate_size=512, num_heads=2, num_kv_heads=2,
                  head_dim=128, vocab_size=512)
    base = quant.quantize_params(llama.init_params(cfg, 0, dtype=dtype),
                                 "int4_awq", 128)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(3, cfg.vocab_size, (2, 65), generator=g)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": torch.ones((2, 64), dtype=torch.int32)}

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        return tree.to(d)

    out = {}
    for d in ("cpu", dev):
        b = to(base, d)
        lora = init_lora(cfg, b, torch.Generator().manual_seed(1), rank=8)
        # A non-zero b, so both adapters' gradients are non-zero.
        with torch.no_grad():
            for ab in lora.values():
                ab["b"].copy_(0.01 * torch.randn(
                    ab["b"].shape, generator=torch.Generator().manual_seed(
                        5)).to(ab["b"].device))
        step = make_lora_train_step(
            cfg, torch.optim.Adam(lora_parameters(lora), lr=1e-2),
            dtype=dtype)
        n0 = (int4_matmul.launches, int4_matmul.backward_launches)
        loss = float(step(lora, b, to(batch, d)))
        n1 = (int4_matmul.launches, int4_matmul.backward_launches)
        out[str(d)] = (loss, {k: (ab["a"].grad.float().cpu(),
                                  ab["b"].grad.float().cpu())
                              for k, ab in lora.items()}, n1[0] - n0[0],
                       n1[1] - n0[1])
    (lc, gc, _, _), (lg, gg, launched, backward) = out["cpu"], out[str(dev)]
    assert launched == backward == 3 * cfg.num_layers + 1
    loss_tol, grad_tol = ((1e-4, 1e-3) if dtype == torch.float32
                          else (1e-2, 5e-2))
    assert abs(lg - lc) <= loss_tol * abs(lc)
    for k in gc:
        for a, b in zip(gg[k], gc[k]):
            assert ((a - b).norm() / b.norm()).item() <= grad_tol, k
