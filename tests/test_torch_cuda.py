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
        scale.data_ptr(), out.data_ptr(), None, 0, None, 0, M, K, N, 128,
        torch.cuda.current_stream().cuda_stream)
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
    leaf["gbias"] = torch.zeros_like(leaf["gscale"])
    with pytest.raises(ConfigError, match="gbias"):
        quant.matmul(x, leaf)


# ------------------------------------------------------ engine CUDA graphs

_GRAPH_KW = dict(max_slots=4, max_input_length=512, max_output_length=24,
                 prefill_buckets=(128, 512), kv_pool_tokens=None)


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
    recorded: #2 once per layer per step, #3 225 per step at 7B width on
    the int4 path, in all and by path."""
    from generativeaiexamples_tpu_torch.engine import graphs
    params, cfg, kw = _model(dev, "int4")
    engine = _engine_on(dev, params, cfg, **kw)
    program = engine._round_graphs[(4, True)]
    per_step = 7 * cfg.num_layers + 1
    assert program.launches == {
        "paged_attention_decode_int8": 4 * cfg.num_layers,
        "int4_matmul": 4 * per_step, "int4_matmul/tc": 4 * per_step}
    admit = engine._admit_graphs[(128, True)]
    assert admit.launches == {"int4_matmul": per_step,
                              "int4_matmul/wg": per_step - 1,
                              "int4_matmul/tc": 1}
    before = graphs.launch_counts()
    for _ in range(3):
        engine._decode_round(4, True)
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
        (s, g) for s in (8, 4, 2, 1) for g in (True, False)}
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
