"""The port's paged decode attention (plain version and wrapper) against
the JAX package's oracle and its Pallas kernel, on the CPU.

Tolerances: atol 1e-5 against ``paged_attention_decode_reference`` (both
float32 gather formulations); 2e-2 against the Pallas kernel in interpret
mode, the bound the JAX package's own kernel test uses. Post-append pools
are compared on every row below each slot's length plus the written row:
the Pallas kernel leaves the rest of its 8-row write tile undefined.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain version there at llama-2-7b shapes, and
``tests/test_torch_cuda.py`` at small ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import paged_attention as jpa
from generativeaiexamples_tpu_torch.ops import paged_attention as tpa

L, KV, hd, page = 2, 4, 64, 16
LAYER = 1

CASES = {
    # lengths at k*page - 1, k*page, k*page + 1, with G = H / KV = 2
    "page_edges_g2": (8, [15, 16, 17, 31, 32, 33]),
    # a zero-length (inactive) slot in the middle of the batch
    "inactive_mid_batch": (8, [20, 0, 47]),
    # G = 4 query heads per kv head
    "g4": (16, [1, 48, 9]),
    # G = 1 (MHA)
    "mha_g1": (4, [17, 30, 0, 63]),
}


def _setup(H, lengths, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    W = max(-(-(n + 1) // page) for n in lengths)
    N = 1 + B * W                    # every slot owns distinct pages
    f = np.float32
    q = rng.standard_normal((B, H, hd)).astype(f)
    pk = rng.standard_normal((L, N, KV, page, hd)).astype(f)
    pv = rng.standard_normal((L, N, KV, page, hd)).astype(f)
    ck = rng.standard_normal((B, KV, hd)).astype(f)
    cv = rng.standard_normal((B, KV, hd)).astype(f)
    table = (1 + rng.permutation(B * W)).reshape(B, W).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    live = lens > 0
    # The engine's invariant: a live slot appends at table[len // page];
    # an inactive one (len 0) writes the trash page 0.
    wp = np.where(live, table[np.arange(B), lens // page], 0).astype(np.int32)
    off = np.where(live, lens % page, 0).astype(np.int32)
    return q, pk, pv, table, lens, ck, cv, wp, off


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _run_plain(args):
    q, pk, pv, table, lens, ck, cv, wp, off = args
    tk, tv = _t(pk.copy()), _t(pv.copy())
    out = tpa.paged_attention_decode(_t(q), tk, tv, _t(table), _t(lens),
                                     _t(ck), _t(cv), _t(wp), _t(off), LAYER)
    return out.numpy(), tk.numpy(), tv.numpy()


def _check_pools(new_k, new_v, args, ref_k=None, ref_v=None):
    """Rows below each slot's length keep their bytes; the written row of
    each live slot holds cur_k/cur_v (or matches the reference pools)."""
    q, pk, pv, table, lens, ck, cv, wp, off = args
    for b, n in enumerate(lens):
        for t in range(n):
            p, r = table[b, t // page], t % page
            np.testing.assert_array_equal(new_k[LAYER, p, :, r],
                                          pk[LAYER, p, :, r])
            np.testing.assert_array_equal(new_v[LAYER, p, :, r],
                                          pv[LAYER, p, :, r])
        if n == 0:
            continue  # inactive: its row went to the trash page
        want_k = ck[b] if ref_k is None else ref_k[LAYER, wp[b], :, off[b]]
        want_v = cv[b] if ref_v is None else ref_v[LAYER, wp[b], :, off[b]]
        np.testing.assert_array_equal(new_k[LAYER, wp[b], :, off[b]], want_k)
        np.testing.assert_array_equal(new_v[LAYER, wp[b], :, off[b]], want_v)
    # The other layer is untouched.
    np.testing.assert_array_equal(new_k[1 - LAYER], pk[1 - LAYER])
    np.testing.assert_array_equal(new_v[1 - LAYER], pv[1 - LAYER])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference(case):
    H, lengths = CASES[case]
    args = _setup(H, lengths)
    q, pk, pv, table, lens, ck, cv, wp, off = args
    out, new_k, new_v = _run_plain(args)
    ref = jpa.paged_attention_decode_reference(
        jnp.asarray(q), jnp.asarray(pk[LAYER]), jnp.asarray(pv[LAYER]),
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(ck),
        jnp.asarray(cv))
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)
    _check_pools(new_k, new_v, args)
    # An inactive slot attends over nothing: its output is exactly cur_v.
    G = H // KV
    for b in np.flatnonzero(lens == 0):
        np.testing.assert_allclose(out[b], np.repeat(cv[b], G, axis=0),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["page_edges_g2", "inactive_mid_batch",
                                  "mha_g1"])
def test_plain_matches_pallas_kernel(case):
    H, lengths = CASES[case]
    args = _setup(H, lengths, seed=1)
    q, pk, pv, table, lens, ck, cv, wp, off = args
    out, new_k, new_v = _run_plain(args)
    jout, jk, jv = jpa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(wp),
        jnp.asarray(off), jnp.asarray([LAYER], jnp.int32), interpret=True)
    np.testing.assert_allclose(out, np.asarray(jout), atol=2e-2, rtol=2e-2)
    _check_pools(new_k, new_v, args, np.asarray(jk), np.asarray(jv))


def test_plain_leaves_other_pool_bytes_alone():
    """Apart from the appended rows (and the trash page), the plain
    version changes no pool byte."""
    args = _setup(8, [15, 0, 33, 0])
    q, pk, pv, table, lens, ck, cv, wp, off = args
    _, new_k, _ = _run_plain(args)
    touched = np.zeros(pk.shape[:4], bool)
    touched[LAYER, 0] = True
    for b in np.flatnonzero(lens > 0):
        touched[LAYER, wp[b], :, off[b]] = True
    np.testing.assert_array_equal(new_k[~touched], pk[~touched])


def test_cpu_calls_do_not_count_as_launches():
    before = tpa.paged_attention_decode.launches
    _run_plain(_setup(8, [5, 9]))
    assert tpa.paged_attention_decode.launches == before


def test_wrapper_rejects_bad_arguments():
    q, pk, pv, table, lens, ck, cv, wp, off = _setup(8, [5, 9])
    good = [_t(q), _t(pk), _t(pv), _t(table), _t(lens), _t(ck), _t(cv),
            _t(wp), _t(off), LAYER]
    bad_cases = {
        1: _t(pk[:, :, :, :, :32]),           # head_dim mismatch
        3: _t(table[:1]),                     # table rows != batch
        5: _t(ck[:, :2]),                     # cur_k kv heads wrong
        9: L,                                 # layer out of range
    }
    for i, bad in bad_cases.items():
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            tpa.paged_attention_decode(*args)
    # A device that is neither the CPU nor CUDA is refused, never served
    # by the plain version.
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in good]
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_attention_decode(*meta)


def test_kernel_gate():
    assert tpa.kernel_supported(128, 32, 32, 128)       # llama-2-7b
    assert tpa.kernel_supported(16, 32, 8, 64)          # GQA, small page
    assert not tpa.kernel_supported(128, 32, 3, 128)    # H % KV != 0
    assert not tpa.kernel_supported(128, 64, 4, 128)    # G = 16 > 8
    assert not tpa.kernel_supported(128, 8, 8, 512)     # hd > 256
    assert not tpa.kernel_supported(0, 8, 8, 64)        # empty page


# ---------------------------------------------------------- int8 pools
#
# Pools are made by the JAX package's ``quantize_rows`` from random rows
# and fed to both packages. Tolerances: atol 1e-5 against
# ``paged_attention_decode_reference`` on the dequantized pools (both
# float32 gather formulations over the same dequantized values); against
# the JAX int8 Pallas kernel in interpret mode, atol 1e-5 and rtol 1e-5:
# with float32 q its dots run in float32 too, and it folds the row scales
# after q.k and into p before p.v, which moves the result by a few float32
# ulps, far inside the 2e-2 the JAX package's own int8 kernel test uses.
# Appends are compared bit for bit on the appended row and its scale; the
# Pallas kernel rewrites the write page's whole scale block (a TPU lane
# rule), so dead lanes are not compared with it.


def _setup_quant(H, lengths, seed=0):
    from generativeaiexamples_tpu.ops.kv_quant import quantize_rows
    q, pk, pv, table, lens, ck, cv, wp, off = _setup(H, lengths, seed)
    kq, ks = quantize_rows(jnp.asarray(pk))
    vq, vs = quantize_rows(jnp.asarray(pv))
    pools = [np.array(a) for a in (kq, vq)]
    scales = [np.array(a).view(np.int16) for a in (ks, vs)]
    return q, pools, scales, table, lens, ck, cv, wp, off


def _bf16(a):
    return torch.from_numpy(a.copy()).view(torch.bfloat16)


def _run_quant_plain(args):
    q, (kq, vq), (ks, vs), table, lens, ck, cv, wp, off = args
    tk, tv = _t(kq.copy()), _t(vq.copy())
    tks, tvs = _bf16(ks), _bf16(vs)
    out = tpa.paged_attention_decode(
        _t(q), tk, tv, _t(table), _t(lens), _t(ck), _t(cv), _t(wp), _t(off),
        LAYER, pool_ks=tks, pool_vs=tvs)
    return (out.numpy(), tk.numpy(), tv.numpy(),
            tks.view(torch.int16).numpy(), tvs.view(torch.int16).numpy())


def _check_quant_pools(new, args, want_k, want_ks, want_v, want_vs):
    """Live rows and their scales keep their bytes; the appended row and
    its scale equal the wanted ones; the other layer is untouched."""
    q, (kq, vq), (ks, vs), table, lens, ck, cv, wp, off = args
    nk, nv, nks, nvs = new
    for b, n in enumerate(lens):
        for t in range(n):
            p, r = table[b, t // page], t % page
            for got, before in ((nk, kq), (nv, vq), (nks, ks), (nvs, vs)):
                np.testing.assert_array_equal(got[LAYER, p, :, r],
                                              before[LAYER, p, :, r])
        if n == 0:
            continue
        w, o = wp[b], off[b]
        np.testing.assert_array_equal(nk[LAYER, w, :, o], want_k[b])
        np.testing.assert_array_equal(nks[LAYER, w, :, o], want_ks[b])
        np.testing.assert_array_equal(nv[LAYER, w, :, o], want_v[b])
        np.testing.assert_array_equal(nvs[LAYER, w, :, o], want_vs[b])
    for got, before in ((nk, kq), (nv, vq), (nks, ks), (nvs, vs)):
        np.testing.assert_array_equal(got[1 - LAYER], before[1 - LAYER])


def _jax_rows(cur):
    from generativeaiexamples_tpu.ops.kv_quant import quantize_rows
    rows, s = quantize_rows(jnp.asarray(cur))
    return np.asarray(rows), np.asarray(s).view(np.int16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_quant_plain_matches_reference_on_dequantized_pools(case):
    from generativeaiexamples_tpu.ops.kv_quant import dequantize_rows
    H, lengths = CASES[case]
    args = _setup_quant(H, lengths)
    q, (kq, vq), (ks, vs), table, lens, ck, cv, wp, off = args
    out, *new = _run_quant_plain(args)
    deq = [np.asarray(dequantize_rows(
        jnp.asarray(p[LAYER]), jnp.asarray(s[LAYER].view(jnp.bfloat16)),
        jnp.float32)) for p, s in ((kq, ks), (vq, vs))]
    ref = jpa.paged_attention_decode_reference(
        jnp.asarray(q), jnp.asarray(deq[0]), jnp.asarray(deq[1]),
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(ck),
        jnp.asarray(cv))
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)
    (wk, wks), (wv, wvs) = _jax_rows(ck), _jax_rows(cv)
    _check_quant_pools(new, args, wk, wks, wv, wvs)


@pytest.mark.parametrize("case", ["page_edges_g2", "inactive_mid_batch",
                                  "mha_g1"])
def test_quant_plain_matches_pallas_kernel(case):
    H, lengths = CASES[case]
    args = _setup_quant(H, lengths, seed=1)
    q, (kq, vq), (ks, vs), table, lens, ck, cv, wp, off = args
    out, *new = _run_quant_plain(args)
    jout, jk, jv, jks, jvs = jpa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(wp),
        jnp.asarray(off), jnp.asarray([LAYER], jnp.int32),
        pool_ks=jnp.asarray(ks.view(jnp.bfloat16)),
        pool_vs=jnp.asarray(vs.view(jnp.bfloat16)), interpret=True)
    np.testing.assert_allclose(out, np.asarray(jout), atol=1e-5, rtol=1e-5)
    # The appended rows and scales equal the Pallas kernel's, and both
    # equal the JAX quantize_rows of cur_k/cur_v.
    jk, jv = np.asarray(jk), np.asarray(jv)
    jks, jvs = (np.asarray(a).view(np.int16) for a in (jks, jvs))
    idx = (LAYER, wp, slice(None), off)
    (wk, wks), (wv, wvs) = _jax_rows(ck), _jax_rows(cv)
    live = lens > 0
    for mine, theirs in ((jk[idx], wk), (jks[idx], wks), (jv[idx], wv),
                         (jvs[idx], wvs)):
        np.testing.assert_array_equal(mine[live], theirs[live])
    _check_quant_pools(new, args, jk[idx], jks[idx], jv[idx], jvs[idx])


def test_quant_plain_leaves_other_bytes_alone():
    """Apart from the appended rows and scales (and the trash page), the
    int8 plain version changes no pool or scale byte."""
    args = _setup_quant(8, [15, 0, 33, 16])
    q, (kq, vq), (ks, vs), table, lens, ck, cv, wp, off = args
    _, nk, nv, nks, nvs = _run_quant_plain(args)
    touched = np.zeros(kq.shape[:4], bool)
    touched[LAYER, 0] = True
    for b in np.flatnonzero(lens > 0):
        touched[LAYER, wp[b], :, off[b]] = True
    for got, before in ((nk, kq), (nv, vq)):
        np.testing.assert_array_equal(got[~touched], before[~touched])
    for got, before in ((nks, ks), (nvs, vs)):
        np.testing.assert_array_equal(got[~touched], before[~touched])


def test_quant_cpu_calls_do_not_count_as_launches():
    before = (tpa.paged_attention_decode.launches,
              tpa.paged_attention_decode.int8_launches)
    _run_quant_plain(_setup_quant(8, [5, 9]))
    assert (tpa.paged_attention_decode.launches,
            tpa.paged_attention_decode.int8_launches) == before


def test_quant_wrapper_rejects_bad_arguments():
    q, (kq, vq), (ks, vs), table, lens, ck, cv, wp, off = _setup_quant(
        8, [5, 9])
    base = [_t(q), _t(kq), _t(vq), _t(table), _t(lens), _t(ck), _t(cv),
            _t(wp), _t(off), LAYER]
    scales = {"pool_ks": _bf16(ks), "pool_vs": _bf16(vs)}
    with pytest.raises(ValueError, match="scale pools"):
        tpa.paged_attention_decode(*base)                  # int8, no scales
    with pytest.raises(ValueError, match="both scale pools"):
        tpa.paged_attention_decode(*base, pool_ks=scales["pool_ks"])
    bad_cur = list(base)
    bad_cur[5] = _t(ck).to(torch.int8)                     # cur in pool dtype
    with pytest.raises(ValueError, match="cur_k dtype"):
        tpa.paged_attention_decode(*bad_cur, **scales)
    with pytest.raises(ValueError, match="pool_ks"):
        tpa.paged_attention_decode(
            *base, pool_ks=scales["pool_ks"].float(),
            pool_vs=scales["pool_vs"])
    with pytest.raises(ValueError, match="pool_vs"):
        tpa.paged_attention_decode(
            *base, pool_ks=scales["pool_ks"],
            pool_vs=scales["pool_vs"][..., :-1])


# ---------------------------------------------------------- split plan
#
# The CUDA kernel splits each slot's rows into S splits of R rows (split
# pass), then merges the live splits in order and folds the current token
# in (merge pass). Its plan is a pure function of static shapes, and its
# algebra is emulated here in numpy and held against the JAX oracle
# (atol 1e-5: float32 on both sides, sums in another order).

@pytest.mark.parametrize("width,page,batch,kv", [
    (24, 128, 8, 32), (17, 128, 8, 32), (9, 128, 8, 32), (0, 16, 1, 1),
    (1, 1, 1, 1), (3, 16, 6, 4), (33, 16, 5, 4), (5, 100, 2, 2),
    (4096, 16, 64, 32), (1000, 8, 1, 8), (7, 128, 200, 128)])
def test_split_plan_covers_the_table_from_static_shapes(width, page, batch,
                                                        kv):
    rows, splits = tpa.split_plan(width, page, batch, kv)
    assert rows % page == 0 and rows >= tpa.MIN_SPLIT_ROWS
    assert splits >= 1 and splits * rows >= width * page
    # No split starts past the rows the table can address.
    assert (splits - 1) * rows < max(width * page, 1)
    # The split pass's grid stays bounded.
    assert splits * batch * kv <= max(tpa.MAX_SPLIT_BLOCKS, batch * kv)


def test_split_plan_takes_static_shapes_only():
    import inspect
    assert list(inspect.signature(tpa.split_plan).parameters) == [
        "width", "page", "batch", "kv_heads"]
    # llama-2-7b decode at page 128: the card check's table (24 pages)
    # and an engine table of 17 pages.
    assert tpa.split_plan(24, 128, 8, 32) == (256, 12)
    assert tpa.split_plan(17, 128, 8, 32) == (256, 9)


def _windows(pool, table):
    """(L-layer pool)[LAYER] rows in each slot's logical order: (B, W *
    page, KV, ...) from (N, KV, page, ...) pages."""
    g = pool[LAYER][table]                         # (B, W, KV, page, ...)
    g = np.swapaxes(g, 2, 3)                       # (B, W, page, KV, ...)
    return g.reshape((g.shape[0], -1) + g.shape[3:])


def _two_pass(q, kwin, vwin, lens, ck, cv, rows, splits, kscale=None,
              vscale=None):
    """The kernel's algebra in float32: a state (m, l, acc) per live split
    of ``rows`` rows (a split at or past a slot's length is never read),
    row scales folded into the scores (K) and the probabilities (V),
    states merged in split order with an online max, then the current
    token folded in as the TPU kernel's epilogue does."""
    f = np.float32
    B, H, d = q.shape
    KV = kwin.shape[2]
    G = H // KV
    scale = f(d ** -0.5)
    out = np.empty((B, H, d), f)
    for b in range(B):
        for h in range(KV):
            qg = q[b, h * G:(h + 1) * G]
            mm, ll = np.full(G, tpa.NEG, f), np.zeros(G, f)
            aa = np.zeros((G, d), f)
            for s in range(splits):
                r0, r1 = s * rows, min((s + 1) * rows, int(lens[b]))
                if r0 >= r1:
                    continue
                sc = qg @ kwin[b, r0:r1, h].T
                if kscale is not None:
                    sc = sc * kscale[b, r0:r1, h]
                sc = sc * scale
                m = sc.max(-1)
                p = np.exp(sc - m[:, None])
                l_ = p.sum(-1)
                if vscale is not None:
                    p = p * vscale[b, r0:r1, h]
                acc = p @ vwin[b, r0:r1, h]
                mn = np.maximum(mm, m)
                ea, eb = np.exp(mm - mn), np.exp(m - mn)
                ll = ll * ea + l_ * eb
                aa = aa * ea[:, None] + acc * eb[:, None]
                mm = mn
            s_cur = (qg @ ck[b, h]) * scale
            m2 = np.maximum(mm, s_cur)
            a, bta = np.exp(mm - m2), np.exp(s_cur - m2)
            out[b, h * G:(h + 1) * G] = ((aa * a[:, None]
                                          + cv[b, h] * bta[:, None])
                                         / (ll * a + bta)[:, None])
    return out


SPLIT_CASES = {
    # (MIN_SPLIT_ROWS, H, lengths). 256-row splits (the default) over
    # 16-row pages: lengths at R - 1, R, R + 1 and 2R, and a slot at 0.
    "r256_edges": (256, 8, [255, 256, 257, 0, 512]),
    # 32-row splits: several splits per slot, empty splits for the short
    # slots, G = 4.
    "r32_many_splits": (32, 16, [31, 32, 33, 0, 64, 5]),
    # Every slot at 0: no live split anywhere.
    "all_empty": (32, 8, [0, 0, 0]),
}


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_two_pass_algebra_matches_reference(case, quant, monkeypatch):
    min_rows, H, lengths = SPLIT_CASES[case]
    monkeypatch.setattr(tpa, "MIN_SPLIT_ROWS", min_rows)
    if quant:
        from generativeaiexamples_tpu.ops.kv_quant import dequantize_rows
        q, (kq, vq), (ks, vs), table, lens, ck, cv, wp, off = _setup_quant(
            H, lengths)
        kf = [np.asarray(dequantize_rows(
            jnp.asarray(p[LAYER]), jnp.asarray(s[LAYER].view(jnp.bfloat16)),
            jnp.float32)) for p, s in ((kq, ks), (vq, vs))]
        ref_k, ref_v = kf
        kwin, vwin = (_windows(p.astype(np.float32), table)
                      for p in (kq, vq))
        kscale, vscale = (_windows(np.asarray(jnp.asarray(
            s.view(jnp.bfloat16)).astype(jnp.float32)), table)
            for s in (ks, vs))
    else:
        q, pk, pv, table, lens, ck, cv, wp, off = _setup(H, lengths)
        ref_k, ref_v = pk[LAYER], pv[LAYER]
        kwin, vwin = _windows(pk, table), _windows(pv, table)
        kscale = vscale = None
    rows, splits = tpa.split_plan(table.shape[1], page, len(lengths), KV)
    assert rows == max(min_rows, page)
    got = _two_pass(q, kwin, vwin, lens, ck, cv, rows, splits, kscale,
                    vscale)
    ref = jpa.paged_attention_decode_reference(
        jnp.asarray(q), jnp.asarray(ref_k), jnp.asarray(ref_v),
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(ck),
        jnp.asarray(cv))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    # No live split: the output is exactly cur_v.
    G = H // KV
    for b in np.flatnonzero(lens == 0):
        np.testing.assert_array_equal(got[b], np.repeat(cv[b], G, axis=0))


def _global_functions(source: str) -> list[str]:
    """Names of the __global__ functions of a CUDA source, past any
    __launch_bounds__(...) (whose argument may hold parentheses)."""
    import re
    names = []
    for m in re.finditer(r"__global__\s+void\s+", source):
        i = m.end()
        if source.startswith("__launch_bounds__", i):
            i = source.index("(", i)
            depth = 0
            while True:
                depth += {"(": 1, ")": -1}.get(source[i], 0)
                i += 1
                if depth == 0:
                    break
        names.append(re.match(r"\s*(\w+)\s*\(", source[i:]).group(1))
    return names


def test_profile_attributes_every_kernel_of_csrc():
    """``tools/profile_decode.py`` attributes device time by kernel name:
    every __global__ function of ``csrc/*.cu`` is named in ``_OURS``, the
    attention kernel's split and merge passes under paged_attention."""
    from generativeaiexamples_tpu_torch.kernels import build
    from generativeaiexamples_tpu_torch.tools.profile_decode import _OURS
    named = {sym for syms in _OURS.values() for sym in syms}
    found = [n for path in sorted(build.CSRC.glob("*.cu"))
             for n in _global_functions(path.read_text())]
    assert len(found) == 6
    assert set(found) <= named
    assert set(_OURS["paged_attention"]) == {"paged_decode_split_kernel",
                                             "paged_decode_merge_kernel"}
