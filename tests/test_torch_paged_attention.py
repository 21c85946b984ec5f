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
