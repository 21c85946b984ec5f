"""The port's llama forward passes against the JAX package's, on the CPU.

One numpy parameter tree (drawn by the JAX package's ``init_params`` at
the ``llama-tiny`` geometry, float32) drives both packages through
``models/convert.py``. Tolerance: rtol 2e-4 (atol 1e-5 for logits near
zero) — float32 on both sides, two layers of summation-order noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.utils.errors import ConfigError

CFG = LLAMA_TINY
RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture(scope="module")
def params():
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    assert JCFG == CFG or vars(JCFG) == vars(CFG)
    jp = jllama.init_params(JCFG, jax.random.key(3), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return tree, jp, params_from_numpy(tree, "cpu", torch.float32, cfg=CFG)


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


def test_convert_keeps_layout_and_bits(params):
    tree, _, tp = params
    np.testing.assert_array_equal(tp["layers"]["wq"].numpy(),
                                  tree["layers"]["wq"])
    assert tuple(tp["lm_head"].shape) == (CFG.hidden_size, CFG.vocab_size)
    # bfloat16 leaves (as jax hands them out) carry over bit for bit.
    bf = jnp.asarray(tree["embed"]).astype(jnp.bfloat16)
    tb = params_from_numpy({**tree, "embed": np.asarray(bf)}, "cpu",
                           torch.bfloat16)
    np.testing.assert_array_equal(
        tb["embed"].view(torch.int16).numpy(),
        np.asarray(bf).view(np.int16))


def test_convert_refuses_foreign_leaves(params):
    tree = params[0]
    with pytest.raises(ConfigError):
        params_from_numpy({**tree, "layers": {**tree["layers"],
                                              "bq": np.zeros(3)}}, "cpu")
    with pytest.raises(ConfigError):
        params_from_numpy(tree, "cpu", cfg=CFG.__class__(hidden_size=64))


def test_apply_logits_match_jax(params):
    _, jp, tp = params
    rng = np.random.default_rng(0)
    B, S = 2, 9
    tokens = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    tl, _ = tllama.apply(tp, CFG, torch.from_numpy(tokens),
                         torch.from_numpy(pos))
    jl, _ = jllama.apply(jp, CFG, jnp.asarray(tokens), jnp.asarray(pos))
    _close(tl, jl)


def test_apply_with_cache_matches_jax(params):
    """Prefill into a dense cache (the engine's admission path), with a
    valid length shorter than the bucket."""
    _, jp, tp = params
    rng = np.random.default_rng(1)
    S, n = 16, 11
    tokens = rng.integers(0, CFG.vocab_size, (1, S)).astype(np.int32)
    pos = np.arange(S, dtype=np.int32)[None, :]
    vl = np.array([n], np.int32)
    tc = tllama.init_kv_cache(CFG, 1, S, torch.float32)
    tl, tc = tllama.apply(tp, CFG, torch.from_numpy(tokens),
                          torch.from_numpy(pos), tc,
                          kv_valid_len=torch.from_numpy(vl))
    jc = jllama.init_kv_cache(CFG, 1, S, jnp.float32)
    jl, jc = jllama.apply(jp, CFG, jnp.asarray(tokens), jnp.asarray(pos),
                          jc, kv_valid_len=jnp.asarray(vl))
    _close(tl[:, :n], jl[:, :n])
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_apply_decode_paged_matches_jax(params):
    """One paged decode step (the plain version on the CPU; the JAX side
    takes its gather path): logits and both pools after the append."""
    _, jp, tp = params
    rng = np.random.default_rng(2)
    page, W = 16, 3
    lengths = np.array([5, 0, 16, 33], np.int32)    # slot 1 inactive
    B = len(lengths)
    N = 1 + B * W
    shape = (CFG.num_layers, N, CFG.num_kv_heads, page, CFG.head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    table = (1 + np.arange(B * W)).reshape(B, W).astype(np.int32)
    live = lengths > 0
    wp = np.where(live, table[np.arange(B), lengths // page], 0
                  ).astype(np.int32)
    off = np.where(live, lengths % page, 0).astype(np.int32)
    tokens = rng.integers(0, CFG.vocab_size, (B, 1)).astype(np.int32)
    pos = lengths[:, None]

    tcache = {"k": torch.from_numpy(pk.copy()),
              "v": torch.from_numpy(pv.copy())}
    tl, tcache = tllama.apply_decode_paged(
        tp, CFG, torch.from_numpy(tokens), torch.from_numpy(pos), tcache,
        torch.from_numpy(table), torch.from_numpy(wp), torch.from_numpy(off))
    jl, jcache = jllama.apply_decode_paged(
        jp, CFG, jnp.asarray(tokens), jnp.asarray(pos),
        {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}, jnp.asarray(table),
        jnp.asarray(lengths + 1), jnp.asarray(wp), jnp.asarray(off),
        use_kernel=False)
    _close(tl, jl)
    # Page 0 is the trash page: only the inactive slot wrote it.
    for name in ("k", "v"):
        _close(tcache[name][:, 1:], np.asarray(jcache[name])[:, 1:])


@pytest.mark.parametrize("mode,group", [("int8", 128), ("int4_awq", 32)])
def test_convert_carries_quantized_params_bit_for_bit(params, mode, group):
    """A JAX ``quantize_params`` tree carries over with its int8 and
    float32 leaves unchanged (LLAMA_TINY's F = 352 takes group 32)."""
    from generativeaiexamples_tpu.ops.quant import quantize_params
    _, jp, _ = params
    jq = jax.tree.map(np.asarray, quantize_params(jp, mode, group))
    tq = params_from_numpy(jq, "cpu", torch.float32, cfg=CFG)
    for key in ("wq", "w_down"):
        for leaf, arr in jq["layers"][key].items():
            t = tq["layers"][key][leaf]
            assert t.dtype == (torch.int8 if leaf in ("q", "q4")
                               else torch.float32)
            np.testing.assert_array_equal(t.numpy(), arr)
    for leaf, arr in jq["lm_head"].items():
        np.testing.assert_array_equal(tq["lm_head"][leaf].numpy(), arr)
    # A leaf whose reduction rows were cut does not fit the config.
    bad = dict(jq["layers"]["wq"])
    ikey = "q" if mode == "int8" else "q4"
    bad[ikey] = bad[ikey][:, :-2]
    with pytest.raises(ConfigError):
        params_from_numpy({**jq, "layers": {**jq["layers"], "wq": bad}},
                          "cpu", cfg=CFG)


def test_apply_decode_paged_int8_pool_int4_awq_matches_jax(params):
    """One paged decode step with int4_awq weights over an int8 pool (the
    plain versions on the CPU; the JAX side takes its gather path):
    logits at the file's tolerance, the live rows and scales of both pools
    unchanged and the appended rows and scales bit-equal."""
    from generativeaiexamples_tpu.ops.kv_quant import quantize_rows
    from generativeaiexamples_tpu.ops.quant import quantize_params
    _, jp, _ = params
    jqp = quantize_params(jp, "int4_awq", 32)
    tqp = params_from_numpy(jax.tree.map(np.asarray, jqp), "cpu",
                            torch.float32, cfg=CFG)
    rng = np.random.default_rng(4)
    page, W = 16, 3
    lengths = np.array([5, 0, 16, 33], np.int32)    # slot 1 inactive
    B = len(lengths)
    N = 1 + B * W
    shape = (CFG.num_layers, N, CFG.num_kv_heads, page, CFG.head_dim)
    kq, ks = quantize_rows(jnp.asarray(rng.standard_normal(shape),
                                       jnp.float32))
    vq, vs = quantize_rows(jnp.asarray(rng.standard_normal(shape),
                                       jnp.float32))
    jcache = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    table = (1 + np.arange(B * W)).reshape(B, W).astype(np.int32)
    live = lengths > 0
    wp = np.where(live, table[np.arange(B), lengths // page], 0
                  ).astype(np.int32)
    off = np.where(live, lengths % page, 0).astype(np.int32)
    tokens = rng.integers(0, CFG.vocab_size, (B, 1)).astype(np.int32)
    pos = lengths[:, None]

    def bits(a):
        a = np.array(a)
        return a.view(np.int16) if a.dtype.name == "bfloat16" else a

    tcache = {k: torch.from_numpy(bits(v).copy()) for k, v in jcache.items()}
    for k in ("ks", "vs"):
        tcache[k] = tcache[k].view(torch.bfloat16)
    assert tllama.kv_cache_quantized(tcache)
    tl, tcache = tllama.apply_decode_paged(
        tqp, CFG, torch.from_numpy(tokens), torch.from_numpy(pos), tcache,
        torch.from_numpy(table), torch.from_numpy(wp), torch.from_numpy(off))
    jl, jnew = jllama.apply_decode_paged(
        jqp, CFG, jnp.asarray(tokens), jnp.asarray(pos), jcache,
        jnp.asarray(table), jnp.asarray(lengths + 1), jnp.asarray(wp),
        jnp.asarray(off), use_kernel=False)
    _close(tl, jl)
    # Page 0 is the trash page: only the inactive slot wrote it.
    for name in ("k", "v", "ks", "vs"):
        got = tcache[name]
        got = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        np.testing.assert_array_equal(got.numpy()[:, 1:],
                                      bits(jnew[name])[:, 1:])
