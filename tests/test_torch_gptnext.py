"""The GPT-Next family (Nemotron: layernorm1p, squared-ReLU MLP, optional
biases) in the port against the JAX package, on the CPU.

One numpy tree at the ``gptnext-tiny`` geometry drives both packages
(``models/convert.py``). The norm weights and offsets, and in the biased
variant every projection bias, are drawn at random (the reference's
``init_params`` makes them zero, which would hide a misplaced term).
Tolerances: float32 on both sides, so rtol 2e-4 / atol 1e-5 on logits
and 1e-4 on hidden states and pools (two layers of summation-order
noise); int8 pools as ``test_torch_chunked_prefill.py`` holds them (one
quantization step where a row's rounding falls on a tie)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models.configs import GPTNEXT_TINY as JCFG
from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import GPTNEXT_TINY
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.ops.rmsnorm import layernorm1p

RTOL, ATOL = 2e-4, 1e-5
BIASED = {"attn_bias": True, "mlp_bias": True}
VARIANTS = {"plain": {}, "biased": BIASED}


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(GPTNEXT_TINY, **kw),
            dataclasses.replace(JCFG, **kw))


def _np_tree(variant, seed=7):
    """The JAX init_params tree with random norms and biases."""
    _, jcfg = _cfgs(variant)
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jcfg, jax.random.key(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)

    def rand_like(a, scale):
        return (rng.standard_normal(a.shape) * scale).astype(np.float32)

    layers = dict(tree["layers"])
    for key in list(layers):
        if key.endswith("_norm") or key.endswith("_norm_b"):
            layers[key] = rand_like(layers[key], 0.1)
        elif key in ("bq", "bk", "bv", "bo", "b_up", "b_down"):
            layers[key] = rand_like(layers[key], 0.05)
    tree = {**tree, "layers": layers,
            "final_norm": rand_like(tree["final_norm"], 0.1),
            "final_norm_b": rand_like(tree["final_norm_b"], 0.1)}
    return tree


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    cfg, jcfg = _cfgs(request.param)
    tree = _np_tree(request.param)
    return (cfg, jcfg, tree, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu", torch.float32, cfg=cfg))


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t.float() if isinstance(
        t, torch.Tensor) else t), np.asarray(j, np.float32), rtol=rtol,
        atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm1p_matches_jax(dtype):
    """float32 statistics and affine step, result in the input dtype: the
    same bits up to one bf16 rounding (float32: rtol 1e-6)."""
    from generativeaiexamples_tpu.ops.rmsnorm import layernorm1p as jln
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    td = getattr(torch, dtype)
    jd = getattr(jnp, dtype)
    got = layernorm1p(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                      torch.from_numpy(b).to(td))
    want = jln(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
               jnp.asarray(b).astype(jd))
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 8e-3
    _close(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_tree_layout_matches_the_reference():
    """init_params makes the reference's keys and shapes for both
    variants (no w_gate; norm offsets; biases where the config says)."""
    for variant in VARIANTS:
        cfg, jcfg = _cfgs(variant)
        mine = llama.init_params(cfg, seed=0, dtype=torch.float32)
        ref = jllama.init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
        flat_m = {k: tuple(v.shape) for k, v in mine["layers"].items()}
        flat_r = {k: tuple(v.shape) for k, v in ref["layers"].items()}
        assert flat_m == flat_r
        assert set(mine) == set(ref)
        assert "w_gate" not in mine["layers"]
        assert float(mine["layers"]["attn_norm"].abs().sum()) == 0.0


def test_apply_and_score_match_jax(model):
    cfg, jcfg, _, jp, tp = model
    rng = np.random.default_rng(1)
    B, S = 2, 11
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    tl, _ = llama.apply(tp, cfg, torch.from_numpy(tokens),
                        torch.from_numpy(pos))
    jl, _ = jllama.apply(jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos))
    _close(tl, jl)
    # score: one pass and the chunked dense-cache path (chunk 16 < S).
    long = rng.integers(0, cfg.vocab_size, (1, 40)).astype(np.int32)
    for chunk in (64, 16):
        got = llama.score(tp, cfg, torch.from_numpy(long), chunk=chunk)
        want = jllama.score(jp, jcfg, jnp.asarray(long), chunk=chunk)
        _close(got, want, rtol=1e-4, atol=1e-4)


def _pools(kind, rng, shape):
    if kind == "int8":
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": (rng.random(shape[:4]) * 0.02 + 1e-3).astype(
                    np.float32),
                "vs": (rng.random(shape[:4]) * 0.02 + 1e-3).astype(
                    np.float32)}
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _port_pools(pools):
    out = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    for k in ("ks", "vs"):
        if k in out:
            out[k] = out[k].to(torch.bfloat16)
    return out


def _jax_pools(pools):
    return {k: (jnp.asarray(v, jnp.bfloat16) if k in ("ks", "vs")
                else jnp.asarray(v)) for k, v in pools.items()}


def _check_pools(got, want, skip_trash=False):
    for name in got:
        g = got[name].float().numpy() if got[name].dtype != torch.int8 \
            else got[name].numpy().astype(np.int32)
        w = np.asarray(want[name]).astype(np.float32 if got[name].dtype
                                          != torch.int8 else np.int32)
        if skip_trash:
            g, w = g[:, 1:], w[:, 1:]
        if got[name].dtype == torch.int8:
            assert np.abs(g - w).max() <= 1, name
        elif name in ("ks", "vs"):
            np.testing.assert_allclose(g, w, rtol=8e-3, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_apply_decode_paged_matches_jax(model, kind):
    cfg, jcfg, _, jp, tp = model
    rng = np.random.default_rng(2)
    page, W = 16, 3
    lengths = np.array([5, 0, 16, 33], np.int32)     # slot 1 idle
    B = len(lengths)
    N = 1 + B * W
    shape = (cfg.num_layers, N, cfg.num_kv_heads, page, cfg.head_dim)
    pools = _pools(kind, rng, shape)
    table = (1 + np.arange(B * W)).reshape(B, W).astype(np.int32)
    live = lengths > 0
    wp = np.where(live, table[np.arange(B), lengths // page], 0
                  ).astype(np.int32)
    off = np.where(live, lengths % page, 0).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = lengths[:, None]
    t = torch.from_numpy
    tl, tcache = llama.apply_decode_paged(
        tp, cfg, t(tokens), t(pos), _port_pools(pools), t(table), t(wp),
        t(off))
    jl, jcache = jllama.apply_decode_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos), _jax_pools(pools),
        jnp.asarray(table), jnp.asarray(lengths + 1), jnp.asarray(wp),
        jnp.asarray(off), use_kernel=False)
    atol = ATOL if kind == "f32" else 1e-3
    _close(tl[live], np.asarray(jl)[live], rtol=1e-3 if kind == "int8"
           else RTOL, atol=atol)
    _check_pools(tcache, jcache, skip_trash=True)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_apply_prefill_paged_matches_jax(model, kind):
    """A chunk of 2 pages after 1 cached page: hidden states of the valid
    rows and the pools after the scatter."""
    cfg, jcfg, _, jp, tp = model
    rng = np.random.default_rng(3)
    page, C, N, W = 16, 32, 8, 6
    start_pages, n = 1, 27
    start = start_pages * page
    shape = (cfg.num_layers, N, cfg.num_kv_heads, page, cfg.head_dim)
    pools = _pools(kind, rng, shape)
    tokens = rng.integers(3, cfg.vocab_size, (1, C)).astype(np.int32)
    tokens[0, n:] = 0
    positions = (start + np.arange(C, dtype=np.int32))[None, :]
    table = np.zeros((1, W), np.int32)
    table[0, :start_pages + 2] = rng.permutation(np.arange(1, N))[:3]
    t = torch.from_numpy
    th, tcache = llama.apply_prefill_paged(
        tp, cfg, t(tokens), t(positions), _port_pools(pools), t(table),
        torch.tensor([start + n], dtype=torch.int32),
        torch.tensor([start_pages], dtype=torch.int32))
    jh, jcache = jllama.apply_prefill_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        _jax_pools(pools), jnp.asarray(table),
        jnp.asarray([start + n], jnp.int32), jnp.int32(start_pages))
    atol = 1e-4 if kind == "f32" else 2e-3
    np.testing.assert_allclose(th.numpy()[0, :n], np.asarray(jh)[0, :n],
                               atol=atol)
    _check_pools(tcache, jcache)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_apply_verify_paged_matches_jax(model, kind):
    """Three slots (one idle) scoring S = 4 positions each."""
    cfg, jcfg, _, jp, tp = model
    rng = np.random.default_rng(4)
    page, S, P, n_pages = 16, 4, 4, 16
    B = 3
    shape = (cfg.num_layers, n_pages, cfg.num_kv_heads, page, cfg.head_dim)
    pools = _pools(kind, rng, shape)
    table = np.stack([rng.permutation(np.arange(1, n_pages))[:P]
                      for _ in range(B)]).astype(np.int32)
    pos = np.array([page - 2, 2 * page + 5, 0], np.int32)
    n_draft = np.array([S - 1, 1, 0], np.int32)
    tokens = rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32)
    offs = np.arange(S, dtype=np.int32)
    positions = pos[:, None] + offs[None, :]
    active = np.array([True, True, False])
    ok = active[:, None] & (offs[None, :] <= n_draft[:, None])
    pages = np.take_along_axis(table, positions // page, axis=1)
    wp = np.where(ok, pages, 0).astype(np.int32)
    off = (positions % page).astype(np.int32)
    valid = (pos + S).astype(np.int32)
    t = torch.from_numpy
    logits, tcache = llama.apply_verify_paged(
        tp, cfg, t(tokens), t(positions), _port_pools(pools), t(table),
        t(valid), t(wp), t(off))
    jlogits, jcache = jllama.apply_verify_paged(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        _jax_pools(pools), jnp.asarray(table), jnp.asarray(valid),
        jnp.asarray(wp), jnp.asarray(off))
    live = ok.any(axis=1)
    np.testing.assert_allclose(logits.numpy()[live],
                               np.asarray(jlogits)[live],
                               atol=1e-4 if kind == "f32" else 2e-3)
    _check_pools(tcache, jcache, skip_trash=True)


def test_int4_awq_matches_jax(model):
    """The JAX ``quantize_params`` int4_awq tree (group 128: D 128, F 256)
    carries over bit for bit; the squared-ReLU tree has six projections a
    layer; logits of the quantized forward equal the reference's
    ``_grouped_matmul`` path (rtol 1e-3: the per-group float32 partial
    sums are the same, only the order of their terms differs)."""
    from generativeaiexamples_tpu.ops.quant import \
        quantize_params as jquantize
    from generativeaiexamples_tpu_torch.ops.quant import (is_quantized,
                                                          quantize_params)
    cfg, jcfg, tree, jp, tp = model
    jq = jax.tree.map(np.asarray, jquantize(jp, "int4_awq", 128))
    tq = params_from_numpy(jq, "cpu", torch.float32, cfg=cfg)
    mine = quantize_params(tp, "int4_awq", group_size=128)
    quantized = sorted(k for k, v in mine["layers"].items()
                       if is_quantized(v))
    assert quantized == sorted(llama.projection_keys(cfg))
    assert len(quantized) == 6
    for key in quantized:
        for leaf, arr in jq["layers"][key].items():
            np.testing.assert_array_equal(mine["layers"][key][leaf].numpy(),
                                          arr)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    tl, _ = llama.apply(tq, cfg, torch.from_numpy(tokens),
                        torch.from_numpy(pos))
    jl, _ = jllama.apply(jax.tree.map(jnp.asarray, jq), jcfg,
                         jnp.asarray(tokens), jnp.asarray(pos))
    _close(tl, jl, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------- engine

ENGINE_KW = dict(max_slots=2, max_input_length=128, max_output_length=16,
                 prefill_buckets=(32,), page_size=16, dtype="float32",
                 kv_pool_tokens=None, steps_per_round=4,
                 max_prefill_bucket=32, sched_round_budget_tokens=32,
                 sched_prefill_chunk_tokens=32)


def _prompt(n, salt=0):
    return [1] + [3 + (7 * i + salt) % 250 for i in range(n - 1)]


def test_engine_greedy_tokens_match_jax_engine(monkeypatch):
    """The biased GPT-Next tree through both engines: a 70-token prompt
    admitted in chunks of 32 beside a short one, then the long prompt
    again (a prefix-cache hit); the fused tail on both sides."""
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    monkeypatch.setenv("SCHED_ONLINE_CALIB", "0")
    cfg, jcfg = _cfgs("biased")
    tree = _np_tree("biased", seed=11)
    runs = [[(_prompt(70), 8), (_prompt(9, 1), 10)], [(_prompt(70), 6)]]

    jout = []
    with JEngine(jax.tree.map(jnp.asarray, tree), jcfg, JTok(),
                 JConfig(**ENGINE_KW)) as jeng:
        for batch in runs:
            streams = [jeng.submit(p, JParams(max_tokens=m, top_k=1,
                                              ignore_eos=True))
                       for p, m in batch]
            for s in streams:
                s.text()
            jout.append([s.token_ids for s in streams])
        jstats = jeng.stats

    engine = Engine(params_from_numpy(tree, "cpu", torch.float32, cfg=cfg),
                    cfg, ByteTokenizer(), EngineConfig(**ENGINE_KW),
                    device="cpu")
    assert engine.cfg.fused_tail
    out = []
    with engine:
        for batch in runs:
            streams = [engine.submit(p, SamplingParams(
                max_tokens=m, top_k=1, ignore_eos=True)) for p, m in batch]
            for s in streams:
                s.text()
            out.append([s.token_ids for s in streams])
    assert out == jout
    st = engine.stats
    assert st["prefill_chunks"] >= 3
    assert st["prefix_cache_hit_tokens"] > 0
    assert st["prefix_cache_hit_tokens"] == jstats["prefix_cache_hit_tokens"]
