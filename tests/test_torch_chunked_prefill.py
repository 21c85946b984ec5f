"""The port's chunked paged prefill against the JAX package on the CPU:
``_paged_prefix_attention`` and ``apply_prefill_paged`` on the same numpy
inputs, and the engine's greedy tokens through chunked admissions, prefix
hits and a long prompt chunking behind a decoding slot.

Tolerances (set from the dtype before measuring): float32 atol 1e-4;
bfloat16 atol 1e-3 and rtol 1e-2; a bf16 pool's rows within one ulp;
int8 pools: codes within 1 and bf16 scales within one ulp. Greedy tokens
are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import LLAMA_TINY
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

CFG = LLAMA_TINY
PAGE = 16
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.bfloat16}
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.bfloat16}


@pytest.fixture(scope="module")
def jax_params():
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    return jllama.init_params(JCFG, jax.random.key(11), dtype=jnp.float32)


@pytest.fixture(scope="module")
def np_params(jax_params):
    return jax.tree.map(np.asarray, jax_params)


def _np(x) -> np.ndarray:
    """A torch or JAX array as float32 numpy (int8 kept)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype != torch.int8 else x.numpy()
    x = np.asarray(x)
    return x if x.dtype == np.int8 else x.astype(np.float32)


def _bits16(x) -> np.ndarray:
    """bf16 values as their int16 bit patterns (one ulp = 1 apart for
    values of one sign)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


def _pools(kind, rng, n_pages):
    """Random (stale) pools as numpy: float pools, or int8 codes with bf16
    scales from quantizing random rows (JAX's ``quantize_rows``)."""
    from generativeaiexamples_tpu.ops.kv_quant import quantize_rows
    shape = (CFG.num_layers, n_pages, CFG.num_kv_heads, PAGE, CFG.head_dim)
    out = {}
    for name in ("k", "v"):
        x = rng.standard_normal(shape).astype(np.float32)
        if kind == "int8":
            q, s = quantize_rows(jnp.asarray(x))
            out[name], out[name + "s"] = np.asarray(q), np.asarray(s)
        else:
            out[name] = np.asarray(jnp.asarray(x).astype(JAX_DTYPES[kind]))
    return out


def _poison(pools, rows):
    """A copy of ``pools`` with NaN at each (page, row) of ``rows``: the
    float rows, or the int8 pools' scales."""
    out = dict(pools)
    for name in ("ks", "vs") if "ks" in pools else ("k", "v"):
        arr = pools[name].astype(np.float32)
        for page, row in rows:
            arr[:, page, :, row] = np.nan
        out[name] = np.asarray(jnp.asarray(arr).astype(pools[name].dtype))
    return out


def _to_torch(pools):
    out = {}
    for name, arr in pools.items():
        if arr.dtype == np.int8:
            out[name] = torch.from_numpy(arr.copy())
        else:
            out[name] = torch.from_numpy(
                np.asarray(arr, np.float32)).to(
                torch.float32 if arr.dtype == np.float32
                else torch.bfloat16)
    return out


# (start pages, valid tokens after start): prompt lengths k*page - 1,
# k*page + 1 and k*page, the chunk 2 pages wide.
GEOMETRY = [(2, PAGE - 1), (2, PAGE + 1), (3, 2 * PAGE), (1, 1)]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("start_pages,n", GEOMETRY,
                         ids=[f"start{s}p-n{n}" for s, n in GEOMETRY])
def test_paged_prefix_attention_matches_jax(kind, start_pages, n):
    """Chunk queries over a prefix streamed in 2-page blocks plus the
    chunk itself, against the reference on the same inputs; then the same
    call with NaN in every stale row of the window (rows at or past the
    chunk's start: float rows, or int8 scales) gives bit-identical valid
    rows."""
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JC
    from generativeaiexamples_tpu.models.llama import \
        _paged_prefix_attention as jattn
    rng = np.random.default_rng(start_pages * 100 + n)
    C, N, Pw = 2 * PAGE, 10, 7
    start = start_pages * PAGE
    valid = start + n
    cfg_kw = {k: getattr(CFG, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "num_layers",
        "num_heads", "num_kv_heads", "head_dim", "max_position_embeddings")}
    table = np.asarray([rng.permutation(np.arange(1, N))[:Pw]], np.int32)
    stale = [(int(table[0, p]), r) for p in range(Pw) for r in range(PAGE)
             if p * PAGE + r >= start]
    jd, td = JAX_DTYPES[kind], TORCH_DTYPES[kind]
    q, ks, vs = (rng.standard_normal((1, C, h, CFG.head_dim)).astype(
        np.float32) for h in (CFG.num_heads, CFG.num_kv_heads,
                              CFG.num_kv_heads))

    def run_torch(pools):
        t = _to_torch(pools)
        return llama._paged_prefix_attention(
            torch.from_numpy(q).to(td), torch.from_numpy(ks).to(td),
            torch.from_numpy(vs).to(td), t["k"][0], t["v"][0],
            t["ks"][0] if kind == "int8" else None,
            t["vs"][0] if kind == "int8" else None,
            torch.from_numpy(table), torch.tensor(start, dtype=torch.int32),
            torch.tensor([valid], dtype=torch.int32), PAGE, CFG,
            block_pages=2)

    pools = _pools(kind, rng, N)
    got = run_torch(pools)
    want = jattn(jnp.asarray(q).astype(jd), jnp.asarray(ks).astype(jd),
                 jnp.asarray(vs).astype(jd), jnp.asarray(pools["k"][0]),
                 jnp.asarray(pools["v"][0]),
                 jnp.asarray(pools["ks"][0]) if kind == "int8" else None,
                 jnp.asarray(pools["vs"][0]) if kind == "int8" else None,
                 jnp.asarray(table), jnp.int32(start),
                 jnp.asarray([valid], jnp.int32), PAGE, JC(**cfg_kw),
                 block_pages=2)
    assert got.dtype == td and got.shape == (1, C, CFG.num_heads,
                                             CFG.head_dim)
    atol, rtol = (1e-4, 0) if kind == "f32" else (1e-3, 1e-2)
    np.testing.assert_allclose(_np(got)[0, :n], _np(want)[0, :n],
                               atol=atol, rtol=rtol)
    poisoned = run_torch(_poison(pools, stale))
    assert torch.isfinite(poisoned[0, :n].float()).all()
    assert torch.equal(poisoned[0, :n], got[0, :n])


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("start_pages,n", GEOMETRY,
                         ids=[f"start{s}p-n{n}" for s, n in GEOMETRY])
def test_apply_prefill_paged_matches_jax(np_params, kind, start_pages, n):
    """One float32 chunk over a float32, bf16 or int8 pool whose prefix
    pages hold (random) cached KV: the hidden states of the valid rows
    and every pool page after the chunk's scatter equal the reference's
    (the bf16 attention arithmetic is held above, at one layer)."""
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    rng = np.random.default_rng(1000 + start_pages * 100 + n)
    C, N, W = 2 * PAGE, 12, 8
    start = start_pages * PAGE
    tokens = rng.integers(3, CFG.vocab_size, (1, C)).astype(np.int32)
    tokens[0, n:] = 0
    positions = (start + np.arange(C, dtype=np.int32))[None, :]
    table = np.zeros((1, W), np.int32)
    table[0, :start_pages + 2] = rng.permutation(
        np.arange(1, N))[:start_pages + 2]
    pools = _pools(kind, rng, N)
    jh, jcache = jllama.apply_prefill_paged(
        jax.tree.map(jnp.asarray, np_params), JCFG, jnp.asarray(tokens),
        jnp.asarray(positions), {k: jnp.asarray(v) for k, v in pools.items()},
        jnp.asarray(table), jnp.asarray([start + n], jnp.int32),
        jnp.int32(start_pages))
    th, tcache = llama.apply_prefill_paged(
        params_from_numpy(np_params, "cpu", torch.float32, cfg=CFG), CFG,
        torch.from_numpy(tokens), torch.from_numpy(positions),
        _to_torch(pools), torch.from_numpy(table),
        torch.tensor([start + n], dtype=torch.int32),
        torch.tensor([start_pages], dtype=torch.int32))
    assert th.shape == (1, C, CFG.hidden_size) and th.dtype == torch.float32
    np.testing.assert_allclose(_np(th)[0, :n], _np(jh)[0, :n], atol=1e-4)
    for name in pools:
        got, want = tcache[name], jcache[name]
        assert got.dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                             "int8": torch.int8}[kind] or name in ("ks",
                                                                   "vs")
        if got.dtype == torch.int8:
            diff = np.abs(_np(got).astype(np.int32) - _np(want).astype(
                np.int32))
            assert diff.max() <= 1, name
        elif got.dtype == torch.bfloat16:
            assert np.abs(_bits16(got) - _bits16(want)).max() <= 1, name
        else:
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                       err_msg=name)


# ---------------------------------------------------------------- engine

ENGINE_KW = dict(max_slots=2, max_input_length=128, max_output_length=16,
                 prefill_buckets=(32,), page_size=PAGE, dtype="float32",
                 kv_pool_tokens=None, steps_per_round=4,
                 max_prefill_bucket=32, sched_round_budget_tokens=32,
                 sched_prefill_chunk_tokens=32)


def _greedy(n):
    return SamplingParams(max_tokens=n, top_k=1, ignore_eos=True)


def _prompt(n, salt=0):
    return [1] + [3 + (7 * i + salt) % 250 for i in range(n - 1)]


def _engine(np_params, **kw):
    params = params_from_numpy(np_params, "cpu", torch.float32, cfg=CFG)
    return Engine(params, CFG, ByteTokenizer(),
                  EngineConfig(**{**ENGINE_KW, **kw}), device="cpu")


def _drive(engine, streams):
    for _ in range(300):
        if all(s.finish_reason is not None for s in streams):
            return [s.token_ids for s in streams]
        engine._step()
    raise AssertionError("requests did not finish in 300 steps")


def _jax_tokens(jax_params, runs, **kw):
    """The JAX engine's greedy tokens: ``runs`` is a list of batches of
    (prompt, max_tokens), each batch submitted after the previous one
    finished (so later batches can hit the prefix cache)."""
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    out = []
    with JEngine(jax_params, JCFG, JTok(),
                 JConfig(**{**ENGINE_KW, **kw})) as jeng:
        for batch in runs:
            streams = [jeng.submit(p, JParams(max_tokens=m, top_k=1,
                                              ignore_eos=True))
                       for p, m in batch]
            for s in streams:
                s.text()
            out.append([s.token_ids for s in streams])
        stats = jeng.stats
    return out, stats


def test_prompt_longer_than_max_prefill_bucket(jax_params, np_params):
    """A 100-token prompt with buckets capped at 32: four chunks (the last
    arms the slot), the JAX engine's tokens, and the one-shot engine's."""
    prompt = _prompt(100)
    engine = _engine(np_params)
    assert engine._buckets == (32,)
    got = _drive(engine, [engine.submit(prompt, _greedy(10))])
    assert engine.stats["prefill_chunks"] == 4
    assert engine.stats["prefills"] == 1
    oneshot = _engine(np_params, max_prefill_bucket=None,
                      prefill_buckets=(128,), sched_round_budget_tokens=256,
                      sched_prefill_chunk_tokens=None)
    assert _drive(oneshot, [oneshot.submit(prompt, _greedy(10))]) == got
    assert oneshot.stats["prefill_chunks"] == 0
    (want,), _ = _jax_tokens(jax_params, [[(prompt, 10)]])
    assert got == want


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32-pool",
                                                        "int8-pool"])
def test_warm_hit_and_cow_match_cold_and_jax(jax_params, np_params,
                                             kv_quant):
    """A follow-up sharing 3 pages of a 70-token prompt maps them from the
    cache and prefills the rest; a page-aligned 64-token prompt sent again
    is fully cached, so its last page is recomputed into a private page
    (COW demotion). Both give the JAX engine's tokens (same prompts, same
    order) and, over a float32 pool, a cold engine's. Over an int8 pool a
    hit reads its prefix back dequantized where a cold one-shot admission
    attends the exact K/V, so the two trajectories may part (as in the
    reference)."""
    first = _prompt(70)
    follow = first[:48] + _prompt(30, salt=5)[1:]
    aligned = _prompt(64, salt=9)
    engine = _engine(np_params, kv_quant=kv_quant)
    runs = [[(first, 8)], [(follow, 8)], [(aligned, 8)], [(aligned, 8)]]
    got = [_drive(engine, [engine.submit(p, _greedy(m)) for p, m in batch])
           for batch in runs]
    engine._step()                        # releases the last slot
    st = engine.stats
    assert st["active_slots"] == 0 and st["prefix_cache_hits"] == 2
    assert st["prefix_cache_hit_tokens"] == 48 + 48
    assert st["free_pages"] == st["pool_pages"]
    for batch, tokens in zip(runs[1:], got[1:] if not kv_quant else []):
        cold = _engine(np_params, prefix_cache=False)
        assert _drive(cold, [cold.submit(p, _greedy(m))
                             for p, m in batch]) == tokens
    want, jstats = _jax_tokens(jax_params, runs, kv_quant=kv_quant)
    assert got == want
    assert jstats["prefix_cache_hit_tokens"] == st["prefix_cache_hit_tokens"]


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32-pool",
                                                        "int8-pool"])
def test_long_prompt_chunks_behind_a_decoding_slot(jax_params, np_params,
                                                   kv_quant):
    """A 110-token prompt arrives while a short request decodes: it is
    admitted in chunks that share rounds with the decode rounds, and both
    requests' tokens equal the JAX engine's."""
    short, long_ = _prompt(12, salt=3), _prompt(110, salt=4)
    engine = _engine(np_params, kv_quant=kv_quant)
    a = engine.submit(short, _greedy(16))
    engine._step()
    engine._step()
    assert len(a.token_ids) > 1
    b = engine.submit(long_, _greedy(6))
    got = _drive(engine, [a, b])
    st = engine.stats
    # Decode takes 4 tokens of each round's budget of 32: the prompt goes
    # in page-quantized chunks of 16 beside the decode rounds.
    assert st["prefill_chunks"] >= 4
    assert st["sched_interleaved_rounds"] >= 3
    assert st["sched_prefill_tokens"] == len(short) + len(long_)
    want, _ = _jax_tokens(jax_params, [[(short, 16), (long_, 6)]],
                          kv_quant=kv_quant)
    assert got == want[0]


@pytest.mark.parametrize("prefix", [0, 256])
def test_profile_chunk_mode_on_cpu(prefix, capsys):
    """``tools/profile_decode --chunk C --prefix P`` serves the prefix,
    admits the longer prompt, and times its first chunk extension ("seed"
    after a cached prefix, "replace" without one); on the CPU no device
    time is reported."""
    import json

    from generativeaiexamples_tpu_torch.tools import profile_decode
    assert profile_decode.main([
        "--model", "llama-tiny", "--device", "cpu", "--chunk", "128",
        "--prefix", str(prefix), "--rounds", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["chunk"], out["prefix"]) == (128, prefix)
    assert out["mode"] == ("seed" if prefix else "replace")
    assert out["card"] == "cpu" and out["chunk_ms"] > 0
    assert out["device_ms"] == 0
