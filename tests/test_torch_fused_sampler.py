"""The port's fused vocab-tiled sampling tail (``ops/fused_sampler.py``,
``llama.lm_head_tile`` and the engine's fused decode round) against the
JAX package on the CPU.

The reference keys each tile's Gumbel noise on ``fold_in(key, t)``; the
port takes its noise as an argument, so these tests hand it the
reference's own field (``tiled_gumbel``, computed by the JAX package),
tile by tile. Given identical logits and identical noise the two fused
samplers, and both materialized oracles, return exactly the same tokens
and verdicts. Tolerances: ``lm_head_tile`` float32 rtol 1e-5 (raw, tied,
int8 heads; the frameworks' summation orders differ), atol 1e-4 * max|ref|
for int4 heads; the generator-driven sampler within a total-variation
distance of 0.06 of the oracle's distribution over 4000 draws (the
reference's own bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import (GOLDEN_TINY,
                                                           LLAMA_TINY)
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.ops import fused_sampler as tfs
from generativeaiexamples_tpu_torch.ops import sampling as tsamp
from generativeaiexamples_tpu_torch.utils.errors import ConfigError

# The reference test's two mixes of greedy (temp 0 / top_k 1), top-k,
# top-p and pure-temperature rows (tests/test_fused_sampler.py).
MIXES = [([0.8, 1.3, 0.0, 1.0], [0, 5, 1, 0], [0.0, 0.0, 0.0, 0.9]),
         ([1.0, 1.0, 0.7, 2.0], [3, 1, 0, 8], [0.9, 0.0, 0.95, 0.5])]
REP_PEN = [1.0, 1.4, 1.1, 1.2]
BAN_TOK = [[3, 7], [0, 0], [50, 2], [9, 9]]
BAN_HIT = [[True, False], [False, False], [True, True], [False, True]]


def _case(B, V, seed, sharp=1.0, grid=0.0):
    """numpy logits (B, V) (rounded to a ``grid`` when given, so values
    tie), seen and banned masks, and a JAX key."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * sharp).astype(np.float32)
    if grid:
        logits = (np.round(logits / grid) * grid).astype(np.float32)
    seen = rng.random((B, V)) < 0.3
    banned = rng.random((B, V)) < 0.05
    return logits, seen, banned, jax.random.key(seed)


def _jax_field(key, B, V, tile):
    from generativeaiexamples_tpu.ops.fused_sampler import tiled_gumbel
    return np.array(tiled_gumbel(key, B, V, tile))


def _noise(field, tile):
    """The port's noise_tile over a (B, V) numpy field."""
    return lambda t: torch.from_numpy(field[:, t * tile:(t + 1) * tile])


def _knobs(temp, top_k, top_p, rep_pen):
    jk = dict(temp=jnp.asarray(temp, jnp.float32),
              top_k=jnp.asarray(top_k, jnp.int32),
              top_p=jnp.asarray(top_p, jnp.float32),
              rep_pen=jnp.asarray(rep_pen, jnp.float32))
    tk = dict(temp=torch.tensor(temp, dtype=torch.float32),
              top_k=torch.tensor(top_k, dtype=torch.int32),
              top_p=torch.tensor(top_p, dtype=torch.float32),
              rep_pen=torch.tensor(rep_pen, dtype=torch.float32))
    return jk, tk


def _penalized(logits, seen, banned, rep_pen, ban_tok=None, ban_hit=None):
    """The materialized penalize step, in numpy (the oracles' input)."""
    pen = np.asarray(rep_pen, np.float32)[:, None]
    out = np.where(seen, np.where(logits > 0, logits / pen, logits * pen),
                   logits).astype(np.float32)
    out[banned] = tsamp.NEG_INF
    if ban_tok is not None:
        for b, (toks, hits) in enumerate(zip(ban_tok, ban_hit)):
            for t, h in zip(toks, hits):
                if h:
                    out[b, t] = tsamp.NEG_INF
    return out


def _both(logits, seen, banned, key, temp, top_k, top_p, rep_pen, tile,
          cand_k, ban=True, greedy=False):
    """The JAX and the port fused samplers on the same logits and the
    same noise, and both oracles; returns the four token arrays."""
    from generativeaiexamples_tpu.ops import fused_sampler as jfs
    from generativeaiexamples_tpu.ops.sampling import pack_mask as jpack
    B, V = logits.shape
    jk, tk = _knobs(temp, top_k, top_p, rep_pen)
    jl = jnp.asarray(logits)
    ban_tok = BAN_TOK[:B] if ban else None
    ban_hit = BAN_HIT[:B] if ban else None
    jban = dict(ban_tok=jnp.asarray(ban_tok, jnp.int32),
                ban_hit=jnp.asarray(ban_hit)) if ban else {}
    tban = dict(ban_tok=torch.tensor(ban_tok, dtype=torch.int32),
                ban_hit=torch.tensor(ban_hit)) if ban else {}
    want = np.asarray(jfs.fused_unembed_sample(
        lambda t0, n: jax.lax.dynamic_slice_in_dim(jl, t0, n, axis=1), V,
        key=key, seen_words=jpack(jnp.asarray(seen)),
        banned_words=jpack(jnp.asarray(banned)), tile=tile, cand_k=cand_k,
        greedy=greedy, **jk, **jban))
    field = _jax_field(key, B, V, tile)
    tl = torch.from_numpy(logits)
    got = tfs.fused_unembed_sample(
        lambda t0, n: tl[:, t0:t0 + n], V, noise=_noise(field, tile),
        seen_words=tsamp.pack_mask(torch.from_numpy(seen)),
        banned_words=tsamp.pack_mask(torch.from_numpy(banned)), tile=tile,
        cand_k=cand_k, greedy=greedy, **tk, **tban).numpy()
    pen = _penalized(logits, seen, banned, rep_pen, ban_tok, ban_hit)
    j_oracle = np.asarray(jfs.sample_reference_tiled(
        jnp.asarray(pen), key, jk["temp"], jk["top_k"], jk["top_p"], tile))
    t_oracle = tfs.sample_reference_tiled(
        torch.from_numpy(pen), torch.from_numpy(field), tk["temp"],
        tk["top_k"], tk["top_p"], tile).numpy()
    return got, want, t_oracle, j_oracle


@pytest.mark.parametrize("V,tile", [(512, 64), (32000, 4000)])
@pytest.mark.parametrize("mix", [0, 1])
def test_fused_matches_jax_and_oracles(V, tile, mix):
    """Identical logits and noise: the port's fused tokens equal the JAX
    fused sampler's and both oracles', for mixed greedy, top-k, top-p and
    pure-temperature rows with penalties and both ban forms (cand_k = V:
    exact for any truncation width)."""
    temp, top_k, top_p = MIXES[mix]
    logits, seen, banned, key = _case(4, V, seed=1 + mix)
    got, want, t_or, j_or = _both(logits, seen, banned, key, temp, top_k,
                                  top_p, REP_PEN, tile, cand_k=V)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t_or)
    np.testing.assert_array_equal(t_or, j_or)


def test_candidate_carry_truncates_like_jax():
    """A top-p set wider than cand_k (flat logits, p = 0.95, cand_k = 8):
    both fused samplers cut it at the same 8 candidates and draw the same
    tokens; where the prefix fits (top_k 4) they equal the oracle."""
    logits, seen, banned, key = _case(4, 512, seed=7, sharp=0.3)
    temp, top_k, top_p = [1.0, 0.9, 1.2, 1.0], [0, 0, 4, 0], \
        [0.95, 0.99, 0.0, 0.9]
    got, want, t_or, _ = _both(logits, seen, banned, key, temp, top_k,
                               top_p, REP_PEN, 64, cand_k=8)
    np.testing.assert_array_equal(got, want)
    assert got[2] == t_or[2]


@pytest.mark.parametrize("greedy", [False, True])
def test_ties_keep_the_lowest_ids(greedy):
    """Logits on a 0.25 grid tie everywhere: the candidate merge and the
    running argmax keep the reference's order (carry first, ascending id),
    so top-k cuts and greedy picks agree with JAX and the oracles."""
    logits, seen, banned, key = _case(4, 512, seed=3, sharp=2.0, grid=0.25)
    temp, top_k, top_p = [0.7, 1.0, 0.0, 1.5], [3, 6, 1, 2], \
        [0.0, 0.8, 0.0, 0.0]
    got, want, t_or, j_or = _both(logits, seen, banned, key, temp, top_k,
                                  top_p, [1.0] * 4, 64, cand_k=16,
                                  ban=False, greedy=greedy)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_or, j_or)
    if greedy:
        pen = _penalized(logits, seen, banned, [1.0] * 4)
        np.testing.assert_array_equal(got, pen.argmax(-1))
    else:
        np.testing.assert_array_equal(got, t_or)


def test_tied_top_values_across_tiles_keep_the_lowest_ids():
    """24 tokens share the top value, 3 in each of 8 tiles, and the carry
    holds 8: the merge must keep the 8 lowest ids (carry first, ascending
    id), and top-k 5 / top-p 0.1 cut that tie group by id, as JAX and the
    oracles do."""
    V, tile = 512, 64
    logits, seen, banned, key = _case(4, V, seed=13)
    logits = np.minimum(logits, 1.0) - 2.0
    top = np.concatenate([t * tile + np.array([5, 30, 61])
                          for t in range(V // tile)])
    logits[:, top] = 3.0
    seen[:] = False
    banned[:] = False
    temp, top_k, top_p = [1.0, 0.8, 1.0, 1.0], [5, 0, 2, 7], \
        [0.0, 0.1, 0.0, 0.3]
    got, want, t_or, j_or = _both(logits, seen, banned, key, temp, top_k,
                                  top_p, [1.0] * 4, tile, cand_k=8,
                                  ban=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t_or)
    np.testing.assert_array_equal(t_or, j_or)
    assert set(got.tolist()) <= set(top[:7].tolist())


def test_banned_tiles_and_tiny_temperature_agree_with_jax():
    """A row whose first tiles are all banned (-1e30, finite) and a row at
    temp 1e-6 (scaled values near -1e36): the logaddexp carry, the strict
    updates and the finalizer's exp(cv - lse) agree with JAX there."""
    logits, seen, banned, key = _case(3, 512, seed=11)
    banned[0, :448] = True
    temp, top_k, top_p = [1.0, 1e-6, 0.8], [0, 0, 5], [0.9, 0.0, 0.0]
    got, want, t_or, _ = _both(logits, seen, banned, key, temp, top_k,
                               top_p, [1.0, 1.2, 1.0], 64, cand_k=64,
                               ban=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, t_or)
    assert got[0] >= 448


def test_verify_verdicts_match_jax_and_oracles():
    """``fused_verify_sample`` against the JAX function and both
    ``verify_reference_tiled`` oracles: exact accept flags and tokens,
    for drafts that are the argmax, random, banned or absent (-1)."""
    from generativeaiexamples_tpu.ops import fused_sampler as jfs
    from generativeaiexamples_tpu.ops.sampling import pack_mask as jpack
    V, tile, R = 512, 64, 6
    logits, seen, banned, key = _case(R, V, seed=5, sharp=2.0)
    temp = [1.0, 0.7, 0.0, 1.3, 1.0, 0.9]
    top_k, top_p = [0, 5, 1, 0, 20, 0], [0.0, 0.0, 0.0, 0.9, 0.0, 0.8]
    rep_pen = [1.0, 1.2, 1.0, 1.1, 1.0, 1.3]
    pen = _penalized(logits, seen, banned, rep_pen)
    draft = pen.argmax(-1).astype(np.int32)
    draft[1] = 17
    draft[3] = -1
    draft[4] = int(np.flatnonzero(banned[4])[0])
    u = np.random.default_rng(5).random(R).astype(np.float32)
    jk, tk = _knobs(temp, top_k, top_p, rep_pen)
    jl = jnp.asarray(logits)
    ja, jt = jfs.fused_verify_sample(
        lambda t0, n: jax.lax.dynamic_slice_in_dim(jl, t0, n, axis=1), V,
        key=key, u=jnp.asarray(u), seen_words=jpack(jnp.asarray(seen)),
        banned_words=jpack(jnp.asarray(banned)),
        draft_ids=jnp.asarray(draft), tile=tile, cand_k=V, **jk)
    field = _jax_field(key, R, V, tile)
    tl = torch.from_numpy(logits)
    ta, tt = tfs.fused_verify_sample(
        lambda t0, n: tl[:, t0:t0 + n], V, noise=_noise(field, tile),
        u=torch.from_numpy(u), seen_words=tsamp.pack_mask(
            torch.from_numpy(seen)),
        banned_words=tsamp.pack_mask(torch.from_numpy(banned)),
        draft_ids=torch.from_numpy(draft), tile=tile, cand_k=V, **tk)
    oa, ot = tfs.verify_reference_tiled(
        torch.from_numpy(pen), torch.from_numpy(field), torch.from_numpy(u),
        tk["temp"], tk["top_k"], tk["top_p"], torch.from_numpy(draft), tile)
    joa, jot = jfs.verify_reference_tiled(
        jnp.asarray(pen), key, jnp.asarray(u), jk["temp"], jk["top_k"],
        jk["top_p"], jnp.asarray(draft), tile)
    for a, t in ((ta, tt), (oa, ot)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(np.asarray(joa), np.asarray(ja))
    np.testing.assert_array_equal(np.asarray(jot), np.asarray(jt))
    assert not ta[4] and ta[2]


def test_choose_tile_and_the_engine_refuse_one_tile_streams():
    """The reference's tile choice; a one-tile stream over a vocab that 32
    divides is refused, never taken as a fallback."""
    assert tfs.choose_tile(32000, 4096) == 4000
    assert tfs.choose_tile(32000, None) == 4000
    assert tfs.choose_tile(32000, 16000) == 16000
    assert tfs.choose_tile(4096, 512) == 512
    assert tfs.choose_tile(264, 4096) == 264       # 32 does not divide
    assert tfs.choose_tile(128, 50) == 32
    with pytest.raises(ConfigError, match="mask word"):
        tfs.choose_tile(32000, 16)
    params = llama.init_params(GOLDEN_TINY, seed=0, dtype=torch.float32)
    kw = dict(max_slots=2, max_input_length=32, max_output_length=8,
              prefill_buckets=(32,), page_size=16, dtype="float32",
              kv_pool_tokens=None)
    for tile in (32000, 40000):
        with pytest.raises(ConfigError, match="one tile"):
            Engine(params, GOLDEN_TINY, ByteTokenizer(),
                   EngineConfig(**kw, sampler_tile=tile), device="cpu")
    eng = Engine(params, GOLDEN_TINY, ByteTokenizer(),
                 EngineConfig(**kw, sampler_tile=8000), device="cpu")
    assert eng._sampler_tile == 8000
    with pytest.raises(ConfigError, match="sampler_cand_k"):
        EngineConfig(sampler_cand_k=0)


# ------------------------------------------------------------ lm_head_tile

def _head_trees(mode: str, D: int, V: int):
    """A JAX parameter tree holding one head storage, and the port's."""
    from generativeaiexamples_tpu.ops.quant import quantize_params
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    embed = (rng.standard_normal((V, D)) / np.sqrt(D)).astype(np.float32)
    tree = {"embed": jnp.asarray(embed), "layers": {}}
    if mode != "tied":
        tree["lm_head"] = jnp.asarray(w)
    if mode in ("int8", "int4", "int4_awq", "awq_pre_scale"):
        q = quantize_params(tree, "int4_awq" if mode == "awq_pre_scale"
                            else mode, 32)
        tree["lm_head"] = q["lm_head"]
        if mode == "awq_pre_scale":
            tree["lm_head"] = dict(tree["lm_head"], pre_scale=jnp.asarray(
                rng.uniform(0.5, 2.0, D).astype(np.float32)))
    ours = {"embed": torch.from_numpy(embed)}
    if "lm_head" in tree:
        head = tree["lm_head"]
        ours["lm_head"] = ({k: torch.from_numpy(np.array(v))
                            for k, v in head.items()}
                           if isinstance(head, dict)
                           else torch.from_numpy(np.array(head)))
    return tree, ours


@pytest.mark.parametrize("mode", ["raw", "tied", "int8", "int4", "int4_awq",
                                  "awq_pre_scale"])
def test_lm_head_tile_matches_jax(mode):
    """Every head storage, tile by tile, against the JAX ``lm_head_tile``
    (float32 rtol 1e-5 raw/tied/int8; int4 atol 1e-4 * max|ref|), and the
    tiles together equal the whole projection; the AWQ pre_scale applied
    once (``lm_head_input``) gives the same tiles."""
    from generativeaiexamples_tpu.models import llama as jllama
    D, V, tile = 64, 512, 64
    tree, ours = _head_trees(mode, D, V)
    hn = np.random.default_rng(1).standard_normal((3, D)).astype(np.float32)
    th = torch.from_numpy(hn)
    pre = llama.lm_head_input(ours, th)
    tiles = []
    for t0 in range(0, V, tile):
        want = np.asarray(jllama.lm_head_tile(tree, None, jnp.asarray(hn),
                                              jnp.int32(t0), tile))
        got = llama.lm_head_tile(ours, GOLDEN_TINY, th, t0, tile).numpy()
        once = llama.lm_head_tile(ours, GOLDEN_TINY, pre, t0, tile,
                                  prescaled=True).numpy()
        assert got.shape == (3, tile) and got.dtype == np.float32
        if mode.startswith(("int4", "awq")):
            atol = 1e-4 * np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(once, got)
        tiles.append(got)
    np.testing.assert_allclose(np.concatenate(tiles, axis=1),
                               llama.project_logits(ours, th).numpy(),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------- sampling distribution

@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.8)],
                         ids=["temperature", "top_k", "top_p"])
def test_generator_draws_follow_the_oracle_distribution(top_k, top_p):
    """4000 draws of the generator-driven fused sampler at V = 64 (two
    tiles) lie within a total-variation distance of 0.06 of the oracle's
    probabilities (softmax over the kept set)."""
    V, N = 64, 4000
    row = torch.randn(V, generator=torch.Generator().manual_seed(0)) * 1.5
    logits = row.expand(N, V).contiguous()
    temp = torch.full((N,), 0.9)
    kw = dict(top_k=torch.full((N,), top_k, dtype=torch.int32),
              top_p=torch.full((N,), top_p), rep_pen=torch.ones(N),
              seen_words=torch.zeros((N, 2), dtype=torch.int64),
              banned_words=torch.zeros((N, 2), dtype=torch.int64))
    gen = torch.Generator().manual_seed(1)
    toks = tfs.fused_unembed_sample(lambda t0, n: logits[:, t0:t0 + n], V,
                                    noise=gen, temp=temp, tile=32, **kw)
    scaled = (row / 0.9)[None]
    keep = tfs._reference_keep(scaled, kw["top_k"][:1], kw["top_p"][:1])[0]
    p = torch.softmax(scaled[0].masked_fill(~keep, float("-inf")), dim=-1)
    emp = torch.bincount(toks.long(), minlength=V).float() / N
    tv = 0.5 * (emp - p).abs().sum().item()
    assert tv < 0.06, tv
    assert keep[toks.long()].all()


@pytest.mark.parametrize("device", ["cpu"])
def test_sample_keeps_the_lowest_ids_at_ties(device):
    """Four equal top logits with top_k = 2: the stable sort keeps ids 0
    and 1, as ``jnp.argsort`` does, so no draw is ever 2 or 3."""
    from generativeaiexamples_tpu.ops.sampling import sample as jsample
    N = 2000
    logits = torch.full((N, 16), -3.0)
    logits[:, :4] = 2.0
    toks = tsamp.sample(logits.to(device), torch.ones(N, device=device),
                        torch.full((N,), 2, dtype=torch.int32,
                                   device=device),
                        torch.zeros(N, device=device),
                        torch.Generator(device).manual_seed(0)).cpu()
    assert set(toks.tolist()) == {0, 1}
    jt = np.asarray(jsample(jnp.asarray(logits.numpy()), jax.random.key(0),
                            jnp.ones(N), jnp.full(N, 2, jnp.int32),
                            jnp.zeros(N)))
    assert set(jt.tolist()) == {0, 1}


# ------------------------------------------------------------ the engine

ENGINE_KW = dict(max_slots=4, max_input_length=64, max_output_length=32,
                 prefill_buckets=(16, 32, 64), dtype="float32", max_queue=64,
                 page_size=16)
PROMPTS = ["hello", "a somewhat longer prompt that spans pages",
           "x", "0123456789abcdefghij", "the quick brown fox"]


@pytest.fixture(scope="module")
def tiny():
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    jp = jllama.init_params(JCFG, jax.random.key(11), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(tree, "cpu", torch.float32, cfg=LLAMA_TINY)


def _drive(engine, streams, limit=400):
    for _ in range(limit):
        if all(s.finish_reason is not None for s in streams):
            return [s.token_ids for s in streams]
        engine._step()
    raise AssertionError("requests did not finish")


def test_fused_engine_matches_jax_and_the_materialized_engine(tiny):
    """Greedy requests with repetition penalties and bad words (single
    bytes and multi-byte sequences) through the fused port engine, the
    materialized one (``fused_tail=False``) and the JAX ``Engine``
    (float32): equal tokens."""
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    jp, params = tiny
    tok = ByteTokenizer()
    lens = [12, 7, 20, 3, 9]
    knobs = [dict(repetition_penalty=1.3), dict(bad_words=["e", "th"]),
             {}, dict(repetition_penalty=0.8, bad_words=["ab"]), {}]
    runs = {}
    for fused in (True, False):
        eng = Engine(params, LLAMA_TINY, tok, EngineConfig(
            **ENGINE_KW, fused_tail=fused), device="cpu")
        streams = [eng.submit(tok.encode(p), SamplingParams(
            max_tokens=n, top_k=1, ignore_eos=True, **k))
            for p, n, k in zip(PROMPTS, lens, knobs)]
        runs[fused] = _drive(eng, streams)
        assert (eng.stats["sampler_rows_sampled"] > 0) == fused
    with JEngine(jp, JCFG, JTok(), JConfig(**ENGINE_KW)) as jeng:
        js = [jeng.submit(tok.encode(p), JParams(
            max_tokens=n, top_k=1, ignore_eos=True, **k))
            for p, n, k in zip(PROMPTS, lens, knobs)]
        for s in js:
            s.text()
        theirs = [s.token_ids for s in js]
    assert runs[True] == runs[False] == theirs
    assert all(len(t) == n for t, n in zip(theirs, lens))


def test_golden_chunks_and_prefix_hit_match_jax():
    """golden-tiny (trained, the 32k vocabulary: 8 tiles of 4000): a
    prompt admitted in chunks, then a follow-up that hits its cached
    prefix; the fused port engine, the materialized one and the JAX
    ``Engine`` give equal greedy tokens."""
    import os

    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    from generativeaiexamples_tpu.models.configs import GOLDEN_TINY as JCFG
    from generativeaiexamples_tpu.models.import_hf import \
        load_checkpoint as jload
    from generativeaiexamples_tpu_torch.models.import_hf import \
        load_checkpoint
    from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer
    golden = os.path.join(os.path.dirname(__file__), "fixtures",
                          "golden_tiny")
    tok = get_tokenizer(golden)
    params = load_checkpoint(golden, GOLDEN_TINY, dtype=torch.float32,
                             device="cpu")
    kw = dict(max_slots=2, max_input_length=128, max_output_length=16,
              prefill_buckets=(32, 128), page_size=16, dtype="float32",
              kv_pool_tokens=None, max_prefill_bucket=32,
              sched_round_budget_tokens=64)
    first = tok.encode("Paged KV caching shares pages between requests "
                       "that start with the same system prompt, so the "
                       "second request " * 3)
    follow = first[:40] + tok.encode(" Continuous batching admits")[1:]
    runs = {}
    for fused in (True, False):
        eng = Engine(params, GOLDEN_TINY, tok, EngineConfig(
            **kw, fused_tail=fused), device="cpu")
        assert eng._sampler_tile == 4000
        got = [_drive(eng, [eng.submit(p, SamplingParams(
            max_tokens=10, top_k=1, ignore_eos=True))])[0]
            for p in (first, follow)]
        assert eng.stats["prefill_chunks"] >= 3
        assert eng.stats["prefix_cache_hit_tokens"] == 32
        runs[fused] = got
    with JEngine(jload(golden, JCFG, dtype=jnp.float32), JCFG, tok,
                 JConfig(**kw)) as jeng:
        theirs = []
        for p in (first, follow):
            s = jeng.submit(p, JParams(max_tokens=10, top_k=1,
                                       ignore_eos=True))
            s.text()
            theirs.append(s.token_ids)
    assert runs[True] == runs[False] == theirs


def test_ladder_rungs_and_row_counts(tiny):
    """One stream decodes on the ba = 1 rung, three on ba = B: the rows
    sampled and skipped count as the reference counts them (rung x steps,
    and max_slots less the rung x steps), and the materialized tail
    leaves both at 0."""
    _, params = tiny
    tok = ByteTokenizer()
    for n_streams, ba in ((1, 1), (3, 4)):
        eng = Engine(params, LLAMA_TINY, tok, EngineConfig(**ENGINE_KW),
                     device="cpu")
        rungs = []
        run = eng._decode_round
        eng._decode_round = lambda steps, greedy, ba: (
            rungs.append(ba), run(steps, greedy, ba))[1]
        _drive(eng, [eng.submit(tok.encode(p), SamplingParams(
            max_tokens=9, top_k=1, ignore_eos=True))
            for p in PROMPTS[:n_streams]])
        st = eng.stats
        assert set(rungs) == {ba}
        assert st["sampler_rows_sampled"] == ba * st["decode_steps"]
        assert st["sampler_rows_skipped"] == (4 - ba) * st["decode_steps"]
    eng = Engine(params, LLAMA_TINY, tok, EngineConfig(
        **ENGINE_KW, fused_tail=False), device="cpu")
    _drive(eng, [eng.submit(tok.encode("x"), SamplingParams(
        max_tokens=5, top_k=1, ignore_eos=True))])
    assert eng._ba_ladder == (4,)
    assert eng.stats["sampler_rows_sampled"] == 0
    assert eng.stats["sampler_rows_skipped"] == 0


def test_stream_armed_while_others_decode_joins_act_idx(tiny):
    """A request admitted while another decodes is in ``act_idx`` from its
    first round (the round after the chunk that armed it), moves the
    round to the ba = B rung, and its tokens equal the materialized
    engine's (a slot missing from ``act_idx`` would decode token 0)."""
    _, params = tiny
    tok = ByteTokenizer()
    runs = {}
    for fused in (True, False):
        eng = Engine(params, LLAMA_TINY, tok, EngineConfig(
            **ENGINE_KW, fused_tail=fused), device="cpu")
        seen = []
        run = eng._decode_round

        def spy(steps, greedy, ba, eng=eng, run=run, seen=seen):
            act = eng._state["act_idx"][:ba].tolist()
            seen.append((sorted(eng._armed()), act))
            return run(steps, greedy, ba)
        eng._decode_round = spy
        a = eng.submit(tok.encode(PROMPTS[1]), SamplingParams(
            max_tokens=30, top_k=1, ignore_eos=True))
        for _ in range(2):
            eng._step()
        assert len(a.token_ids) > 1
        b = eng.submit(tok.encode(PROMPTS[3]), SamplingParams(
            max_tokens=8, top_k=1, ignore_eos=True))
        runs[fused] = _drive(eng, [a, b])
        if fused:
            assert len(seen[0][0]) == 1 and seen[0][1] == seen[0][0]
            both = [s for s in seen if len(s[0]) == 2]
            assert both, seen
            for armed, act in both:
                assert act[:2] == armed and all(i == 4 for i in act[2:])
    assert runs[True] == runs[False]


# ------------------------------------------------------- no (B, V) tensor

class _Shapes(TorchDispatchMode):
    """Records the shape of every op's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append((func.__name__, tuple(t.shape)))
        return out


@pytest.mark.parametrize("greedy", [True, False])
def test_fused_round_never_materializes_the_vocab(greedy):
    """Every op of one fused decode round (golden-tiny geometry, V =
    32000, random weights) outputs tensors without a V-sized dimension;
    the materialized round does make (B, V) tensors, so the walk can
    fail."""
    params = llama.init_params(GOLDEN_TINY, seed=0, dtype=torch.float32)
    tok = ByteTokenizer()
    V = GOLDEN_TINY.vocab_size
    found = {}
    for fused in (True, False):
        eng = Engine(params, GOLDEN_TINY, tok, EngineConfig(
            max_slots=2, max_input_length=32, max_output_length=16,
            prefill_buckets=(32,), page_size=16, dtype="float32",
            kv_pool_tokens=None, fused_tail=fused), device="cpu")
        eng.submit(tok.encode("hello"), SamplingParams(
            max_tokens=8, temperature=0 if greedy else 0.8, top_k=0,
            top_p=0.9, repetition_penalty=1.1, ignore_eos=True,
            bad_words=["ab"]))
        eng._step()                    # admits; the next round decodes
        with _Shapes() as mode:
            eng._round_body(2, greedy, eng._ba_for(1))
        found[fused] = [s for s in mode.shapes if V in s[1]]
        assert mode.shapes
    assert found[True] == [], found[True][:5]
    assert found[False]


@pytest.mark.parametrize("materialized", [False, True],
                         ids=["fused", "materialized"])
def test_profile_decode_times_the_sampler_on_cpu(materialized, capsys):
    """``tools/profile_decode`` (its CPU rehearsal) times the tail alone,
    fused at every rung and tile and materialized, on an engine built
    with either tail; the sampler tile is left as it was."""
    import json

    from generativeaiexamples_tpu_torch.tools import profile_decode
    argv = ["--model", "llama-tiny", "--device", "cpu", "--slots", "2",
            "--prompt-len", "16", "--steps", "2", "--rounds", "1",
            "--tail-tiles", "128,256"]
    assert profile_decode.main(
        argv + (["--materialized-tail"] if materialized else [])) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tails = out["sampler"]
    assert [(t["rows"], t["greedy"], t["tile"]) for t in tails] == [
        (2, True, 512), (1, True, 512), (2, False, 512), (1, False, 512),
        (2, True, None), (2, False, None), (2, False, 128),
        (2, False, 256)]
    assert all(t["ms"] > 0 for t in tails)
    assert out["sampler_traced"]["fused"] is not materialized
