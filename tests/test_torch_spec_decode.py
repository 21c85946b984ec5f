"""Speculative decoding in the port (``engine/spec_decode.py``,
``models/llama.py`` ``apply_verify_paged`` and the engine's verify round)
against the JAX package on the CPU.

- The drafter and the draft-length controller: the reference's cases,
  and the same proposals as the reference's drafter on random contexts.
- ``apply_verify_paged`` on the same numpy inputs as the JAX function,
  over float32 and int8 pools, with rows past a slot's drafts (rejected
  or padding rows) written to the trash page. Tolerances, set from the
  dtype: float32 logits atol 1e-4; pool rows atol 1e-5; int8 codes within
  1 and bf16 scales within one ulp (``quantize_rows`` of inputs that
  differ in the last float32 bits).
- The engine: greedy speculative decoding gives the port's plain engine's
  tokens exactly, and, driven in lockstep (each plan made with every
  output read back), the JAX spec engine's tokens, drafts and accepted
  counts, over an open-loop burst, a warm prefix and a fused-RAG
  request; a stop word in mid-burst; sampled requests keep their length,
  and the first token a sampled verify round emits follows the model's
  distribution (total variation bound as in ``test_torch_fused_sampler``).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.engine.scheduler import StepCostModel
from generativeaiexamples_tpu_torch.engine.spec_decode import (
    AdaptiveDraftController, PromptLookupDrafter, SpecConfig, spec_enabled)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

from generativeaiexamples_tpu.engine import spec_decode as jspec

CFG_KW = dict(vocab_size=259 + 5, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
              max_position_embeddings=1024)
CFG = LlamaConfig(**CFG_KW)
# The reference test's engine, with the budget pinned on both sides (the
# JAX engine's unpinned budget follows its host-timed calibrator).
ENGINE_KW = dict(max_slots=4, max_input_length=96, max_output_length=32,
                 prefill_buckets=(16, 32, 96), page_size=16,
                 dtype="float32", max_queue=64, sched_round_budget_tokens=64)
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch, tmp_path):
    """No spec or calibration knobs from the environment; the JAX engine's
    cost prior is the port's default model (a verify position priced as a
    prefill token on both sides)."""
    for name in ("ENGINE_SPEC_DECODE", "SPEC_MAX_DRAFT_TOKENS",
                 "SPEC_MIN_DRAFT_TOKENS", "SPEC_NGRAM_MAX", "SPEC_NGRAM_MIN",
                 "SPEC_ADAPT", "KV_HOST_POOL_TOKENS",
                 "ENGINE_WATCHDOG_STALL_S"):
        monkeypatch.delenv(name, raising=False)
    prof = tmp_path / "PROFILE_default.json"
    prof.write_text('{"full_ms_per_step": 2.0, "slots": 8, '
                    '"prefill_ms_per_token": 0.125}')
    monkeypatch.setenv("SCHED_PROFILE_JSON", str(prof))
    monkeypatch.setenv("SCHED_ONLINE_CALIB", "0")


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's copy)."""
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    jparams = jllama.init_params(JL(**CFG_KW), jax.random.key(7),
                                 dtype=jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu", torch.float32, cfg=CFG)


def _engine(params, spec, cfg=CFG, **kw):
    return Engine(params[1], cfg, ByteTokenizer(), EngineConfig(
        **{**ENGINE_KW, "spec_decode": spec, **kw}), device="cpu")


def _jax_engine(params, spec, cfg_kw=CFG_KW, **kw):
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    return JEngine(params[0], JL(**cfg_kw), JTok(), JConfig(
        **{**ENGINE_KW, "spec_decode": spec, **kw}))


def _greedy(n, sp=SamplingParams, **kw):
    return sp(max_tokens=n, top_k=1, ignore_eos=True, **kw)


def _drive(engine, streams, limit=600):
    """The port engine's serve loop by hand: each ``_step`` reads its
    outputs back before the next plan."""
    for _ in range(limit):
        if all(s.finish_reason is not None for s in streams) \
                and not engine._slots:
            return streams
        engine._step()
    raise AssertionError("requests did not finish")


def _jax_lockstep(jeng, submit, limit=600):
    """The JAX engine's serve loop by hand, in the port's lockstep: its
    harvest worker runs, and each plan waits until every dispatched
    output was read back (so drafts see the same context as the port's
    inline harvest). ``submit(jeng)`` returns the streams, each submitted
    when the previous batch finished."""
    jeng._stopped.clear()
    worker = threading.Thread(target=jeng._harvest_worker, daemon=True)
    jeng._harvest_thread = worker
    worker.start()
    out = []
    try:
        for batch in submit:
            streams = batch(jeng)
            for _ in range(limit):
                if all(s.finish_reason is not None for s in streams) \
                        and not jeng._slots:
                    break
                jeng._drain_completed()
                jeng._pull_pending()
                jeng._cull_backlog()
                jeng._execute_plan(jeng._plan_round())
                deadline = time.monotonic() + TIMEOUT
                while not (jeng._harvest_q.empty()
                           and jeng._queued_rounds() == 0
                           and all(r.done or r.stream.token_ids
                                   for r in jeng._slots.values()
                                   if r.prefill_done)):
                    assert time.monotonic() < deadline, "harvest stalled"
                    time.sleep(0.001)
            else:
                raise AssertionError("requests did not finish")
            out.append(streams)
    finally:
        jeng._stopped.set()
        worker.join(TIMEOUT)
        jeng._harvest_thread = None
    return out


def _spec_counts(stats):
    return {k: stats[k] for k in ("spec_draft_tokens", "spec_accepted_tokens",
                                  "spec_verify_rounds", "spec_verify_tokens",
                                  "spec_verify_slot_steps")}


# ------------------------------------------------------------- drafter


def test_drafter_proposes_continuation_of_last_match():
    d = PromptLookupDrafter([1, 2, 3, 4, 5, 1, 2, 3], ngram_max=3)
    # suffix (1, 2, 3) occurred at 0 -> continuation 4, 5, 1, ...
    assert d.propose(2) == [4, 5]
    assert d.propose(10) == [4, 5, 1, 2, 3]


def test_drafter_prefers_longest_ngram():
    d = PromptLookupDrafter([7, 9, 8, 1, 2, 9, 8, 5, 1, 9, 8], ngram_max=3)
    # trigram (1, 9, 8) has no earlier match; bigram (9, 8) -> the most
    # recent earlier one (index 5) -> continuation 5, 1
    assert d.propose(2) == [5, 1]


def test_drafter_no_match_returns_empty():
    d = PromptLookupDrafter([1, 2, 3, 4], ngram_max=3)
    assert d.propose(4) == []
    assert d.propose(0) == []


def test_drafter_recency_and_incremental_extend():
    d = PromptLookupDrafter([1, 2, 10, 1, 2, 20], ngram_max=2)
    d.extend([1, 2])
    assert d.propose(1) == [20]       # most recent (1, 2) match wins
    d.extend([30])
    assert d.propose(3) == []         # (2, 30) never seen before
    assert len(d) == 9


def test_drafter_matches_the_reference_on_random_contexts():
    rng = np.random.default_rng(0)
    for _ in range(200):
        ctx = rng.integers(0, 6, size=int(rng.integers(1, 40))).tolist()
        n_max = int(rng.integers(1, 4))
        mine = PromptLookupDrafter(ctx[:5], ngram_max=n_max)
        ref = jspec.PromptLookupDrafter(ctx[:5], ngram_max=n_max)
        mine.extend(ctx[5:])
        ref.extend(ctx[5:])
        for k in (1, 3, 7):
            assert mine.propose(k) == ref.propose(k)


def test_adaptive_controller_grows_and_shrinks():
    spec = SpecConfig(max_draft_tokens=8, min_draft_tokens=1)
    c = AdaptiveDraftController(spec)
    assert c.k == 8
    c.update(8, 1)            # 12.5% < low -> halve
    assert c.k == 4
    c.update(4, 0)
    assert c.k == 2
    c.update(2, 2)            # 100% >= high -> +1
    assert c.k == 3
    for _ in range(20):
        c.update(c.k, c.k)
    assert c.k == 8           # capped at max
    for _ in range(20):
        c.update(c.k, 0)
    assert c.k == 1           # floored at min
    pinned = AdaptiveDraftController(SpecConfig(max_draft_tokens=5,
                                                adapt=False))
    pinned.update(5, 0)
    assert pinned.k == 5


def test_spec_enabled_and_config_env_precedence(monkeypatch):
    assert spec_enabled(False) is False and spec_enabled(True) is True
    monkeypatch.setenv("ENGINE_SPEC_DECODE", "0")
    assert spec_enabled(True) is False
    monkeypatch.setenv("ENGINE_SPEC_DECODE", "1")
    assert spec_enabled(False) is True
    assert SpecConfig.resolve().max_draft_tokens == 7
    assert SpecConfig.resolve(3).max_draft_tokens == 3
    monkeypatch.setenv("SPEC_MAX_DRAFT_TOKENS", "5")
    monkeypatch.setenv("SPEC_NGRAM_MAX", "2")
    mine, ref = SpecConfig.resolve(3), jspec.SpecConfig.resolve(3)
    assert vars(mine) == vars(ref)
    assert mine.max_draft_tokens == 5 and mine.ngram_max == 2


# ------------------------------------------------- apply_verify_paged


def _verify_inputs(rng, kind, n_pages=12, page=16, B=3, S=4, P=5):
    """Random stale pools, block tables, and verify rows at positions near
    page boundaries; rows past ``n_draft`` (rejected or padding) and an
    inactive slot write the trash page 0."""
    L, KV, hd = CFG.num_layers, CFG.num_kv_heads, CFG.head_dim
    shape = (L, n_pages, KV, page, hd)
    if kind == "int8":
        pools = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "ks": (rng.random(shape[:4]) * 0.02 + 1e-3
                        ).astype(np.float32),
                 "vs": (rng.random(shape[:4]) * 0.02 + 1e-3
                        ).astype(np.float32)}
    else:
        pools = {"k": rng.normal(size=shape).astype(np.float32),
                 "v": rng.normal(size=shape).astype(np.float32)}
    table = np.stack([rng.permutation(np.arange(1, n_pages))[:P]
                      for _ in range(B)]).astype(np.int32)
    pos = np.array([page - 2, 2 * page + 5, 0], np.int32)   # slot 2 idle
    n_draft = np.array([S - 1, 1, 0], np.int32)
    tokens = rng.integers(3, CFG.vocab_size, (B, S)).astype(np.int32)
    offs = np.arange(S, dtype=np.int32)
    positions = pos[:, None] + offs[None, :]
    active = np.array([True, True, False])
    ok = active[:, None] & (offs[None, :] <= n_draft[:, None])
    pages = np.take_along_axis(table, positions // page, axis=1)
    wp = np.where(ok, pages, 0).astype(np.int32)
    return (pools, tokens, positions, table, (pos + S).astype(np.int32), wp,
            (positions % page).astype(np.int32), ok)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_apply_verify_paged_matches_jax(params, kind):
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    rng = np.random.default_rng(3)
    pools, tokens, positions, table, valid, wp, off, ok = _verify_inputs(
        rng, kind)

    def port_pools():
        out = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
        for k in ("ks", "vs"):
            if k in out:
                out[k] = out[k].to(torch.bfloat16)
        return out

    def jax_pools():
        return {k: (jnp.asarray(v, jnp.bfloat16) if k in ("ks", "vs")
                    else jnp.asarray(v)) for k, v in pools.items()}

    t = torch.from_numpy
    mine_pool = port_pools()
    logits, _ = llama.apply_verify_paged(
        params[1], CFG, t(tokens), t(positions), mine_pool, t(table),
        t(valid), t(wp), t(off))
    jlogits, jpool = jllama.apply_verify_paged(
        params[0], JL(**CFG_KW), jnp.asarray(tokens), jnp.asarray(positions),
        jax_pools(), jnp.asarray(table), jnp.asarray(valid), jnp.asarray(wp),
        jnp.asarray(off))
    # The rows of live slots (inactive slot 2's rows are garbage on both
    # sides, and the trash page differs by write order).
    live = ok.any(axis=1)
    np.testing.assert_allclose(logits.numpy()[live],
                               np.asarray(jlogits)[live], atol=1e-4)
    keep = np.ones(pools["k"].shape[1], bool)
    keep[0] = False
    for name in ("k", "v"):
        got = mine_pool[name].numpy()[:, keep]
        want = np.asarray(jpool[name])[:, keep]
        if kind == "int8":
            assert np.abs(got.astype(np.int32)
                          - want.astype(np.int32)).max() <= 1
            gs = mine_pool[name + "s"][:, keep].view(torch.int16).numpy()
            ws = np.asarray(jpool[name + "s"])[:, keep].view(np.int16)
            assert np.abs(gs.astype(np.int32) - ws.astype(np.int32)).max() \
                <= 1
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)
    # Only the written rows changed: every other page row is the input's.
    changed = np.zeros(pools["k"].shape[1:4], bool)
    for b, s in zip(*np.nonzero(ok)):
        changed[wp[b, s], :, off[b, s]] = True
    changed[0] = True
    for name in ("k", "v"):
        assert np.array_equal(pools[name][:, ~changed],
                              mine_pool[name].numpy()[:, ~changed])


# ---------------------------------------------- engine against engines


def _burst_prompts():
    rng = np.random.RandomState(0)
    return [list(rng.randint(4, 200, size=n)) for n in (24, 11, 17, 30, 9,
                                                        21)] + \
        [[9, 10, 11, 12] * 8]


def _submit_all(prompts, sp_cls, n=20, **kw):
    return lambda e: [e.submit(list(p), _greedy(n, sp_cls, **kw))
                      for p in prompts]


def test_greedy_spec_openloop_burst_matches_plain_and_jax(params):
    """A concurrent burst of cold prompts (more requests than slots):
    speculation on gives the plain engine's tokens and, in lockstep, the
    JAX spec engine's tokens, drafts and accepted counts."""
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    prompts = _burst_prompts()
    plain = _engine(params, False)
    base = _drive(plain, _submit_all(prompts, SamplingParams)(plain))
    eng = _engine(params, True)
    got = _drive(eng, _submit_all(prompts, SamplingParams)(eng))
    assert [s.token_ids for s in got] == [s.token_ids for s in base]
    assert [s.text() for s in got] == [s.text() for s in base]
    stats = eng.stats
    assert stats["spec_verify_rounds"] > 0 and stats["spec_draft_tokens"] > 0
    (ref,), = [_jax_lockstep(_jax_engine(params, True),
                             [_submit_all(prompts, JParams)])]
    jeng_tokens = [s.token_ids for s in ref]
    assert [s.token_ids for s in got] == jeng_tokens


def _count_lockstep(params, prompts_batches, spec=True):
    """(port tokens, port spec counts, JAX tokens, JAX spec counts) for
    batches run one after another."""
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    eng = _engine(params, spec)
    mine = []
    for prompts, n in prompts_batches:
        mine.append([s.token_ids for s in _drive(
            eng, _submit_all(prompts, SamplingParams, n)(eng))])
    jeng = _jax_engine(params, spec)
    ref = _jax_lockstep(jeng, [_submit_all(p, JParams, n)
                               for p, n in prompts_batches])
    return (mine, _spec_counts(eng.stats), [[s.token_ids for s in b]
                                            for b in ref],
            _spec_counts(jeng.stats), eng)


def test_greedy_spec_counts_match_the_jax_engine(params):
    """Lockstep, the port's verify rounds draft and accept exactly what the
    JAX engine's do, on a copy-heavy burst."""
    prompts = [[9, 10, 11, 12] * 8, [5, 6, 7] * 9, list(range(20, 44))]
    mine, counts, ref, jcounts, _ = _count_lockstep(params,
                                                    [(prompts, 24)])
    assert mine == ref
    assert counts == jcounts
    assert counts["spec_verify_rounds"] > 0


def test_greedy_spec_chat_warm_prefix(params):
    """Multi-turn history re-submission: turns 2+ admit through the prefix
    cache; the verify rounds stay exact on cache-seeded slots, and the
    JAX engine drafts and accepts the same."""
    turns, history = [], [(7 * i) % 200 + 4 for i in range(48)]
    plain = _engine(params, False)
    for t in range(3):
        prompt = (history + [11 + t, 12, 13])[-90:]
        s, = _drive(plain, [plain.submit(prompt, _greedy(10))])
        turns.append((prompt, list(s.token_ids)))
        history = prompt + s.token_ids
    batches = [([p], 10) for p, _ in turns]
    mine, counts, ref, jcounts, eng = _count_lockstep(params, batches)
    assert [b[0] for b in mine] == [t for _, t in turns] == [b[0]
                                                             for b in ref]
    assert eng.stats["prefix_cache_hit_tokens"] > 0
    assert counts == jcounts


def test_greedy_spec_fused_rag_request(params):
    """A fused-RAG request (its drafter indexes the generated tokens
    only) beside a plain one: the spec engine's tokens and retrieved rows
    are the plain engine's and the JAX spec engine's."""
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    from generativeaiexamples_tpu.engine import rag_fusion as jrag
    from generativeaiexamples_tpu.models import encoder as jenc
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    from generativeaiexamples_tpu_torch.engine.rag_fusion import FusedRagSpec
    from generativeaiexamples_tpu_torch.models import encoder as enc
    from generativeaiexamples_tpu_torch.models.configs import ENCODER_TINY
    kw = dict(max_slots=2, max_input_length=256, max_output_length=32,
              prefill_buckets=(128, 256), kv_pool_tokens=1536, page_size=64,
              steps_per_round=4, sched_round_budget_tokens=256)
    spec_kw = dict(prefix_ids=(1, 10, 11), sep_ids=(12,), mid_ids=(13, 14),
                   suffix_ids=(15,), top_k=2, ctx_budget=40, bucket=128,
                   chunk_tokens=16, q_bucket=16, enc_bucket=32)
    jenc_params = jenc.init_params(JENC, jax.random.key(3),
                                   dtype=jnp.float32)
    enc_params = enc.encoder_params_from_numpy(
        jax.tree.map(np.asarray, jenc_params), ENCODER_TINY)
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(4, ENCODER_TINY.hidden_size)).astype(np.float32)
    toks = np.zeros((4, 16), np.int32)
    lens = np.full((4,), 6, np.int32)
    for i in range(4):
        toks[i, :6] = [50 + i, 60, 61, 50 + i, 60, 61]
    q_enc = [7, 8, 9]

    def port(spec):
        eng = _engine(params, spec, **kw)
        eng.enable_fused_rag(enc_params, ENCODER_TINY, FusedRagSpec(**spec_kw))
        eng.set_rag_corpus(emb, toks, lens)
        f = eng.submit_rag([30, 31], q_enc, _greedy(24))
        p = eng.submit([5, 6, 7, 5, 6, 7], _greedy(16))
        _drive(eng, [f, p])
        return (f.token_ids, f.source_ids, p.token_ids), eng.stats

    (base, _), (got, stats) = port(False), port(True)
    assert got == base
    assert stats["rag_admissions"] == 1 and stats["spec_verify_rounds"] > 0
    jeng = _jax_engine(params, True, **kw)
    jeng.enable_fused_rag(jenc_params, JENC, jrag.FusedRagSpec(**spec_kw))
    jeng.set_rag_corpus(emb, toks, lens)
    (f, p), = _jax_lockstep(jeng, [lambda e: [
        e.submit_rag([30, 31], q_enc, _greedy(24, JParams)),
        e.submit([5, 6, 7, 5, 6, 7], _greedy(16, JParams))]])
    assert (f.token_ids, f.source_ids, p.token_ids) == got
    assert _spec_counts(jeng.stats) == _spec_counts(stats)


def test_stop_word_mid_burst_truncates_exactly(params):
    """A stop word completing inside a verify burst ends the stream where
    the plain engine ends it: same text, same token ids (the burst's
    later tokens dropped), same finish, the slot and pages freed."""
    tok = ByteTokenizer()
    prompt = tok.encode("stop test stop test stop test")
    plain = _engine(params, False)
    free, = _drive(plain, [plain.submit(prompt, _greedy(16))])
    text = free.text()
    assert len(text) >= 6, "scenario needs visible text"
    stop = text[4:6]
    out = {}
    for spec in (False, True):
        eng = _engine(params, spec)
        s, = _drive(eng, [eng.submit(prompt, _greedy(16,
                                                     stop_words=[stop]))])
        out[spec] = (s.text(), list(s.token_ids), s.finish_reason)
        assert not eng._slots
        assert len(eng._free_slots) == eng.cfg.max_slots
    assert out[True][2] == "stop" and stop not in out[True][0]
    assert out[False] == out[True]


def test_env_zero_restores_plain_decode_path(params, monkeypatch):
    prompt = [9, 10, 11, 12] * 6
    base, = _drive(_e := _engine(params, False),
                   [_e.submit(prompt, _greedy(12))])
    monkeypatch.setenv("ENGINE_SPEC_DECODE", "0")
    eng = _engine(params, True)
    assert eng._spec is None and not eng._verify_graphs
    s, = _drive(eng, [eng.submit(prompt, _greedy(12))])
    assert eng.stats["spec_verify_rounds"] == 0
    assert s.token_ids == base.token_ids


def test_nondraftable_workload_keeps_pipelined_classic_rounds(params):
    """With a round in flight, a slot with nothing to draft lets the next
    classic round go out (the pipeline stays full); a slot that looks
    draftable holds it, so the pipeline drains for a verify round. Served
    with the harvest thread, the tokens are the plain engine's."""
    prompt = list(range(4, 44))
    base, = _drive(_e := _engine(params, False),
                   [_e.submit(prompt, _greedy(24))])
    eng = _engine(params, True)
    with eng:
        s = eng.submit(prompt, _greedy(24))
        s.text()
    assert s.token_ids == base.token_ids
    eng = _engine(params, True)
    req_stream = eng.submit(prompt, _greedy(24))
    while not req_stream.token_ids:
        eng._step()
    req, = eng._armed().values()
    eng._inflight_rounds, eng._depth = 1, 2
    req.drafter = PromptLookupDrafter(list(range(4, 40)), ngram_max=3)
    assert eng._plan_round().decode_steps > 0
    assert eng._draft_plan is None
    req.drafter = PromptLookupDrafter([7, 8, 9] * 5, ngram_max=3)
    assert eng._plan_round().decode_steps == 0
    eng._inflight_rounds = 0
    plan = eng._plan_round()
    # The suffix's latest earlier occurrence leaves 3 tokens after it.
    assert plan.decode_steps == 1 and eng._draft_plan == {req.slot:
                                                          [7, 8, 9]}


def test_sampling_spec_runs_and_respects_length(params):
    """Sampled requests ride verify rounds beside a greedy copy-heavy
    one: each gets exactly its length."""
    eng = _engine(params, True)
    a = eng.submit([9, 10, 11, 12] * 8, SamplingParams(
        max_tokens=20, temperature=0.7, top_k=8, top_p=0.9,
        ignore_eos=True))
    b = eng.submit([9, 10, 11, 12] * 8, _greedy(24))
    c = eng.submit([5, 6, 7, 8] * 6, SamplingParams(
        max_tokens=13, temperature=1.0, ignore_eos=True))
    _drive(eng, [a, b, c])
    assert (len(a.token_ids), len(b.token_ids), len(c.token_ids)) == \
        (20, 24, 13)
    assert eng.stats["spec_verify_rounds"] > 0


def test_sampled_verify_round_keeps_the_distribution(params):
    """Every slot holds the same state and drafts the same token (the
    target's second most likely); the token each sampled verify round
    emits first must follow the model's distribution at that position
    (temperature 1, top-k 8): total variation under 0.06 over 64 x 64
    draws, the fused sampler test's bound at this sample size."""
    B, n_rounds, top_k = 64, 64, 8
    eng = _engine(params, True, max_slots=B, kv_pool_tokens=None,
                  prefill_buckets=(16,), max_input_length=16,
                  max_output_length=16, sched_round_budget_tokens=1024)
    prompt = [9, 10, 11, 12, 9, 10, 11]
    with torch.no_grad():
        logits, _ = llama.apply(params[1], CFG, torch.tensor([prompt]),
                                torch.arange(len(prompt))[None])
    row = logits[0, -1].double()
    kept = torch.topk(row, top_k).indices
    target = torch.full_like(row, float("-inf"))
    target[kept] = row[kept]
    target = torch.softmax(target, -1).numpy()
    draft = int(kept[1])
    # Admit every slot (one step, under the budget) with the prompt less
    # its last token; each verify round then reads the last prompt token
    # at its position and verifies the draft.
    streams = [eng.submit(prompt[:-1], SamplingParams(
        max_tokens=8, temperature=1.0, top_k=top_k, top_p=1.0,
        ignore_eos=True)) for _ in range(B)]
    while not all(s.token_ids for s in streams):
        eng._step()
    st = eng._state
    saved = {k: st[k].clone() for k in ("pos", "active", "remaining",
                                        "seen", "recent")}
    assert bool(saved["active"].all())
    draws = []
    for r in range(n_rounds):
        for k, v in saved.items():
            st[k].copy_(v)
        st["last_token"].fill_(prompt[-1])
        st["drafts"].fill_(draft)
        st["n_draft"].fill_(1)
        st["act_idx"].copy_(torch.arange(B, dtype=torch.int32))
        eng._round_gen.manual_seed(1000 + r)
        eng._verify_body(eng._windows[0], False, B)
        draws.extend(st["round_tokens"][0].tolist())
    hist = np.bincount(np.asarray(draws), minlength=CFG.vocab_size)
    tv = 0.5 * np.abs(hist / hist.sum() - target).sum()
    assert tv < 0.06, tv
    assert set(np.nonzero(hist)[0]) <= set(kept.tolist())


def test_spec_stats_and_flight_events(params):
    from generativeaiexamples_tpu_torch.obs import flight as obs_flight
    eng = _engine(params, True)
    rec = obs_flight.FlightRecorder()
    eng.flight = rec
    s, = _drive(eng, [eng.submit([9, 10, 11, 12] * 8, _greedy(24))])
    stats = eng.stats
    tl = s.timeline
    assert stats["spec_verify_rounds"] > 0
    assert stats["spec_verify_tokens"] >= stats["spec_verify_slot_steps"]
    if stats["spec_draft_tokens"]:
        assert stats["spec_acceptance_rate"] == round(
            stats["spec_accepted_tokens"] / stats["spec_draft_tokens"], 4)
    assert stats["spec_tokens_per_step"] == round(
        stats["spec_verify_tokens"] / stats["spec_verify_slot_steps"], 4)
    names = [e[2] for e in tl.events_snapshot()]
    assert "spec_drafted" in names and "spec_accepted" in names
    assert "engine_verify" in names
    verify = [r for r in eng.rounds.records()
              if r.engine_tag == eng.engine_tag and r.kind == "verify"]
    assert verify and all(r.verify_positions == eng._spec_S * r.decode_slots
                          for r in verify)


def test_verify_cost_priced_against_budget(params):
    cost = StepCostModel(prefill_ms_per_token=0.1, verify_ms_per_token=0.2)
    assert cost.verify_cost_tokens(10) == 20
    assert StepCostModel().verify_cost_tokens(10) == 10
    assert cost.verify_cost_tokens(0) == 0
    eng = _engine(params, True)
    _drive(eng, [eng.submit([9, 10, 11, 12] * 8, _greedy(20))])
    verify = [r for r in eng.rounds.records()
              if r.engine_tag == eng.engine_tag and r.kind == "verify"]
    assert verify and all(r.decode_cost_tokens == r.verify_positions
                          for r in verify)


def test_verify_rounds_copy_no_host_value_to_the_device(params):
    """The serve loop of a spec engine (verify rounds, their drafts
    staged) reads no device value and copies no host value into device
    state synchronously."""
    from test_torch_harvest import _HostToDevice
    eng = _engine(params, True)
    s = eng.submit([9, 10, 11, 12] * 8, _greedy(24))
    with _HostToDevice() as mode:
        for _ in range(200):
            if s.finish_reason and not eng._slots:
                break
            eng._step()
    assert s.finish_reason == "length"
    assert eng.stats["spec_verify_rounds"] > 0
    assert mode.seen == [], mode.seen
