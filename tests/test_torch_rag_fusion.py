"""Fused RAG in the port (``engine/rag_fusion.py``, the engine's fused
admission, ``EngineLLM.stream_rag`` and the QA chatbot's fused branch)
against the JAX package's, on the CPU: the reference's
``tests/test_rag_fusion.py`` scenarios on the same numpy inputs.

The encoder is encoder-tiny with the reference's seeded weights carried
across by ``encoder_params_from_numpy``; the engines run float32. Token
ids, lengths, retrieved rows and texts are exact; nothing here has a
tolerance."""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.engine.rag_fusion import (
    FusedRag, FusedRagSpec, build_prompt_parts, corpus_rows)
from generativeaiexamples_tpu_torch.models import encoder as enc
from generativeaiexamples_tpu_torch.models.configs import (ENCODER_TINY,
                                                           LlamaConfig)
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.utils.errors import EngineError

from generativeaiexamples_tpu.engine import rag_fusion as jrag
from generativeaiexamples_tpu.models import encoder as jenc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(vocab_size=320, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
              max_position_embeddings=1024)
ENGINE_KW = dict(max_slots=2, max_input_length=256, max_output_length=32,
                 prefill_buckets=(128, 256), dtype="float32",
                 kv_pool_tokens=1536, page_size=64, steps_per_round=4)
SPEC_KW = dict(prefix_ids=(1, 10, 11), sep_ids=(12,), mid_ids=(13, 14),
               suffix_ids=(15,), top_k=2, ctx_budget=40, bucket=128,
               chunk_tokens=16, q_bucket=16, enc_bucket=32)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def encoders():
    """(JAX encoder-tiny params, the port's copy of them)."""
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    jparams = jenc.init_params(JENC, jax.random.key(3), dtype=jnp.float32)
    return jparams, enc.encoder_params_from_numpy(
        jax.tree.map(np.asarray, jparams), ENCODER_TINY)


@pytest.fixture(scope="module")
def llms():
    """(JAX llama params, the port's copy) of the reference test's
    geometry."""
    from generativeaiexamples_tpu.models import llama as jllama
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    jparams = jllama.init_params(JL(**CFG_KW), jax.random.key(0),
                                 dtype=jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu", torch.float32,
                                      cfg=LlamaConfig(**CFG_KW))


def _engines(llms, **kw):
    """A JAX engine and a port engine on the same weights and config."""
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    ekw = {**ENGINE_KW, **kw}
    return (JEngine(llms[0], JL(**CFG_KW), JTok(), JConfig(**ekw)),
            Engine(llms[1], LlamaConfig(**CFG_KW), ByteTokenizer(),
                   EngineConfig(**ekw), device="cpu"))


def _pack_query(ids, bucket):
    q = np.zeros((2, bucket), np.int32)
    q[0, :len(ids)] = ids
    q[1, :len(ids)] = 1
    return q


def _qvec(jparams, q_enc):
    """The query vector by the JAX encoder."""
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    q = jnp.asarray(q_enc)
    hidden = jenc.apply(jparams, JENC, q[0][None], q[1][None])
    return np.asarray(jenc.mean_pool(hidden, q[1][None], normalize=True)[0])


def reference_assembly(spec, doc_toks, doc_lens, order, q_ids):
    """Numpy mirror of the assembly's layout rules (the reference test's),
    cut to the bucket."""
    out = list(spec.prefix_ids)
    used = 0
    for rank, i in enumerate(order):
        if doc_lens[i] == 0:
            continue
        cost = doc_lens[i] + (len(spec.sep_ids) if rank > 0 else 0)
        if used + cost > spec.ctx_budget:
            break
        if rank > 0:
            out += list(spec.sep_ids)
        out += list(doc_toks[i][:doc_lens[i]])
        used += cost
    out += list(spec.mid_ids) + list(q_ids) + list(spec.suffix_ids)
    return out[:spec.bucket]


def _corpus(case, D):
    """(spec overrides, emb, toks, lens) of an assembly case."""
    rng = np.random.default_rng(0)
    C = SPEC_KW["chunk_tokens"]
    lens = np.array([5, 16, 9], np.int32)
    emb = rng.normal(size=(3, D)).astype(np.float32)
    over = {}
    if case == "budget_cap":
        over = dict(ctx_budget=18, top_k=3)
        emb = np.eye(3, D, dtype=np.float32)
        lens = np.full((3,), 16, np.int32)
    elif case == "k_over_n":
        over = dict(top_k=6, ctx_budget=60)
    elif case == "empty_separator":
        over = dict(sep_ids=())
    elif case == "duplicate_rows":
        # Rows 0, 2 and 4 are one vector: equal scores, lowest id first.
        over = dict(top_k=4, ctx_budget=60)
        emb = np.concatenate([emb, emb[:1], emb[1:2], emb[:1]])
        emb[2] = emb[0]
        lens = np.array([5, 16, 9, 7, 3, 11], np.int32)
    elif case == "past_the_bucket":
        # The question runs past a 32-token bucket: its tail is dropped.
        over = dict(bucket=32, ctx_budget=30)
    toks = np.zeros((len(lens), C), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = 100 + 20 * i + np.arange(n)
    return over, emb, toks, lens


@pytest.mark.parametrize("case", ["base", "budget_cap", "k_over_n",
                                  "empty_separator", "duplicate_rows",
                                  "past_the_bucket"])
def test_assemble_matches_the_reference(encoders, case):
    """Tokens, length and top_ids equal the JAX ``FusedRag.assemble``'s
    (ties lowest id first), and the tokens equal a numpy assembly of the
    rows ranked by a stable sort of the scores."""
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    jparams, params = encoders
    over, emb, toks, lens = _corpus(case, ENCODER_TINY.hidden_size)
    spec_kw = {**SPEC_KW, **over}
    jf = jrag.FusedRag(jparams, JENC, jrag.FusedRagSpec(**spec_kw))
    spec = FusedRagSpec(**spec_kw)
    ours = FusedRag(params, ENCODER_TINY, spec, CPU)
    jf.set_corpus(emb, toks, lens)
    ours.set_corpus(emb, toks, lens)
    q_ids = [40, 41, 42]
    q_llm = np.zeros((spec.q_bucket,), np.int32)
    q_llm[:3] = q_ids
    q_enc = _pack_query([7, 8, 9], spec.enc_bucket)
    jt, jl, ji = jax.jit(jf.assemble)(
        jf.enc_params, jf.corpus, jnp.asarray(q_enc), jnp.asarray(q_llm),
        jnp.int32(3))
    tokens, length, top_ids = ours.assemble(
        torch.from_numpy(q_enc), torch.from_numpy(q_llm),
        torch.tensor([3], dtype=torch.int32))
    assert tokens.dtype == length.dtype == top_ids.dtype == torch.int32
    assert tokens.tolist() == np.asarray(jt).tolist()
    assert length.tolist() == [int(jl)]
    assert top_ids.tolist() == np.asarray(ji).tolist()
    scores = np.full((ours.capacity,), -np.inf, np.float32)
    scores[:len(emb)] = emb @ _qvec(jparams, q_enc)
    order = np.argsort(-scores, kind="stable")[:spec.top_k]
    assert top_ids.tolist() == order.tolist()
    live = [int(i) for i in order if i < len(emb)]
    want = reference_assembly(spec, toks, lens, live, q_ids)
    assert int(length) == len(want)
    assert tokens[:len(want)].tolist() == want
    assert not tokens[len(want):].any()


def test_corpus_capacity_and_in_place_copies(encoders):
    """Capacity pads to a power of two from 8, as the reference's: a
    corpus that fits is copied into the same buffers, a larger one
    allocates new ones (and says so)."""
    spec = FusedRagSpec(**SPEC_KW)
    ours = FusedRag(encoders[1], ENCODER_TINY, spec, CPU)
    D, C = ENCODER_TINY.hidden_size, spec.chunk_tokens
    ptrs = {k: t.data_ptr() for k, t in ours.corpus.items()}
    assert not ours.set_corpus(np.eye(3, D, dtype=np.float32),
                               np.ones((3, C), np.int32),
                               np.full((3,), 2, np.int32))
    assert {k: t.data_ptr() for k, t in ours.corpus.items()} == ptrs
    assert ours.capacity == 8 and ours.corpus["n"].tolist() == [3]
    assert ours.set_corpus(np.eye(20, D, dtype=np.float32),
                           np.ones((20, C + 5), np.int32),
                           np.full((20,), C + 5, np.int32))
    assert ours.capacity == 32 and ours.corpus["n"].tolist() == [20]
    assert ours.corpus["lens"][:20].tolist() == [C] * 20
    assert ours.corpus["emb"].dtype == torch.float32
    jf = jrag.FusedRag(*_jax_encoder(encoders), jrag.FusedRagSpec(**SPEC_KW))
    jf.set_corpus(np.eye(20, D, dtype=np.float32),
                  np.ones((20, C + 5), np.int32),
                  np.full((20,), C + 5, np.int32))
    for name in ("emb", "toks", "lens"):
        assert ours.corpus[name].numpy().tolist() == np.asarray(
            jf.corpus[name]).tolist(), name


def _jax_encoder(encoders):
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    return encoders[0], JENC


def test_prompt_parts_and_corpus_rows_match_the_reference():
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import from_dict
    template = from_dict(AppConfig, {}).prompts.rag_template
    assert build_prompt_parts(template, ByteTokenizer()) == \
        jrag.build_prompt_parts(template, JTok())
    texts = ["short", "a longer chunk of text", ""]
    for a, b in zip(corpus_rows(texts, ByteTokenizer(), 8),
                    jrag.corpus_rows(texts, JTok(), 8)):
        assert a.tolist() == b.tolist()


def _forced_corpus(jparams, spec):
    """The reference scenario's corpus: row 1's vector is the query's."""
    q_enc_ids = [7, 8, 9]
    qvec = _qvec(jparams, _pack_query(q_enc_ids, spec.enc_bucket))
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(4, ENCODER_TINY.hidden_size)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) * 5
    emb[1] = qvec
    toks = np.zeros((4, spec.chunk_tokens), np.int32)
    lens = np.full((4,), 6, np.int32)
    for i in range(4):
        toks[i, :6] = 50 + i
    return q_enc_ids, emb, toks, lens


def _greedy(n, sp=SamplingParams):
    return sp(max_tokens=n, top_k=1, ignore_eos=True)


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["f32-pool",
                                                        "int8-pool"])
def test_fused_generation_matches_the_jax_engine(encoders, llms, kv_quant):
    """One fused request beside a plain one: the port engine's greedy
    tokens, retrieved rows and the plain request's tokens equal the JAX
    engine's; the top hit is the row whose vector is the query's; the
    assembled length read back is the numpy assembly's."""
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    jeng, eng = _engines(llms, kv_quant=kv_quant)
    spec = FusedRagSpec(**SPEC_KW)
    jeng.enable_fused_rag(*_jax_encoder(encoders),
                          jrag.FusedRagSpec(**SPEC_KW))
    eng.enable_fused_rag(encoders[1], ENCODER_TINY, spec)
    assert eng.fused_rag_spec == spec
    q_enc_ids, emb, toks, lens = _forced_corpus(encoders[0], spec)
    jeng.set_rag_corpus(emb, toks, lens)
    eng.set_rag_corpus(emb, toks, lens)
    out = {}
    for side, engine, sp in (("ref", jeng, JParams),
                             ("port", eng, SamplingParams)):
        with engine:
            fused = engine.submit_rag([30, 31], q_enc_ids,
                                      _greedy(6, sp))
            plain = engine.submit([5, 6, 7], _greedy(4, sp))
            fused.text()
            plain.text()
        out[side] = (fused.token_ids, fused.source_ids, fused.finish_reason,
                     plain.token_ids)
    assert out["port"] == out["ref"]
    tokens, rows, finish, _ = out["port"]
    assert len(tokens) == 6 and finish == "length"
    assert len(rows) == spec.top_k and rows[0] == 1
    want = reference_assembly(spec, toks, lens, rows, [30, 31])
    assert fused.rag_length == len(want)
    stats = eng.stats
    assert stats["rag_admissions"] == 1 and stats["prefills"] == 2
    assert stats["prefill_dispatches"] == 2
    assert stats["prefix_cache_lookups"] == 1     # the plain request only


def test_fused_text_equals_the_plain_engine_on_the_assembled_ids(
        encoders, llms):
    """The fused request's greedy tokens are the plain engine's for the
    prompt the numpy assembly builds from the rows read back."""
    _, eng = _engines(llms)
    spec = FusedRagSpec(**SPEC_KW)
    eng.enable_fused_rag(encoders[1], ENCODER_TINY, spec)
    q_enc_ids, emb, toks, lens = _forced_corpus(encoders[0], spec)
    eng.set_rag_corpus(emb, toks, lens)
    with eng:
        fused = eng.submit_rag([30, 31, 32], q_enc_ids, _greedy(8))
        fused.text()
        ids = reference_assembly(spec, toks, lens, fused.source_ids,
                                 [30, 31, 32])
        plain = eng.submit(ids, _greedy(8))
        plain.text()
    assert fused.rag_length == len(ids)
    assert fused.token_ids == plain.token_ids


def test_corpus_regrows_and_recaptures(encoders, llms, monkeypatch):
    """The upload runs in place while the capacity holds (no new
    capture); a corpus past it gets new buffers and the programs are
    captured again (``_capture_rag`` recorded here: the CPU captures
    nothing); the regrown corpus serves the JAX engine's tokens."""
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    captures = []

    def fake_capture(self):
        if not self._rag_graphs:
            captures.append(self._fused_rag.capacity)
            self._rag_graphs = {(True,): "greedy", (False,): "sampled"}

    monkeypatch.setattr(Engine, "_capture_rag", fake_capture)
    jeng, eng = _engines(llms)
    spec = FusedRagSpec(**SPEC_KW)
    eng.enable_fused_rag(encoders[1], ENCODER_TINY, spec)
    jeng.enable_fused_rag(*_jax_encoder(encoders),
                          jrag.FusedRagSpec(**SPEC_KW))
    D, C = ENCODER_TINY.hidden_size, spec.chunk_tokens
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(20, D)).astype(np.float32)
    toks = rng.integers(3, 300, size=(20, C)).astype(np.int32)
    lens = rng.integers(1, C + 1, size=(20,)).astype(np.int32)
    eng.set_rag_corpus(emb[:3], toks[:3], lens[:3])
    ptr = eng._fused_rag.corpus["emb"].data_ptr()
    eng.set_rag_corpus(emb[:5], toks[:5], lens[:5])
    assert captures == [8]
    assert eng._fused_rag.corpus["emb"].data_ptr() == ptr
    eng.set_rag_corpus(emb, toks, lens)
    assert captures == [8, 32] and eng._fused_rag.capacity == 32
    jeng.set_rag_corpus(emb, toks, lens)
    out = {}
    for side, engine, sp in (("ref", jeng, JParams),
                             ("port", eng, SamplingParams)):
        with engine:
            s = engine.submit_rag([33, 34], [9, 10, 11], _greedy(5, sp))
            s.text()
        out[side] = (s.token_ids, s.source_ids)
    assert out["port"] == out["ref"]


def test_refusals(encoders, llms):
    """The reference's refusals: a question past ``q_bucket``, a request
    the pool can never hold (a pool shrunk below one request's extent,
    set here by hand), a bucket that is not a page multiple or leaves
    the cache no room; fused requests before ``enable_fused_rag``."""
    _, eng = _engines(llms)
    with pytest.raises(EngineError, match="not enabled"):
        eng.submit_rag([1], [1])
    with pytest.raises(EngineError, match="enable_fused_rag"):
        eng.set_rag_corpus(np.zeros((1, 64), np.float32),
                           np.zeros((1, 16), np.int32),
                           np.zeros((1,), np.int32))
    with pytest.raises(EngineError, match="page multiple"):
        eng.enable_fused_rag(encoders[1], ENCODER_TINY,
                             FusedRagSpec(**{**SPEC_KW, "bucket": 100}))
    with pytest.raises(EngineError, match="cache extent"):
        eng.enable_fused_rag(encoders[1], ENCODER_TINY,
                             FusedRagSpec(**{**SPEC_KW, "bucket": 320}))
    eng.enable_fused_rag(encoders[1], ENCODER_TINY, FusedRagSpec(**SPEC_KW))
    with pytest.raises(EngineError, match="question bucket is 16"):
        eng.submit_rag(list(range(3, 20)), [7])
    eng._n_pages = 3
    with pytest.raises(EngineError, match="needs 3 KV pages"):
        eng.submit_rag([30], [7], _greedy(32))
    assert eng.stats["requests"] == 0


def test_a_rebuild_clears_the_fused_spec(encoders, llms):
    """A rebuilt engine (``prewarm``'s shrink) drops every program, the
    fused one too: ``fused_rag_spec`` is None, as the reference's
    docstring requires of callers that keep a spec."""
    _, eng = _engines(llms)
    eng.enable_fused_rag(encoders[1], ENCODER_TINY, FusedRagSpec(**SPEC_KW))
    assert eng.fused_rag_spec is not None
    eng._rebuild()
    assert eng.fused_rag_spec is None
    with pytest.raises(EngineError, match="not enabled"):
        eng.submit_rag([30], [7])


class _HostSyncs(TorchDispatchMode):
    """Records operations a CUDA graph cannot capture: a device value read
    on the host (``.item()``, ``nonzero``, boolean-mask indexing) or a
    host value copied in (``torch.tensor``)."""

    BAD = ("_local_scalar_dense", "nonzero", "masked_select", "lift_fresh",
           "is_nonzero", "unique", "repeat_interleave")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(b in name for b in self.BAD) or (
                "index" in name and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for a in args if isinstance(a, (list, tuple))
                    for i in a)):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_the_fused_body_makes_no_host_read_or_copy(encoders, llms):
    """The fused admission's body, greedy and sampled, reads every
    per-request value on the device, as its capture needs."""
    _, eng = _engines(llms)
    spec = FusedRagSpec(**SPEC_KW)
    eng.enable_fused_rag(encoders[1], ENCODER_TINY, spec)
    q_enc_ids, emb, toks, lens = _forced_corpus(encoders[0], spec)
    eng.set_rag_corpus(emb, toks, lens)
    eng.submit_rag([30, 31], q_enc_ids, SamplingParams(
        max_tokens=8, temperature=0.7, top_k=20, top_p=0.9,
        repetition_penalty=1.1, ignore_eos=True, bad_words=["ab"]))
    eng._step()                      # stages a real request's inputs
    assert eng.stats["rag_admissions"] == 1
    for greedy in (True, False):
        with _HostSyncs() as mode:
            eng._rag_body(greedy)
        assert mode.seen == [], greedy
    eng.stop()


# ------------------------------------------------------------------ chain

CHAIN_ENGINE_KW = dict(max_slots=2, max_input_length=768,
                       max_output_length=32, prefill_buckets=(128, 768),
                       dtype="float32", kv_pool_tokens=2048, page_size=64,
                       steps_per_round=4)
QUESTION = "What is the MXU?"


def _chatbots(encoders, llms, tmp_path, embedder="service"):
    """The port's and the reference's QA chatbots on the reference test's
    engines (byte tokenizers), the document ingested into each."""
    from generativeaiexamples_tpu.chains.examples.developer_rag import \
        QAChatbot as JBot
    from generativeaiexamples_tpu.chains.llm import EngineLLM as JLLM
    from generativeaiexamples_tpu.embed.encoder import \
        EmbeddingService as JEmbed
    from generativeaiexamples_tpu.embed.encoder import HashEmbedder as JHash
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    from generativeaiexamples_tpu.utils.app_config import \
        AppConfig as JAppConfig
    from generativeaiexamples_tpu.utils.configuration import \
        from_dict as jfrom_dict
    from generativeaiexamples_tpu_torch.chains.examples.developer_rag import \
        QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.embed.encoder import (
        EmbeddingService, HashEmbedder)
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import from_dict

    chain = {"text_splitter": {"chunk_size": 24, "chunk_overlap": 4}}
    doc = tmp_path / "d.txt"
    doc.write_text("The MXU is a systolic array. " * 6
                   + "Paris is the capital of France. " * 6)
    jeng, eng = _engines(llms, **CHAIN_ENGINE_KW)
    if embedder == "service":
        jemb = JEmbed(encoders[0], _jax_encoder(encoders)[1], JTok(),
                      max_length=64, seq_buckets=(32, 64))
        emb = EmbeddingService(encoders[1], ENCODER_TINY, ByteTokenizer(),
                               max_length=64, seq_buckets=(32, 64))
    else:
        jemb, emb = JHash(), HashEmbedder()
    ours = QAChatbot(llm=EngineLLM(eng), embedder=emb,
                     config=from_dict(AppConfig, chain))
    ref = JBot(llm=JLLM(jeng), embedder=jemb,
               config=jfrom_dict(JAppConfig, chain))
    for bot in (ours, ref):
        bot.ingest_docs(str(doc), "d.txt")
    return ours, ref


@pytest.mark.parametrize("question", [QUESTION, "Which city? " * 8],
                         ids=["fused", "long_question_host_path"])
def test_chatbot_auto_enables_fused_rag_as_the_reference(encoders, llms,
                                                         tmp_path, question):
    """``QAChatbot()`` with an ``EmbeddingService`` and an ``EngineLLM``
    turns fused RAG on, as the reference's; both answer with the same
    text and attribute it to the same sources. A question past the
    64-token question bucket takes the host path on both (no sources)."""
    ours, ref = _chatbots(encoders, llms, tmp_path)
    try:
        assert ours._fused_ready and ref._fused_ready
        assert ours._fused_spec.bucket == ref._fused_spec.bucket
        texts = ["".join(bot.rag_chain(question, 6)) for bot in (ours, ref)]
        assert texts[0] == texts[1] and texts[0]
        assert ours.last_sources == ref.last_sources
        fused = len(question.encode()) <= 64
        assert ours.llm.engine.stats["rag_admissions"] == int(fused)
        if fused:
            assert ours.last_sources[0]["source"] == "d.txt"
        else:
            assert ours.last_sources == []
    finally:
        ours.llm.engine.stop()
        ref.llm.engine.stop()


def test_chatbot_keeps_the_host_path_without_a_device_embedder(
        encoders, llms, tmp_path):
    """The hash embedder has no parameters: both chatbots stay on the
    host path and answer alike."""
    ours, ref = _chatbots(encoders, llms, tmp_path, embedder="hash")
    try:
        assert not ours._fused_ready and not ref._fused_ready
        texts = ["".join(bot.rag_chain(QUESTION, 4)) for bot in (ours, ref)]
        assert texts[0] == texts[1]
        assert ours.last_sources == [] and \
            ours.llm.engine.fused_rag_spec is None
    finally:
        ours.llm.engine.stop()
        ref.llm.engine.stop()


def test_the_switch_turns_fused_rag_off(encoders, llms, tmp_path,
                                        monkeypatch):
    """``GENAI_TPU_FUSED_RAG=0`` (the reference's switch) keeps the host
    path on both."""
    monkeypatch.setenv("GENAI_TPU_FUSED_RAG", "0")
    ours, ref = _chatbots(encoders, llms, tmp_path)
    try:
        assert not ours._fused_ready and not ref._fused_ready
        assert ours.llm.engine.fused_rag_spec is None
    finally:
        ours.llm.engine.stop()
        ref.llm.engine.stop()


# ---------------------------------------------------- both chain servers

GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_tiny")
DOCS = ("frontend.md", "evaluation.md", "README.md")
SERVER_ENGINE_KW = dict(max_slots=2, max_input_length=448,
                        max_output_length=64,
                        prefill_buckets=(64, 128, 256, 448), page_size=16,
                        dtype="float32", kv_pool_tokens=None, max_queue=4)
SERVER_CHAIN_CFG = {"text_splitter": {"chunk_size": 200,
                                      "chunk_overlap": 50},
                    "retriever": {"top_k": 3, "max_context_tokens": 600}}
SERVER_QUESTIONS = ("How does the chatbot evaluate its answers?",
                    "What does the frontend show?")


@contextlib.contextmanager
def _serve(app):
    from conftest import serve_app
    with serve_app(app, timeout=120) as base:
        yield base


def _post(url, body):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read().decode()


def _upload(base, path):
    import urllib.request
    import uuid
    boundary = uuid.uuid4().hex
    with open(path, "rb") as f:
        payload = f.read()
    data = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f" filename=\"{os.path.basename(path)}\"\r\nContent-Type: "
            f"text/markdown\r\n\r\n").encode() + payload + \
        f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(base + "/uploadDocument", data=data,
                                 headers={"Content-Type": "multipart/form-"
                                          f"data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status


@pytest.fixture(scope="module")
def fused_servers(encoders, tmp_path_factory):
    """Both chain servers with fused RAG on by default: golden-tiny over
    each package's engine, encoder-tiny with the same weights, an exact
    store, the three docs uploaded to each."""
    from generativeaiexamples_tpu.chains.examples.developer_rag import \
        QAChatbot as JBot
    from generativeaiexamples_tpu.chains.llm import EngineLLM as JLLM
    from generativeaiexamples_tpu.chains.server import create_app as jcreate
    from generativeaiexamples_tpu.embed.encoder import \
        EmbeddingService as JEmbed
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.models.configs import GOLDEN_TINY as JCFG
    from generativeaiexamples_tpu.models.import_hf import \
        load_checkpoint as jload
    from generativeaiexamples_tpu.models.tokenizer import ByteTokenizer as JB
    from generativeaiexamples_tpu.models.tokenizer import \
        get_tokenizer as jget
    from generativeaiexamples_tpu.retrieval.docstore import \
        DocumentIndex as JIndex
    from generativeaiexamples_tpu.retrieval.exact import ExactStore as JExact
    from generativeaiexamples_tpu.utils.app_config import \
        AppConfig as JAppConfig
    from generativeaiexamples_tpu.utils.configuration import \
        from_dict as jfrom_dict
    from generativeaiexamples_tpu_torch.chains.examples.developer_rag import \
        QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.chains.server import create_app
    from generativeaiexamples_tpu_torch.embed.encoder import EmbeddingService
    from generativeaiexamples_tpu_torch.models.configs import GOLDEN_TINY
    from generativeaiexamples_tpu_torch.models.import_hf import \
        load_checkpoint
    from generativeaiexamples_tpu_torch.models.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.retrieval.docstore import \
        DocumentIndex
    from generativeaiexamples_tpu_torch.retrieval.exact import ExactStore
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import from_dict

    jparams, params = encoders
    jenc_cfg = _jax_encoder(encoders)[1]
    eng = Engine(load_checkpoint(GOLDEN, GOLDEN_TINY, dtype=torch.float32,
                                 device="cpu"),
                 GOLDEN_TINY, get_tokenizer(GOLDEN),
                 EngineConfig(**SERVER_ENGINE_KW), device="cpu")
    jeng = JEngine(jload(GOLDEN, JCFG, dtype=jnp.float32), JCFG,
                   jget(GOLDEN), JConfig(**SERVER_ENGINE_KW))
    emb = EmbeddingService(params, ENCODER_TINY, ByteTokenizer())
    ours = QAChatbot(llm=EngineLLM(eng), embedder=emb,
                     index=DocumentIndex(emb, store=ExactStore(dim=64)),
                     config=from_dict(AppConfig, SERVER_CHAIN_CFG))
    jemb = JEmbed(jparams, jenc_cfg, JB())
    ref = JBot(llm=JLLM(jeng), embedder=jemb,
               index=JIndex(jemb, store=JExact(dim=64)),
               config=jfrom_dict(JAppConfig, SERVER_CHAIN_CFG))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GAIE_RUN_DIR", str(tmp_path_factory.mktemp("port_run")))
        app = create_app(ours, str(tmp_path_factory.mktemp("port_up")))
        mp.setenv("GAIE_RUN_DIR", str(tmp_path_factory.mktemp("ref_run")))
        japp = jcreate(ref, str(tmp_path_factory.mktemp("ref_up")))
    with _serve(app) as port, _serve(japp) as jref:
        for name in DOCS:
            for base in (port, jref):
                assert _upload(base, os.path.join(ROOT, "docs", name)) \
                    == 200
        yield {"port": port, "ref": jref, "bots": (ours, ref),
               "engine": eng}
    eng.stop()
    jeng.stop()


def test_both_chain_servers_answer_alike_with_fused_rag(fused_servers):
    """Fused RAG is on in both servers by default; greedy ``/generate``
    with the knowledge base streams the same text from each, attributed
    to the same sources; every answer went through a fused admission."""
    ours, ref = fused_servers["bots"]
    assert ours._fused_ready and ref._fused_ready
    assert ours._fused_spec.bucket == ref._fused_spec.bucket
    eng = fused_servers["engine"]
    before = eng.stats["rag_admissions"]
    for q in SERVER_QUESTIONS:
        body = {"question": q, "use_knowledge_base": True,
                "num_tokens": 24}
        got = {side: _post(fused_servers[side] + "/generate", body)
               for side in ("port", "ref")}
        assert got["port"] == got["ref"]
        assert got["port"][0] == 200 and len(got["port"][1]) > 10
        assert "[notice]" not in got["port"][1]
        assert ours.last_sources == ref.last_sources
        assert {s["source"] for s in ours.last_sources} <= set(DOCS)
    assert eng.stats["rag_admissions"] == before + len(SERVER_QUESTIONS)


def test_the_fused_answer_is_the_engine_text_of_the_assembled_ids(
        fused_servers):
    """The fused answer's tokens are the engine's greedy tokens for the
    prompt a numpy assembly builds from the rows it read back, submitted
    as plain ids."""
    ours, _ = fused_servers["bots"]
    eng, spec = fused_servers["engine"], ours._fused_spec
    q = SERVER_QUESTIONS[0]
    q_ids = eng.tokenizer.encode(q, add_bos=False)
    enc_ids = ours.index.embedder.tokenizer.encode(f"query: {q}")
    fused = eng.submit_rag(q_ids, enc_ids, _greedy(16))
    fused.text()
    texts = [ours.index.get(i).text for i in ours._fused_doc_ids]
    toks, lens = corpus_rows(texts, eng.tokenizer, spec.chunk_tokens)
    ids = reference_assembly(spec, toks, lens, fused.source_ids, q_ids)
    assert fused.rag_length == len(ids)
    plain = eng.submit(ids, _greedy(16))
    plain.text()
    assert fused.token_ids == plain.token_ids
