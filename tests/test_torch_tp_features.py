"""The features that serve at tp > 1 beside the decode path, on two gloo
ranks of the port (``tests/torch_tp_ranks.py``, spawned once for the
module, two groups at once) against the JAX package on a tp = 2 mesh of
the conftest's CPU devices and against one-rank port engines:

- a checkpoint directory through ``build_services`` with an int8
  quantization at load: each rank's tree equals ``shard_params`` of the
  whole tree quantized on one rank (a row-parallel weight's per-channel
  scale from the MAX all-reduce), a second start reads each rank's own
  weight-cache entry, a third, after the follower lost its entry,
  converts on both ranks, and ``/v1/score`` answers 200 with the
  reference's NLL;
- ``Engine.score`` against the reference's ``llama.score`` under its
  tp = 2 mesh, in one pass and in chunks over the dense cache;
- the host KV tier: an evicted prompt offloaded and restored, a session
  suspended and resumed, a tp = 2 handoff export continued by a one-rank
  engine and a one-rank export continued at tp = 2;
- fused RAG against the reference tp = 2 engine's fused answer, and the
  QA chatbot's fused ``/generate`` chain against the reference
  chatbot's over its tp = 2 engine;
- ``prewarm`` with an out-of-memory error on the follower alone.

float32 pools and weights; greedy tokens are exact, NLLs within 1e-4."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks
from torch_checkpoints import write_hf_dir

from generativeaiexamples_tpu.engine import Engine as JEngine
from generativeaiexamples_tpu.engine import EngineConfig as JConfig
from generativeaiexamples_tpu.engine import SamplingParams as JParams
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
from generativeaiexamples_tpu.models.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu.parallel import MeshPlan as JPlan
from generativeaiexamples_tpu.parallel import make_mesh as jmake_mesh
from generativeaiexamples_tpu_torch.engine import Engine, EngineConfig
from generativeaiexamples_tpu_torch.engine.kv_tier import from_blob
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer

TIMEOUT = 240
# tests/test_torch_multichip_serving.py's geometry: heads 4 / kv heads 2,
# vocab 320 in two halves of whole mask words.
LLAMA = dict(vocab_size=320, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             max_position_embeddings=512)
ECFG = dict(max_slots=4, max_input_length=128, max_output_length=32,
            prefill_buckets=(32, 64, 128), dtype="float32", page_size=16,
            steps_per_round=4, max_queue=32)
# The tier's engine (tests/test_torch_kv_tier.py's): a 96-token pool of 6
# pages, each request holding 3, so two others push a prompt out.
TIER_ECFG = dict(max_slots=2, max_input_length=64, max_output_length=16,
                 prefill_buckets=(32, 64), page_size=16, dtype="float32",
                 kv_pool_tokens=96, steps_per_round=4,
                 kv_host_pool_tokens=4096)
RAG_ECFG = dict(max_slots=2, max_input_length=256, max_output_length=32,
                prefill_buckets=(128, 256), dtype="float32",
                kv_pool_tokens=1536, page_size=64, steps_per_round=4)
RAG_SPEC = dict(prefix_ids=(1, 10, 11), sep_ids=(12,), mid_ids=(13, 14),
                suffix_ids=(15,), top_k=2, ctx_budget=40, bucket=128,
                chunk_tokens=16, q_bucket=16, enc_bucket=32)
# tests/test_torch_rag_fusion.py's chatbot: its engine, splitter,
# document and question.
CHAIN_ECFG = dict(max_slots=2, max_input_length=768, max_output_length=32,
                  prefill_buckets=(128, 768), dtype="float32",
                  kv_pool_tokens=2048, page_size=64, steps_per_round=4)
CHAIN = {"text_splitter": {"chunk_size": 24, "chunk_overlap": 4}}
DOC = ("The MXU is a systolic array. " * 6
       + "Paris is the capital of France. " * 6)
QUESTION = "What is the MXU?"
GREEDY = dict(max_tokens=8, top_k=1, ignore_eos=True)
SP4 = dict(max_tokens=4, top_k=1, ignore_eos=True)


def _tree(seed):
    """The reference's init with random norms, in numpy."""
    tree = jax.tree.map(np.asarray, jllama.init_params(
        JL(**LLAMA), jax.random.key(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    layers = dict(tree["layers"])
    for key in ("attn_norm", "mlp_norm"):
        layers[key] = (1 + 0.1 * rng.standard_normal(layers[key].shape)
                       ).astype(np.float32)
    return {**tree, "layers": layers}


def _prompt(seed, n):
    return [(seed * 31 + i * 7) % 250 + 3 for i in range(n)]


PROMPTS = {"offload": _prompt(1, 40), "churn": [_prompt(2, 40),
                                                _prompt(3, 40)],
           "history": _prompt(5, 53), "handoff": _prompt(6, 53),
           "import": _prompt(7, 53)}
DOCS = {"short": (_prompt(8, 30), 64), "long": (_prompt(9, 70), 32)}


def _port_engine(tree, ecfg):
    cfg = LlamaConfig(**LLAMA)
    return Engine(params_from_numpy(tree, "cpu", torch.float32, cfg=cfg),
                  cfg, ByteTokenizer(), EngineConfig(**ecfg), device="cpu")


def _one_rank(tree, ecfg, prompt, kw=SP4, export=False):
    """A one-rank port engine's greedy tokens for ``prompt`` (the unified
    replica), and with ``export`` its handoff blob of it."""
    eng = _port_engine(tree, ecfg)
    try:
        tokens = torch_tp_ranks._serve_one(eng, prompt, kw)
        return tokens, (eng.export_handoff(prompt)[0] if export else None)
    finally:
        eng.close()


def _forced_corpus(enc_tree, spec):
    """tests/test_torch_rag_fusion.py's corpus: row 1's vector is the
    query's (by the JAX encoder)."""
    from generativeaiexamples_tpu.models import encoder as jenc
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    q_enc_ids = [7, 8, 9]
    q = np.zeros((2, spec["enc_bucket"]), np.int32)
    q[0, :3], q[1, :3] = q_enc_ids, 1
    jparams = jax.tree.map(jnp.asarray, enc_tree)
    hidden = jenc.apply(jparams, JENC, jnp.asarray(q[0])[None],
                        jnp.asarray(q[1])[None])
    qvec = np.asarray(jenc.mean_pool(hidden, jnp.asarray(q[1])[None],
                                     normalize=True)[0])
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(4, qvec.shape[0])).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True) * 5
    emb[1] = qvec
    toks = np.zeros((4, spec["chunk_tokens"]), np.int32)
    lens = np.full((4,), 6, np.int32)
    for i in range(4):
        toks[i, :6] = 50 + i
    return q_enc_ids, (emb, toks, lens)


@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    """Every engine of the module, in both packages and in the spawned
    ranks, plans under the same fixed costs and budget."""
    path = tmp_path_factory.mktemp("sched") / "PROFILE_default.json"
    path.write_text('{"full_ms_per_step": 2.0, "slots": 8, '
                    '"prefill_ms_per_token": 0.125}')
    keys = ("SCHED_PROFILE_JSON", "SCHED_ONLINE_CALIB", "ENGINE_SPEC_DECODE",
            "KV_HOST_POOL_TOKENS", "ENGINE_WATCHDOG_STALL_S",
            "HISTORY_INTERVAL_S")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(SCHED_PROFILE_JSON=str(path), SCHED_ONLINE_CALIB="0",
                      HISTORY_INTERVAL_S="0")
    for k in ("ENGINE_SPEC_DECODE", "KV_HOST_POOL_TOKENS",
              "ENGINE_WATCHDOG_STALL_S"):
        os.environ.pop(k, None)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def case(pinned, tmp_path_factory):
    """The module's inputs: trees, a checkpoint directory, the encoder."""
    from generativeaiexamples_tpu.models import encoder as jenc
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    tree = _tree(9)
    ckpt = write_hf_dir(str(tmp_path_factory.mktemp("ckpt") / "tiny"),
                        LlamaConfig(**LLAMA), tree, shards=2)
    enc_tree = jax.tree.map(np.asarray, jenc.init_params(
        JENC, jax.random.key(3), dtype=jnp.float32))
    q_enc_ids, corpus = _forced_corpus(enc_tree, RAG_SPEC)
    doc = tmp_path_factory.mktemp("doc") / "d.txt"
    doc.write_text(DOC)
    return types.SimpleNamespace(
        tree=tree, ckpt=ckpt, enc_tree=enc_tree, q_enc_ids=q_enc_ids,
        corpus=corpus, doc=str(doc),
        cache=str(tmp_path_factory.mktemp("weight_cache")))


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """Port ranks running every job of the module; ``get()`` waits for
    the leaders' results (the reference engines run meanwhile)."""
    import torch.multiprocessing as mp
    blob_in = _one_rank(case.tree, TIER_ECFG, PROMPTS["import"],
                        export=True)[1]
    questions = [([30, 31], case.q_enc_ids, dict(GREEDY, max_tokens=6)),
                 ([40, 41, 42], [9, 8, 7], dict(GREEDY, max_tokens=5))]
    jobs = [
        dict(name="ckpt", drive="ckpt", path=case.ckpt, cache_dir=case.cache,
             model="llama-tiny", engine=ECFG, quantization="int8",
             drop_rank=1,
             requests=[(PROMPTS["history"], GREEDY)],
             score_ids=DOCS["short"][0]),
        dict(name="score", drive="score", cfg=LLAMA, tree=case.tree,
             engine=ECFG, docs=DOCS),
        dict(name="tier", drive="tier", cfg=LLAMA, tree=case.tree,
             engine=TIER_ECFG, prompts=PROMPTS, sampling=SP4, blob=blob_in),
        dict(name="rag", drive="rag", cfg=LLAMA, tree=case.tree,
             engine=RAG_ECFG, enc_tree=case.enc_tree, spec=RAG_SPEC,
             corpus=case.corpus, questions=questions,
             plain=[([5, 6, 7], dict(GREEDY, max_tokens=4))]),
        dict(name="rag_chain", drive="rag_chain", cfg=LLAMA, tree=case.tree,
             engine=CHAIN_ECFG, enc_tree=case.enc_tree, chain=CHAIN,
             doc=case.doc, question=QUESTION),
        dict(name="prewarm_oom", drive="prewarm_oom", cfg=LLAMA,
             tree=case.tree, engine=dict(ECFG, kv_pool_tokens=512),
             oom_rank=1, requests=[(PROMPTS["history"], GREEDY)]),
    ]
    ctx = mp.get_context("spawn")
    groups = []
    for g, part in enumerate((jobs[0::2], jobs[1::2])):
        q = ctx.Queue()
        path = str(tmp_path_factory.mktemp(f"tpf{g}") / "group")
        procs = [ctx.Process(target=torch_tp_ranks.rank_main,
                             args=(r, 2, path, q, part), daemon=True)
                 for r in range(2)]
        for p in procs:
            p.start()
        groups.append((q, procs))
    box: dict = {}

    def get():
        for g, (q, procs) in enumerate(groups):
            while (g, 0) not in box or (g, 1) not in box:
                rank, status, out = q.get(timeout=TIMEOUT)
                assert status == "ok", out
                box[(g, rank)] = out
        return {**box[(0, 0)], **box[(1, 0)]}
    yield types.SimpleNamespace(get=get)
    for _, procs in groups:
        for p in procs:
            p.join(timeout=60)
            assert not p.is_alive()


def _jmesh():
    return jmake_mesh(JPlan(tp=2), jax.devices()[:2])


def _jax_tokens(tree, ecfg, prompts, kw=GREEDY, **extra):
    """The reference tp = 2 engine's tokens, one request at a time."""
    with JEngine(jax.tree.map(jnp.asarray, tree), JL(**LLAMA), JTok(),
                 JConfig(**{**ecfg, **extra}), mesh=_jmesh()) as eng:
        out = []
        for ids in prompts:
            s = eng.submit(ids, JParams(**kw))
            s.text()
            out.append(list(s.token_ids))
        return out


def _jax_score(tree, ids, chunk):
    return np.asarray(jllama.score(
        jax.tree.map(jnp.asarray, tree), JL(**LLAMA),
        jnp.asarray([ids], jnp.int32), mesh=_jmesh(), chunk=chunk))[0]


def test_tp2_checkpoint_loads_each_ranks_quantized_shard_and_caches_it(
        ranks, case):
    """``build_services`` over an HF directory at tp = 2 with int8 at
    load: each rank's served tree is its block of the whole tree
    quantized on one rank, bit for bit (wo's and w_down's per-channel
    scales after the MAX all-reduce); the second start reads each rank's
    own cache entry; both starts serve the reference tp = 2 engine's
    greedy tokens on the reference's int8 tree, and ``/v1/score``
    answers 200 with its NLL within 1e-4."""
    from generativeaiexamples_tpu.ops.quant import quantize_params as jq
    got = ranks.get()["ckpt"]
    for r, rank in enumerate(got["ranks"]):
        assert rank["rank"] == r and rank["equal"][:2] == [True, True]
        assert rank["from_cache"][:2] == [False, True]
        assert f"-tp2-r{r}-" in rank["identity"]
    jtree = jax.tree.map(np.asarray, jq(jax.tree.map(jnp.asarray, case.tree),
                                        mode="int8"))
    want = _jax_tokens(jtree, ECFG, [PROMPTS["history"]])
    assert got["tokens"][:2] == want * 2
    nll = _jax_score(jtree, DOCS["short"][0], 64)
    for status, body in got["score"][:2]:
        assert status == 200 and body["tokens"] == len(DOCS["short"][0])
        np.testing.assert_allclose(body["nll"], nll, atol=1e-4)


def test_tp2_a_rank_without_its_cache_entry_sends_every_rank_to_convert(
        ranks, case):
    """A third start after the follower deleted its own weight-cache entry
    (the leader's still there): the ranks agree to convert, every rank
    quantizes at load again (the MAX all-reduce reached by both) to its
    bit-exact block, and the leader serves the reference's tokens and
    score (NLL within 1e-4)."""
    from generativeaiexamples_tpu.ops.quant import quantize_params as jq
    got = ranks.get()["ckpt"]
    for rank in got["ranks"]:
        assert rank["from_cache"] == [False, True, False]
        assert rank["equal"][2]
    jtree = jax.tree.map(np.asarray, jq(jax.tree.map(jnp.asarray, case.tree),
                                        mode="int8"))
    assert got["tokens"][2] == _jax_tokens(jtree, ECFG,
                                           [PROMPTS["history"]])[0]
    status, body = got["score"][2]
    assert status == 200
    np.testing.assert_allclose(body["nll"], _jax_score(
        jtree, DOCS["short"][0], 64), atol=1e-4)


def test_tp2_score_equals_the_reference_tp2_score(ranks, case):
    """``Engine.score`` at tp = 2 (a header to the follower, the tp
    forward on both ranks) equals the reference's ``llama.score`` under a
    tp = 2 mesh within 1e-4: 30 tokens in one pass, 70 in chunks of 32
    over the dense cache."""
    got = ranks.get()["score"]
    for name, (ids, chunk) in DOCS.items():
        np.testing.assert_allclose(got[name], _jax_score(case.tree, ids,
                                                         chunk), atol=1e-4)
        assert got[name].shape == (len(ids) - 1,)


def test_tp2_offload_suspend_resume_and_handoff_across_topologies(ranks,
                                                                  case):
    """The host tier at tp = 2 keeps whole-model blocks on the leader: an
    evicted prompt is offloaded and restored with its cold tokens; a
    suspended session resumes and continues as the uninterrupted run and
    the reference tp = 2 engine; a tp = 2 handoff blob (the model's 2 kv
    heads, a one-card engine's layout) is continued by a one-rank engine,
    and a one-rank blob by the tp = 2 engine, both with the unified
    replica's greedy tokens."""
    got = ranks.get()["tier"]
    assert got["offloaded"] > 0 and got["restored"] > 0
    assert got["offload_warm"] == got["offload_cold"]
    assert got["suspend_meta"]["num_kv_heads"] == LLAMA["num_kv_heads"]
    assert got["resumed"] == 3 and got["warm_restored"] == 3
    assert got["warm"] == got["cold"] == _jax_tokens(
        case.tree, TIER_ECFG, [PROMPTS["history"]], SP4)[0]
    blob, blocks = got["handoff"]
    meta, records = from_blob(blob)
    assert blocks == 3 and meta["num_kv_heads"] == LLAMA["num_kv_heads"]
    assert records[0].arrays["k"].shape == (2, 2, 16, 16)
    unified = _one_rank(case.tree, TIER_ECFG, PROMPTS["handoff"])[0]
    decode = _port_engine(case.tree, TIER_ECFG)
    try:
        assert decode.resume_session(blob) == 3
        tokens = torch_tp_ranks._serve_one(decode, PROMPTS["handoff"], SP4)
        assert decode.stats["kv_tier_restore_pages"] == 3
    finally:
        decode.close()
    assert tokens == unified
    assert got["imported"] == 3 and got["import_restored"] == 3
    assert got["import_tokens"] == _one_rank(case.tree, TIER_ECFG,
                                             PROMPTS["import"])[0]


def test_tp2_fused_rag_gives_the_reference_fused_answer(ranks, case):
    """Fused RAG at tp = 2 (the encoder and corpus broadcast to the
    follower, the leader's retrieved rows broadcast inside the
    admission): tokens and retrieved rows equal the reference tp = 2
    engine's fused answers, and a plain request beside them its plain
    answer."""
    from generativeaiexamples_tpu.engine import rag_fusion as jrag
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    got = ranks.get()["rag"]
    jeng = JEngine(jax.tree.map(jnp.asarray, case.tree), JL(**LLAMA), JTok(),
                   JConfig(**RAG_ECFG), mesh=_jmesh())
    jeng.enable_fused_rag(jax.tree.map(jnp.asarray, case.enc_tree), JENC,
                          jrag.FusedRagSpec(**RAG_SPEC))
    jeng.set_rag_corpus(*case.corpus)
    want = []
    with jeng:
        for q_ids, q_enc, kw in ([([30, 31], case.q_enc_ids,
                                   dict(GREEDY, max_tokens=6)),
                                  ([40, 41, 42], [9, 8, 7],
                                   dict(GREEDY, max_tokens=5))]):
            s = jeng.submit_rag(q_ids, q_enc, JParams(**kw))
            s.text()
            want.append((list(s.token_ids), list(s.source_ids)))
        plain = jeng.submit([5, 6, 7], JParams(**dict(GREEDY,
                                                      max_tokens=4)))
        plain.text()
    assert [(tokens, rows) for tokens, rows, _ in got["fused"]] == want
    assert got["fused"][0][1][0] == 1       # the query's own row first
    assert all(0 < n <= RAG_SPEC["bucket"] for _, _, n in got["fused"])
    assert got["plain"] == [list(plain.token_ids)]
    assert got["admissions"] == 2


def test_tp2_chatbot_generate_takes_the_fused_path_as_the_reference(
        ranks, case):
    """The QA chatbot's ``/generate`` chain over a tp = 2 engine turns
    fused RAG on, answers with one fused admission and gives the
    reference chatbot's text and sources over its tp = 2 engine."""
    from generativeaiexamples_tpu.chains.examples.developer_rag import \
        QAChatbot as JBot
    from generativeaiexamples_tpu.chains.llm import EngineLLM as JLLM
    from generativeaiexamples_tpu.embed.encoder import \
        EmbeddingService as JEmbed
    from generativeaiexamples_tpu.models.configs import ENCODER_TINY as JENC
    from generativeaiexamples_tpu.utils.app_config import \
        AppConfig as JAppConfig
    from generativeaiexamples_tpu.utils.configuration import \
        from_dict as jfrom_dict
    got = ranks.get()["rag_chain"]
    jeng = JEngine(jax.tree.map(jnp.asarray, case.tree), JL(**LLAMA), JTok(),
                   JConfig(**CHAIN_ECFG), mesh=_jmesh())
    emb = JEmbed(jax.tree.map(jnp.asarray, case.enc_tree), JENC, JTok(),
                 max_length=64, seq_buckets=(32, 64))
    bot = JBot(llm=JLLM(jeng), embedder=emb,
               config=jfrom_dict(JAppConfig, CHAIN))
    try:
        bot.ingest_docs(case.doc, "d.txt")
        assert bot._fused_ready and got["fused"]
        text = "".join(bot.rag_chain(QUESTION, 6))
    finally:
        jeng.stop()
    assert got["text"] == text and text
    assert got["sources"] == bot.last_sources
    assert got["admissions"] == 1


def test_tp2_prewarm_oom_on_one_rank_rebuilds_every_rank_alike(ranks, case):
    """An out-of-memory error on the follower alone at prewarm's first
    attempt: the ranks agree on it, both shrink by the reference's rule
    and rebuild to one page count, and the engine serves the reference's
    tokens."""
    got = ranks.get()["prewarm_oom"]
    shrunk = int(got["pages0"] * 0.8)
    assert got["pages"] == [shrunk, shrunk] and shrunk < got["pages0"]
    assert got["fatal"] == "None"
    assert got["tokens"] == _jax_tokens(case.tree, ECFG,
                                        [PROMPTS["history"]])[0]
