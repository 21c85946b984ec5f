"""Tensor-parallel serving of the port on the CPU: two gloo processes
(``tests/torch_tp_ranks.py``, spawned once for the module) against the
JAX package's ``Engine`` on a tp = 2 mesh of the conftest's CPU devices,
as ``tests/test_multichip_serving.py`` and ``tests/test_parallel.py`` hold
the reference.

Every request of both packages runs one at a time (or, for the MoE
model, batch by batch in lockstep: its tokens depend on the rows beside
them), under one pinned schedule, float32 throughout. Greedy tokens
equal exactly; the sharded sampling tails give the reference's sharded
tails' exact tokens and verdicts on the reference's own noise field. The
model server's CLI at tp = 2 is driven too: a dead follower turns
``/health`` to 503 and ends the server."""

import dataclasses
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks
from generativeaiexamples_tpu.engine import Engine as JEngine
from generativeaiexamples_tpu.engine import EngineConfig as JConfig
from generativeaiexamples_tpu.engine import SamplingParams as JParams
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
from generativeaiexamples_tpu.models.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu.ops import fused_sampler as jfs
from generativeaiexamples_tpu.parallel import MeshPlan as JPlan
from generativeaiexamples_tpu.parallel import make_mesh as jmake_mesh
from generativeaiexamples_tpu_torch.engine import Engine
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.ops import sampling as tsamp
from generativeaiexamples_tpu_torch.parallel import mesh as tmesh
from generativeaiexamples_tpu_torch.serving import model_server
from generativeaiexamples_tpu_torch.utils.errors import ConfigError

TIMEOUT = 240
# tests/test_multichip_serving.py's geometry: vocab 320 splits over tp = 2
# into 160-token halves of whole mask words; heads 4 / kv heads 2.
LLAMA = dict(vocab_size=320, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             max_position_embeddings=512)
# GPT-Next with every bias (random, so a bias added on each rank, or
# before the all-reduce, would show).
GPTNEXT = dict(LLAMA, num_kv_heads=4, norm="layernorm1p",
               mlp="squared_relu", attn_bias=True, mlp_bias=True)
# A tiny Mixtral, capacity factor 1.0: claims drop.
MOE = dict(LLAMA, intermediate_size=96, num_experts=4, num_experts_per_tok=2,
           moe_capacity_factor=1.0)
# 168 tokens a rank: not whole mask words, so the tail downgrades.
UNSPLIT = dict(LLAMA, vocab_size=336)
ECFG = dict(max_slots=4, max_input_length=128, max_output_length=32,
            prefill_buckets=(32, 64, 128), dtype="float32", page_size=16,
            steps_per_round=4, max_queue=32)
MOE_ECFG = dict(max_slots=2, max_input_length=128, max_output_length=16,
                prefill_buckets=(32,), page_size=16, dtype="float32",
                kv_pool_tokens=None, steps_per_round=4,
                max_prefill_bucket=32, sched_round_budget_tokens=32,
                sched_prefill_chunk_tokens=32)
COPY = "the quick brown fox jumps. " * 4
GREEDY = dict(max_tokens=12, top_k=1, ignore_eos=True)


def _prompts():
    tok = ByteTokenizer()
    return ([tok.encode(COPY), tok.encode(COPY)]
            + [tok.encode(f"wave {i} " + COPY[:40]) for i in range(3)])


def _tree(kw, seed):
    """The reference's init with random norms and biases, in numpy."""
    tree = jax.tree.map(np.asarray, jllama.init_params(
        JL(**kw), jax.random.key(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    layers = dict(tree["layers"])
    for key, leaf in layers.items():
        if key.endswith("norm") or key.startswith("b") or key.endswith("_b"):
            layers[key] = (leaf + 0.1 * rng.standard_normal(leaf.shape)
                           ).astype(np.float32)
    return {**tree, "layers": layers}


def _moe_prompt(n, salt=0):
    return [1] + [3 + (7 * i + salt) % 250 for i in range(n - 1)]


MOE_BATCHES = [[(_moe_prompt(70), dict(max_tokens=8, top_k=1,
                                       ignore_eos=True)),
                (_moe_prompt(9, 1), dict(max_tokens=10, top_k=1,
                                         ignore_eos=True))],
               [(_moe_prompt(70), dict(max_tokens=6, top_k=1,
                                       ignore_eos=True))]]


def _tail_case():
    """Logits, masks, knobs, drafts and uniforms of the sharded-tail
    case, and the reference's key."""
    rng = np.random.default_rng(5)
    B, V = 6, 320
    logits = rng.standard_normal((B, V)).astype(np.float32)
    seen = rng.random((B, V)) < 0.3
    banned = rng.random((B, V)) < 0.05
    knobs = dict(temp=np.array([0.9, 1.1, 0.0, 1.0, 0.8, 1.2], np.float32),
                 top_k=np.array([0, 6, 1, 0, 12, 0], np.int32),
                 top_p=np.array([0.0, 0.0, 0.0, 0.9, 0.0, 0.85], np.float32),
                 rep_pen=np.full((B,), 1.1, np.float32))
    drafts = np.array([3, 200, 64, -1, 159, 40], np.int32)
    u = rng.random(B).astype(np.float32)
    return dict(logits=logits, seen=seen, banned=banned, knobs=knobs,
                drafts=drafts, u=u, key=jax.random.key(5), tile=32,
                cand_k=16)


@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    """Every engine of the module, in both packages and in the spawned
    ranks, plans under the same fixed costs and budget."""
    path = tmp_path_factory.mktemp("sched") / "PROFILE_default.json"
    path.write_text('{"full_ms_per_step": 2.0, "slots": 8, '
                    '"prefill_ms_per_token": 0.125}')
    saved = {k: os.environ.get(k) for k in (
        "SCHED_PROFILE_JSON", "SCHED_ONLINE_CALIB", "ENGINE_SPEC_DECODE",
        "KV_HOST_POOL_TOKENS", "ENGINE_WATCHDOG_STALL_S")}
    os.environ.update(SCHED_PROFILE_JSON=str(path), SCHED_ONLINE_CALIB="0")
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
def ranks(pinned, tmp_path_factory):
    """Port ranks running every job of the module; ``get()`` waits for
    the leaders' results (the reference engines run meanwhile)."""
    import torch.multiprocessing as mp
    case = _tail_case()
    tail = dict(logits=case["logits"], tile=case["tile"],
                cand_k=case["cand_k"], u=case["u"],
                draft_ids=case["drafts"],
                field=np.array(jfs.tiled_gumbel(case["key"], 6, 320,
                                                case["tile"])),
                knobs={**case["knobs"],
                       "seen_words": tsamp.pack_mask(torch.from_numpy(
                           case["seen"])).numpy(),
                       "banned_words": tsamp.pack_mask(torch.from_numpy(
                           case["banned"])).numpy()})
    serve = [(ids, GREEDY) for ids in _prompts()]
    jobs = [
        dict(name="llama", drive="serve", cfg=LLAMA, tree=_tree(LLAMA, 9),
             engine=ECFG, requests=serve),
        dict(name="llama_int8", drive="serve", cfg=LLAMA,
             tree=_tree(LLAMA, 9), engine=dict(ECFG, kv_quant="int8"),
             requests=serve[:3]),
        dict(name="llama_spec", drive="serve", cfg=LLAMA,
             tree=_tree(LLAMA, 9),
             engine=dict(ECFG, spec_decode=True, spec_max_draft_tokens=3),
             requests=serve[:3]),
        dict(name="llama_materialized", drive="serve", cfg=LLAMA,
             tree=_tree(LLAMA, 9), engine=dict(ECFG, fused_tail=False),
             requests=serve[:3]),
        dict(name="gptnext", drive="serve", cfg=GPTNEXT,
             tree=_tree(GPTNEXT, 4), engine=ECFG, requests=serve[:3]),
        dict(name="moe", drive="lockstep", cfg=MOE, tree=_tree(MOE, 11),
             engine=MOE_ECFG, batches=MOE_BATCHES),
        dict(name="unsplit", drive="serve", cfg=UNSPLIT,
             tree=_tree(UNSPLIT, 9), engine=ECFG, requests=serve[:2]),
        dict(name="tier", drive="serve", cfg=LLAMA, tree=_tree(LLAMA, 9),
             engine=dict(ECFG, kv_host_pool_tokens=4096),
             requests=serve[:1], handoff=True),
        dict(name="tail", drive="tail", **tail),
    ]
    # Two groups of two ranks, each running half of the jobs at once.
    ctx = mp.get_context("spawn")
    groups = []
    for g, part in enumerate((jobs[0::2], jobs[1::2])):
        q = ctx.Queue()
        path = str(tmp_path_factory.mktemp(f"tp{g}") / "group")
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


def _ref_serve(kw, tree, ecfg, prompts, kwargs=GREEDY):
    """The reference tp = 2 engine's tokens, one request at a time."""
    with JEngine(jax.tree.map(jnp.asarray, tree), JL(**kw), JTok(),
                 JConfig(**ecfg), mesh=_jmesh()) as eng:
        out = []
        for ids in prompts:
            s = eng.submit(ids, JParams(**kwargs))
            s.text()
            out.append(list(s.token_ids))
        return out, dict(eng.stats), eng


@pytest.mark.parametrize("job,ecfg,n", [
    ("llama", {}, 5), ("llama_int8", {"kv_quant": "int8"}, 3),
    ("llama_spec", {"spec_decode": True, "spec_max_draft_tokens": 3}, 3)])
def test_tp2_greedy_tokens_match_the_reference_tp2_engine(ranks, job, ecfg,
                                                          n):
    """Greedy tokens of the port's two ranks equal the reference tp = 2
    engine's over a float32 pool, an int8 pool and with speculative
    decoding on (both speculate): a cold prompt, the same prompt again (a
    prefix-cache hit) and one (float32: three) more."""
    want, stats, _ = _ref_serve(LLAMA, _tree(LLAMA, 9), dict(ECFG, **ecfg),
                                _prompts()[:n])
    got = ranks.get()[job]
    assert got["tokens"] == want
    assert got["tail_sharded"] and not got["downgrades"]
    assert got["stats"]["prefix_cache_hit_tokens"] > 0
    if job == "llama_spec":
        assert got["stats"]["spec_verify_rounds"] > 0
        assert stats["spec_verify_rounds"] > 0


def test_tp2_sharded_tail_equals_the_materialized_tail(ranks):
    """The vocab-sharded fused tail and the gathered materialized tail
    give the same greedy tokens on the same shards."""
    out = ranks.get()
    assert out["llama_materialized"]["tokens"] == out["llama"]["tokens"][:3]
    assert not out["llama_materialized"]["tail_sharded"]


def test_tp2_gptnext_biases_match_the_reference(ranks):
    """GPT-Next with random biases: each rank adds bq/bk/bv and b_up on
    its own columns, bo and b_down once after the all-reduce."""
    want, _, _ = _ref_serve(GPTNEXT, _tree(GPTNEXT, 4), ECFG, _prompts()[:3])
    assert ranks.get()["gptnext"]["tokens"] == want


def _jax_lockstep(jeng, batches, limit=600):
    """The reference engine's serve loop by hand, each plan after every
    dispatched output was read back (``tests/test_torch_moe.py``'s)."""
    jeng._stopped.clear()
    worker = threading.Thread(target=jeng._harvest_worker, daemon=True)
    jeng._harvest_thread = worker
    worker.start()
    out = []
    try:
        for batch in batches:
            streams = [jeng.submit(ids, JParams(**kw)) for ids, kw in batch]
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
            out.append([list(s.token_ids) for s in streams])
    finally:
        jeng._stopped.set()
        worker.join(TIMEOUT)
        jeng._harvest_thread = None
    return out


def test_tp2_moe_tokens_match_the_reference_in_lockstep(ranks):
    """A tiny Mixtral at tp = 2 (each rank F/2 of every expert, routing
    replicated, one all-reduce after the combine), driven batch by batch
    in lockstep with the reference tp = 2 engine: a 70-token prompt in
    chunks beside a short one, then the long one again (a prefix hit)."""
    jeng = JEngine(jax.tree.map(jnp.asarray, _tree(MOE, 11)), JL(**MOE),
                   JTok(), JConfig(**MOE_ECFG), mesh=_jmesh())
    want = _jax_lockstep(jeng, MOE_BATCHES)
    got = ranks.get()["moe"]
    assert got["tokens"] == want
    assert got["stats"]["prefill_chunks"] >= 3
    assert got["stats"]["prefix_cache_hit_tokens"] > 0


def test_tp2_unsplittable_vocab_downgrades_observably(ranks):
    """168 tokens a rank is not whole mask words: both packages take the
    materialized tail, the port says so (``downgrades``, the stat) and
    still serves the reference's tokens."""
    want, stats, eng = _ref_serve(UNSPLIT, _tree(UNSPLIT, 9), ECFG,
                                  _prompts()[:2])
    got = ranks.get()["unsplit"]
    assert got["tokens"] == want
    assert not got["tail_sharded"]
    assert got["stats"]["downgrades"] == 1 == stats["downgrades"]
    (down,) = got["downgrades"]
    assert down["feature"] == "fused_sampler"
    assert down["fallback"] == "materialized_tail"
    assert "tp=2" in down["reason"]
    assert [d["feature"] for d in eng.downgrades] == ["fused_sampler"]


def test_tp2_sharded_tails_match_the_reference_on_its_noise(ranks):
    """``fused_unembed_sample_tp`` (sampled and greedy) and
    ``fused_verify_sample_tp`` over two ranks' vocab halves give the
    reference's sharded tails' exact tokens and verdicts, the noise being
    the reference's own field read by global tile."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from generativeaiexamples_tpu.ops.sampling import pack_mask as jpack
    case = _tail_case()
    mesh = _jmesh()
    V = 320
    eye = jax.device_put(jnp.eye(V, dtype=jnp.float32),
                         NamedSharding(mesh, P(None, "tp")))
    logits = jnp.asarray(case["logits"])
    k = {n: jnp.asarray(v) for n, v in case["knobs"].items()}
    words = dict(seen_words=jpack(jnp.asarray(case["seen"])),
                 banned_words=jpack(jnp.asarray(case["banned"])))

    def local(head_local, hn, t0, tile):
        sl = jax.lax.dynamic_slice_in_dim(head_local["lm_head"], t0, tile,
                                          axis=1)
        return jax.lax.dot_general(hn, sl, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)

    common = dict(tile=case["tile"], cand_k=case["cand_k"], **k, **words)
    got = ranks.get()["tail"]
    for greedy in (False, True):
        want = jax.jit(lambda hd, h: jfs.fused_unembed_sample_tp(
            mesh, "tp", {"lm_head": hd}, {"lm_head": P(None, "tp")}, local,
            V, hn=h, key=case["key"], greedy=greedy, **common))(eye, logits)
        np.testing.assert_array_equal(got[f"sample_greedy={greedy}"],
                                      np.asarray(want))
    acc, tok = jax.jit(lambda hd, h: jfs.fused_verify_sample_tp(
        mesh, "tp", {"lm_head": hd}, {"lm_head": P(None, "tp")}, local, V,
        hn=h, key=case["key"], u=jnp.asarray(case["u"]),
        draft_ids=jnp.asarray(case["drafts"]), **common))(eye, logits)
    np.testing.assert_array_equal(got["verify"][0], np.asarray(acc))
    np.testing.assert_array_equal(got["verify"][1], np.asarray(tok))


def test_tp2_tier_and_handoff_are_refused(ranks):
    """Once refused at tp > 1, the host KV tier and the fleet handoff now
    serve there: an engine with the tier constructs, serves the tierless
    engine's tokens, and ``export_handoff`` gives a blob of the whole
    model's blocks (its 2 kv heads, as a one-card engine writes them);
    tests/test_torch_tp_features.py continues such blobs across
    topologies."""
    from generativeaiexamples_tpu_torch.engine.kv_tier import from_blob
    out = ranks.get()
    assert "refused" not in out["tier"]
    assert out["tier"]["tokens"] == out["llama"]["tokens"][:1]
    blob, blocks = out["tier"]["handoff"]
    meta, records = from_blob(blob)
    assert blocks == len(records) > 0
    assert meta["num_kv_heads"] == LLAMA["num_kv_heads"]
    assert records[0].arrays["k"].shape == (
        LLAMA["num_layers"], LLAMA["num_kv_heads"], ECFG["page_size"],
        LLAMA["head_dim"])


def _gate(kw, device, **axes):
    """A construction-time stand-in for ``Engine._check_topology``."""
    plan = tmesh.MeshPlan(tp=axes.pop("tp"), **axes)
    n = int(np.prod([getattr(plan, a) or 1 for a in tmesh.AXES]))
    mesh = tmesh.Mesh(shape={a: getattr(plan.resolve(n), a)
                             for a in tmesh.AXES}, world=n,
                      device=torch.device(device))
    return types.SimpleNamespace(mesh=mesh, device=torch.device(device))


@pytest.mark.parametrize("kw,device,axes,match", [
    (LLAMA, "cuda", dict(tp=2, pp=2), "pp == 1"),
    (LLAMA, "cpu", dict(tp=2, pp=2), "pp == 1"),
    (LLAMA, "cuda", dict(tp=4), r"heads 4/2 must divide tp=4"),
    (LLAMA, "cpu", dict(tp=2, sp=2), "A12"),
    (LLAMA, "cuda", dict(tp=2), None),
    (LLAMA, "cpu", dict(tp=4), None),
])
def test_topology_gates(kw, device, axes, match):
    """Serving refuses pp > 1 (the reference's message) and sp/ep; on the
    card, head counts that do not divide tp (the reference falls back to
    its gather path, the port refuses); the CPU serves them plainly."""
    gate = _gate(kw, device, **axes)
    if match is None:
        Engine._check_topology(gate, LlamaConfig(**kw))
        return
    with pytest.raises(ConfigError, match=match):
        Engine._check_topology(gate, LlamaConfig(**kw))


@pytest.mark.parametrize("args", [(0, 0, 1, 4), (4, 0, 1, 4), (2, 2, 1, 4),
                                  (4, 2, 1, 4), (8, 0, 1, 4), (0, 0, 2, 4),
                                  (0, 3, 1, 4)])
def test_resolve_topology_matches_the_reference(args):
    """The reference's defaults and refusals. The pp refusal's message
    differs past its first sentence only: the port serves over tp alone
    and has no api-reference page to point to."""
    from generativeaiexamples_tpu.serving import model_server as jserver
    from generativeaiexamples_tpu.utils.errors import ConfigError as JErr

    def run(fn, err):
        try:
            return fn(*args[:3], available=args[3])
        except err as exc:
            return str(exc)
    got = run(model_server.resolve_topology, ConfigError)
    want = run(jserver.resolve_topology, JErr)
    if isinstance(want, str) and want.startswith("serving requires pp"):
        assert got.split(":")[0] == want.split(":")[0]
    else:
        assert got == want


def test_cli_topology_flags_have_the_references_defaults():
    args = model_server._parser().parse_args([])
    assert (args.world_size, args.tensor_parallelism,
            args.pipeline_parallelism) == (0, 0, 1)


@pytest.mark.parametrize("argv,env,available,want", [
    ([], False, 4, (4, 4, 1)),
    (["--model-path", "{ckpt}"], False, 4, (4, 4, 1)),
    ([], True, 4, (4, 4, 1)),
    (["--tensor-parallelism", "4"], False, 4, (4, 4, 1)),
    (["--world-size", "4"], False, 4, (4, 4, 1)),
    (["--device", "cpu", "--world-size", "2"], False, None, (2, 2, 1)),
    (["--tensor-parallelism", "4", "--model-path", "{ckpt}"], False, 4,
     (4, 4, 1)),
    (["--tensor-parallelism", "2"], True, 4, (2, 2, 1)),
    (["--world-size", "2", "--device", "cuda:1"], False, 4,
     "names one card"),
    (["--tensor-parallelism", "8"], False, 4, "exceeds available"),
    (["--pipeline-parallelism", "2"], False, 4, "pp == 1"),
    (["--device", "cuda:1", "--model-path", "{ckpt}"], False, 4, (1, 1, 1)),
    (["--device", "cpu"], False, None, (1, 1, 1)),
    ([], False, 1, (1, 1, 1)),
])
def test_cli_topology_serves_one_card_unless_asked(argv, env, available,
                                                   want, tmp_path,
                                                   monkeypatch):
    """The CLI's world defaults to every local card, as the reference's
    does, now that a checkpoint directory (``--model-path`` or AzureML's)
    and ``/v1/score`` serve at tp > 1; ``--device cuda:N`` serves on that
    one card, and a world above one with it is refused before any process
    starts; ``--device cpu`` is one process unless a world is asked
    for."""
    ckpt = tmp_path / "aml" / "llama"
    ckpt.mkdir(parents=True)
    monkeypatch.delenv("MODEL_PATH", raising=False)
    if env:
        monkeypatch.setenv("AZUREML_MODEL_DIR", str(tmp_path / "aml"))
    else:
        monkeypatch.delenv("AZUREML_MODEL_DIR", raising=False)
    args = model_server._parser().parse_args(
        [a.format(ckpt=ckpt) for a in argv])
    if isinstance(want, str):
        with pytest.raises(ConfigError, match=want):
            model_server.cli_topology(args, available=available)
    else:
        assert model_server.cli_topology(args, available=available) == want


def _rank_mesh(tp: int, rank: int = 0) -> tmesh.Mesh:
    """Rank ``rank``'s mesh at ``tp`` without a process group (the rules
    ask only whether one exists)."""
    return tmesh.Mesh(shape={"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": tp},
                      rank=rank, world=tp, tp_group=object())


@pytest.mark.parametrize("name,tp,want", [
    ("llama-2-7b-chat", 1, 128), ("llama-2-7b-chat", 4, 64),
    ("llama-2-70b-chat", 4, 128), ("mixtral-8x7b-instruct", 4, 128)])
def test_awq_group_tiles_each_ranks_rows(name, tp, want):
    """int4_awq's group divides the reduction rows each rank keeps: at
    tp = 4 llama-2-7b's w_down holds F/4 = 2752 rows, 21.5 groups of
    128, so its group is 64."""
    from generativeaiexamples_tpu_torch.models.configs import \
        get_model_config
    mesh = _rank_mesh(tp) if tp > 1 else None
    assert model_server.awq_group(get_model_config(name), mesh) == want


def test_awq_group_lets_every_rank_draw_its_shard():
    """A geometry whose F/tp rows do not tile into groups of 128 draws its
    int4_awq shards at ``awq_group``'s group on every rank; at 128 the
    split fails."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.utils.errors import ShardingError
    cfg = LlamaConfig(**dict(LLAMA, hidden_size=128, intermediate_size=384,
                             num_heads=4, num_kv_heads=2, head_dim=32))
    group = model_server.awq_group(cfg, _rank_mesh(2))
    assert group == 64 and model_server.awq_group(cfg) == 128
    for rank in range(2):
        shard = llama.init_params(cfg, 0, torch.float32,
                                  mesh=_rank_mesh(2, rank),
                                  quantization="int4_awq", group_size=group)
        assert shard["layers"]["w_down"]["gscale"].shape[1] == 3
    with pytest.raises(ShardingError, match="does not split"):
        llama.init_params(cfg, 0, torch.float32, mesh=_rank_mesh(2),
                          quantization="int4_awq", group_size=128)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


def test_cli_serves_at_tp2_and_a_dead_follower_ends_it():
    """``python -m generativeaiexamples_tpu_torch.serving llama-tiny
    --device cpu --world-size 2``: rank 0 answers /v1/completions and
    /debug/launches (both ranks' counters); when the follower dies,
    /health answers 503 and the server exits non-zero instead of
    hanging."""
    import json
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, HISTORY_INTERVAL_S="0",
               PYTHONPATH=os.pathsep.join(sys.path))
    cmd = [sys.executable, "-m", "generativeaiexamples_tpu_torch.serving",
           "llama-tiny", "--device", "cpu", "--world-size", "2",
           "--no-embedder", "--grpc-port", "0", "--port", str(port),
           "--max-input-length", "64", "--max-output-length", "16",
           "--max-batch-size", "2", "--dtype", "float32"]
    with tempfile.TemporaryFile() as log:
        proc = subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        base = f"http://127.0.0.1:{port}"
        try:
            deadline = time.monotonic() + TIMEOUT
            while True:
                assert proc.poll() is None, "the server exited"
                try:
                    status, body = _get(base + "/health")
                    break
                except OSError:
                    assert time.monotonic() < deadline, "no /health"
                    time.sleep(0.5)
            assert json.loads(body)["tp"] == 2
            req = urllib.request.Request(
                base + "/v1/completions", data=json.dumps(
                    {"prompt": "hello", "max_tokens": 5,
                     "temperature": 0}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                done = json.loads(resp.read())
            assert done["usage"]["completion_tokens"] == 5
            ranks = json.loads(_get(base + "/debug/launches")[1])["ranks"]
            assert len(ranks) == 2
            children = subprocess.run(
                ["pgrep", "-P", str(proc.pid)], capture_output=True,
                text=True).stdout.split()
            followers = [int(c) for c in children
                         if "spawn_main" in open(f"/proc/{c}/cmdline").read()]
            assert len(followers) == 1
            os.kill(followers[0], signal.SIGKILL)
            codes = []
            while proc.poll() is None and time.monotonic() < deadline:
                try:
                    codes.append(_get(base + "/health")[0])
                except urllib.error.HTTPError as exc:
                    codes.append(exc.code)
                except OSError:
                    pass
                time.sleep(0.1)
            assert 503 in codes
            assert proc.wait(timeout=30) == 1
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(10)
