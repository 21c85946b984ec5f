"""Tensor-parallel ranks of the port for the CPU tests: each a spawned
process in one gloo group (``init_method=file://`` under the test's
``tmp_path``, so concurrent test workers never share a port), running a
list of jobs on its shard. Imports no jax: only the test process runs the
JAX package.

A job is a dict: ``cfg`` (LlamaConfig keywords), ``tree`` (the numpy
parameter tree), ``engine`` (EngineConfig keywords), ``requests``
((prompt ids, SamplingParams keywords)), and ``drive``: "serve" (the
leader's serve loop, one request at a time), "lockstep" (batches of
requests through ``Engine._step`` by hand, each plan after every output
is read back), "tail" (``fused_unembed_sample_tp`` and
``fused_verify_sample_tp`` on given logits and noise), or one of the
tp features: "ckpt" (``build_services`` over a checkpoint directory,
twice: the weight cache), "score" (``Engine.score``), "tier" (offload,
restore, suspend/resume, the handoff's export and import), "rag" (fused
RAG), "rag_chain" (the QA chatbot's fused ``/generate`` chain) and
"prewarm_oom" (an out-of-memory error on one rank during
``prewarm``). The leader, rank 0, puts {job name: result} on the queue;
the other ranks put None (what a follower must report, the leader
gathers).
"""

from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.ops import fused_sampler as tfs
from generativeaiexamples_tpu_torch.parallel.mesh import (
    MeshPlan, make_mesh, maybe_init_distributed)
from generativeaiexamples_tpu_torch.utils.errors import ConfigError


def rank_main(rank: int, world: int, path: str, queue, jobs: list) -> None:
    # Tiny shapes: one intra-op thread a rank keeps the ranks (and the
    # test process beside them) off each other's cores.
    torch.set_num_threads(1)
    try:
        maybe_init_distributed(f"file://{path}", world, rank, device="cpu",
                               timeout_s=120)
        mesh = make_mesh(MeshPlan(tp=world), device="cpu")
        out = {job["name"]: run_job(job, mesh) for job in jobs}
        queue.put((rank, "ok", out if mesh.leader else None))
    except BaseException:  # noqa: BLE001 - reported to the test
        queue.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_job(job: dict, mesh):
    if job["drive"] == "tail":
        return run_tail(job, mesh)
    if job["drive"] in FEATURES:
        return FEATURES[job["drive"]](job, mesh)
    cfg = LlamaConfig(**job["cfg"])
    params = params_from_numpy(job["tree"], "cpu", torch.float32, cfg=cfg,
                               mesh=mesh)
    try:
        engine = Engine(params, cfg, ByteTokenizer(),
                        EngineConfig(**job["engine"]), device="cpu",
                        mesh=mesh)
    except ConfigError as exc:
        return {"refused": str(exc)}
    if not engine.leader:
        engine.follow()
        engine.close()
        return None
    try:
        if job["drive"] == "lockstep":
            tokens = lockstep(engine, job["batches"])
        else:
            tokens = []
            for ids, kw in job["requests"]:
                stream = engine.submit(ids, SamplingParams(**kw))
                drive(engine, [stream])
                tokens.append(list(stream.token_ids))
        handoff = None
        if job.get("handoff"):
            handoff = engine.export_handoff(job["requests"][0][0])
        return {"tokens": tokens, "stats": dict(engine.stats),
                "downgrades": engine.downgrades,
                "tail_sharded": engine._tail_sharded,
                "handoff": handoff}
    finally:
        engine.close()


def drive(engine, streams, limit: int = 2000) -> None:
    """The leader's serve loop by hand: each ``_step`` reads its outputs
    back before the next plan."""
    for _ in range(limit):
        if all(s.finish_reason is not None for s in streams) \
                and not engine._slots:
            return
        engine._step()
    raise AssertionError("requests did not finish")


def lockstep(engine, batches) -> list:
    out = []
    for batch in batches:
        streams = [engine.submit(ids, SamplingParams(**kw))
                   for ids, kw in batch]
        drive(engine, streams)
        out.append([list(s.token_ids) for s in streams])
    return out


def run_tail(job: dict, mesh):
    """The sharded fused tails on this rank's vocab shard of the given
    logits, with the reference's noise field read per global tile."""
    logits = torch.from_numpy(job["logits"])
    field = job["field"]
    V = logits.shape[1]
    Vl = V // mesh.tp
    local = logits[:, mesh.tp_rank * Vl:(mesh.tp_rank + 1) * Vl]
    tile = job["tile"]

    def noise(t):
        return torch.from_numpy(np.ascontiguousarray(
            field[:, t * tile:(t + 1) * tile]))

    knobs = {k: torch.from_numpy(v) for k, v in job["knobs"].items()}
    out = {}
    for greedy in (False, True):
        out[f"sample_greedy={greedy}"] = tfs.fused_unembed_sample_tp(
            mesh, lambda t0, n: local[:, t0:t0 + n], V, noise=noise,
            greedy=greedy, tile=tile, cand_k=job["cand_k"], **knobs).numpy()
    verify = {k: v for k, v in knobs.items() if k not in ("ban_tok",
                                                            "ban_hit")}
    acc, tok = tfs.fused_verify_sample_tp(
        mesh, lambda t0, n: local[:, t0:t0 + n], V, noise=noise,
        u=torch.from_numpy(job["u"]),
        draft_ids=torch.from_numpy(job["draft_ids"]), tile=tile,
        cand_k=job["cand_k"], **verify)
    out["verify"] = (acc.numpy(), tok.numpy())
    return out if mesh.leader else None


# ------------------------------------------------------------ tp features

def _engine(job: dict, mesh, **kw):
    cfg = LlamaConfig(**job["cfg"])
    params = params_from_numpy(job["tree"], "cpu", torch.float32, cfg=cfg,
                               mesh=mesh)
    return Engine(params, cfg, ByteTokenizer(),
                  EngineConfig(**{**job["engine"], **kw}), device="cpu",
                  mesh=mesh)


def _follow(engine) -> None:
    engine.follow()
    engine.close()


def _serve_one(engine, ids, kw) -> list:
    stream = engine.submit(ids, SamplingParams(**kw))
    drive(engine, [stream])
    return list(stream.token_ids)


def _trees_equal(got, want) -> bool:
    from generativeaiexamples_tpu_torch.models.weight_cache import flatten
    g, w = flatten(got), flatten(want)
    return sorted(g) == sorted(w) and all(
        g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]) for k in g)


def job_ckpt(job: dict, mesh):
    """``build_services`` over a checkpoint directory on every rank, with
    a quantization at load, three times over one weight cache: each
    rank's served tree against ``shard_params`` of the whole tree
    quantized on one rank, the cache's hit on the second start, and on
    the third, after rank ``drop_rank`` deleted its own entry, every
    rank's conversion; the leader serves a request and ``/v1/score``
    through the model server's app at each start."""
    import asyncio
    import os
    import shutil

    from aiohttp.test_utils import TestClient, TestServer

    from generativeaiexamples_tpu_torch.models import weight_cache
    from generativeaiexamples_tpu_torch.models.import_hf import \
        load_checkpoint
    from generativeaiexamples_tpu_torch.parallel import comm
    from generativeaiexamples_tpu_torch.parallel.sharding import (
        llama_param_specs, shard_params)
    from generativeaiexamples_tpu_torch.serving import model_server as ms
    os.environ["GAIE_WEIGHT_CACHE_DIR"] = job["cache_dir"]
    os.environ.pop("GAIE_SKIP_HASH", None)
    mine: dict = {"rank": mesh.tp_rank, "equal": [], "from_cache": []}
    out: dict = {"tokens": [], "score": []}
    for start in range(3):
        if start == 2 and mesh.tp_rank == job["drop_rank"]:
            shutil.rmtree(os.path.join(weight_cache.cache_root(),
                                       weight_cache._entry(mine["identity"])))
        engine, _ = ms.build_services(
            job["model"], engine_cfg=EngineConfig(**job["engine"]),
            device="cpu", tokenizer=ByteTokenizer(),
            quantization=job["quantization"], model_path=job["path"],
            world_size=mesh.tp)
        cfg = engine.model_cfg
        whole = ms._quantize(load_checkpoint(job["path"], cfg,
                                             torch.float32, "cpu"),
                             cfg, job["quantization"])
        mine["equal"].append(_trees_equal(
            engine.params, shard_params(whole, mesh,
                                        llama_param_specs(cfg, mesh))))
        mine["from_cache"].append(ms.last_load["from_cache"])
        mine["identity"] = ms.last_load["identity"]
        if not engine.leader:
            _follow(engine)
            continue
        try:
            out["tokens"].append(_serve_one(engine, *job["requests"][0]))

            async def score():
                app = ms.create_server_app(engine, None, "tiny")
                async with TestClient(TestServer(app)) as client:
                    resp = await client.post("/v1/score", json={
                        "tokens": job["score_ids"], "chunk": 64,
                        "per_token": True})
                    return resp.status, await resp.json()
            out["score"].append(asyncio.run(score()))
        finally:
            engine.close()
    ranks = comm.gather_to_leader(mine, mesh)
    return dict(out, ranks=ranks) if mesh.leader else None


def job_score(job: dict, mesh):
    """``Engine.score`` on the leader (every rank runs the tp forward): a
    short text in one pass, a longer one in chunks over the dense
    cache."""
    engine = _engine(job, mesh)
    if not engine.leader:
        return _follow(engine)
    try:
        return {name: engine.score(ids, chunk)
                for name, (ids, chunk) in job["docs"].items()}
    finally:
        engine.close()


def job_tier(job: dict, mesh):
    """The host KV tier at tp: a prompt evicted by others and offloaded,
    then restored; a session suspended, resumed and continued; the
    handoff's export of a finished prompt, and the import of a one-rank
    engine's export (``job["blob"]``) continued here."""
    from generativeaiexamples_tpu_torch.engine.kv_tier import from_blob
    engine = _engine(job, mesh)
    if not engine.leader:
        return _follow(engine)
    kw = job["sampling"]
    out: dict = {}
    try:
        p = job["prompts"]
        out["offload_cold"] = _serve_one(engine, p["offload"], kw)
        for other in p["churn"]:
            _serve_one(engine, other, kw)
        out["offload_warm"] = _serve_one(engine, p["offload"], kw)
        out["offloaded"] = engine.stats["kv_tier_offload_pages"]
        out["restored"] = engine.stats["kv_tier_restore_pages"]
        out["cold"] = _serve_one(engine, p["history"], kw)
        blob = engine.suspend_session(p["history"])
        out["suspend_meta"] = from_blob(blob)[0]
        out["resumed"] = engine.resume_session(blob)
        before = engine.stats["kv_tier_restore_pages"]
        out["warm"] = _serve_one(engine, p["history"], kw)
        out["warm_restored"] = engine.stats["kv_tier_restore_pages"] - before
        _serve_one(engine, p["handoff"], kw)
        out["handoff"] = engine.export_handoff(p["handoff"])
        out["imported"] = engine.resume_session(job["blob"])
        before = engine.stats["kv_tier_restore_pages"]
        out["import_tokens"] = _serve_one(engine, p["import"], kw)
        out["import_restored"] = (engine.stats["kv_tier_restore_pages"]
                                  - before)
        return out
    finally:
        engine.close()


def job_rag(job: dict, mesh):
    """Fused RAG at tp: the leader enables it with its encoder and corpus
    (the followers get both by broadcast) and serves fused requests."""
    from generativeaiexamples_tpu_torch.engine.rag_fusion import FusedRagSpec
    from generativeaiexamples_tpu_torch.models import encoder as enc
    from generativeaiexamples_tpu_torch.models.configs import ENCODER_TINY
    engine = _engine(job, mesh)
    if not engine.leader:
        return _follow(engine)
    try:
        engine.enable_fused_rag(
            enc.encoder_params_from_numpy(job["enc_tree"], ENCODER_TINY),
            ENCODER_TINY, FusedRagSpec(**job["spec"]))
        engine.set_rag_corpus(*job["corpus"])
        out = []
        for q_ids, q_enc, kw in job["questions"]:
            stream = engine.submit_rag(q_ids, q_enc, SamplingParams(**kw))
            drive(engine, [stream])
            out.append((list(stream.token_ids), list(stream.source_ids),
                        stream.rag_length))
        plain = [_serve_one(engine, ids, kw) for ids, kw in job["plain"]]
        return {"fused": out, "plain": plain,
                "admissions": engine.stats["rag_admissions"]}
    finally:
        engine.close()


def job_rag_chain(job: dict, mesh):
    """The QA chatbot's ``/generate`` chain (``QAChatbot.rag_chain``) over
    the leader's tp engine and an encoder-tiny ``EmbeddingService``: the
    chatbot turns fused RAG on, ingests the document and answers."""
    from generativeaiexamples_tpu_torch.chains.examples.developer_rag \
        import QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import EngineLLM
    from generativeaiexamples_tpu_torch.embed.encoder import \
        EmbeddingService
    from generativeaiexamples_tpu_torch.models import encoder as enc
    from generativeaiexamples_tpu_torch.models.configs import ENCODER_TINY
    from generativeaiexamples_tpu_torch.utils.app_config import AppConfig
    from generativeaiexamples_tpu_torch.utils.configuration import from_dict
    engine = _engine(job, mesh)
    if not engine.leader:
        return _follow(engine)
    try:
        emb = EmbeddingService(
            enc.encoder_params_from_numpy(job["enc_tree"], ENCODER_TINY),
            ENCODER_TINY, ByteTokenizer(), max_length=64,
            seq_buckets=(32, 64))
        bot = QAChatbot(llm=EngineLLM(engine), embedder=emb,
                        config=from_dict(AppConfig, job["chain"]))
        bot.ingest_docs(job["doc"], "d.txt")
        text = "".join(bot.rag_chain(job["question"], 6))
        return {"text": text, "sources": bot.last_sources,
                "fused": bot._fused_ready,
                "admissions": engine.stats["rag_admissions"]}
    finally:
        engine.close()


def job_prewarm_oom(job: dict, mesh):
    """``prewarm`` with an out-of-memory error on rank ``job["oom_rank"]``
    alone, at its first attempt's slack: every rank must shrink and
    rebuild to one page count, then serve."""
    engine = _engine(job, mesh)
    if mesh.tp_rank == job["oom_rank"]:
        real, failed = engine._alloc_slack, []

        def alloc():
            if not failed:
                failed.append(True)
                raise torch.cuda.OutOfMemoryError("injected on this rank")
            return real()
        engine._alloc_slack = alloc
    if not engine.leader:
        return _follow(engine)
    try:
        pages0 = engine.stats["pool_pages"]
        engine.prewarm()
        pages = [r["pool_pages"] for r in engine.rank_reports()]
        tokens = _serve_one(engine, *job["requests"][0])
        return {"pages0": pages0, "pages": pages, "tokens": tokens,
                "fatal": repr(engine._fatal)}
    finally:
        engine.close()


FEATURES = {"ckpt": job_ckpt, "score": job_score, "tier": job_tier,
            "rag": job_rag, "rag_chain": job_rag_chain,
            "prewarm_oom": job_prewarm_oom}
