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
is read back), or "tail" (``fused_unembed_sample_tp`` and
``fused_verify_sample_tp`` on given logits and noise). The leader, rank
0, puts {job name: result} on the queue; the other ranks put None.
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
        refusal = None
        if job.get("handoff"):
            try:
                engine.export_handoff(job["requests"][0][0])
            except ConfigError as exc:
                refusal = str(exc)
        return {"tokens": tokens, "stats": dict(engine.stats),
                "downgrades": engine.downgrades,
                "tail_sharded": engine._tail_sharded,
                "handoff_refused": refusal}
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
