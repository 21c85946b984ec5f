"""Ranks of the port over the rest of the serving mesh (ep, sp, dp) for the
CPU tests: each a spawned process in one gloo group of four
(``init_method=file://``), running a list of jobs, each on the mesh of
its ``plan`` (``MeshPlan`` keywords: every rank makes every job's mesh,
in job order). Imports no jax: only the test process runs the JAX
package.

A job's ``drive`` names what it runs:

- "ring": ``ring_gqa_attention`` on this rank's sequence block of the
  given q/k/v, causal and not;
- "moe": ``ep_sparse_moe_ffn``, ``sparse_moe_ffn(..., mesh=)``, the dense
  ``moe_impl`` and ``ep_expert_ffn`` on this rank's expert block;
- "sp": ``apply_sp``, ``apply_prefill_sp`` and ``score`` over sp;
- "tree": ``llama.init_params(..., mesh=)`` and
  ``params_from_numpy(..., mesh=)``, this rank's tree;
- "engine": an ``Engine`` over the mesh, the leader serving the requests
  one at a time (or ``batches`` in lockstep) while the others follow;
  each rank's pool after the last request.

Every job's result is gathered on the leader, rank 0, as
``[(coords, result) for each rank]``; the leader puts {job name: that}
on the queue, the others None.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

import torch_tp_ranks
from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.parallel import comm, moe
from generativeaiexamples_tpu_torch.parallel.mesh import (
    MeshPlan, make_mesh, maybe_init_distributed)
from generativeaiexamples_tpu_torch.parallel.ring_attention import \
    ring_gqa_attention


def rank_main(rank: int, world: int, path: str, queue, jobs: list) -> None:
    torch.set_num_threads(1)
    try:
        maybe_init_distributed(f"file://{path}", world, rank, device="cpu",
                               timeout_s=120)
        out = {}
        for job in jobs:
            mesh = make_mesh(MeshPlan(**job["plan"]), device="cpu")
            mine = DRIVES[job["drive"]](job, mesh)
            out[job["name"]] = comm.gather_to_leader(
                (mesh.coords, mine), mesh)
        queue.put((rank, "ok", out if rank == 0 else None))
    except BaseException:  # noqa: BLE001 - reported to the test
        queue.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _sp_rows(mesh, n: int) -> slice:
    """This rank's contiguous block of ``n`` rows over sp."""
    per = n // mesh.shape["sp"]
    r = mesh.coords["sp"]
    return slice(r * per, (r + 1) * per)


def job_ring(job: dict, mesh):
    q, k, v, pos = (_t(job[n]) for n in ("q", "k", "v", "pos"))
    rows = _sp_rows(mesh, q.shape[1])
    return {f"causal={c}": _np(ring_gqa_attention(
        q[:, rows], k[:, rows], v[:, rows], pos[:, rows], mesh=mesh,
        causal=c, q_tile=job["q_tile"])) for c in (True, False)}


def _layer_shard(job: dict, mesh) -> tuple:
    cfg = LlamaConfig(**job["cfg"])
    params = params_from_numpy(job["tree"], "cpu", torch.float32, cfg=cfg,
                               mesh=mesh)
    return cfg, llama.layer_params(params, 0)


def job_moe(job: dict, mesh):
    """The expert-parallel layer on this rank's shard: the sparse layer
    (both entry points), the dense oracle, and ``ep_expert_ffn`` on this
    rank's block of the given buffers."""
    import dataclasses
    cfg, lp = _layer_shard(job, mesh)
    x = _t(job["x"])
    out = {"ep_sparse": _np(moe.ep_sparse_moe_ffn(mesh, x, lp, cfg)),
           "sparse": _np(moe.sparse_moe_ffn(x, lp, cfg, mesh=mesh)),
           "dense": _np(llama._moe_mlp(x, lp, dataclasses.replace(
               cfg, moe_impl="dense"), mesh))}
    e0, n = moe.expert_block(cfg, mesh)
    ei = _t(job["expert_in"])[e0:e0 + n]
    out["expert_ffn"] = _np(moe.ep_expert_ffn(
        mesh, ei, lp["w_gate"], lp["w_up"], lp["w_down"]))
    return out


def job_sp(job: dict, mesh):
    cfg = LlamaConfig(**job["cfg"])
    params = params_from_numpy(job["tree"], "cpu", torch.float32, cfg=cfg)
    tokens, pos = _t(job["tokens"]), _t(job["pos"])
    # Serving's one request: B = 1, replicated over dp.
    k, v, last = llama.apply_prefill_sp(params, cfg, tokens[:1], pos[:1],
                                        mesh, _t(job["length"]))
    return {"apply_sp": _np(llama.apply_sp(params, cfg, tokens, pos, mesh)),
            "prefill_k": _np(k), "prefill_v": _np(v),
            "prefill_logits": _np(last),
            "score": _np(llama.score(params, cfg, _t(job["score_ids"]),
                                     mesh=mesh))}


def job_tree(job: dict, mesh):
    cfg = LlamaConfig(**job["cfg"])
    from generativeaiexamples_tpu_torch.models.weight_cache import flatten
    made = llama.init_params(cfg, job["seed"], torch.float32, mesh=mesh)
    read = params_from_numpy(job["tree"], "cpu", torch.float32, cfg=cfg,
                             mesh=mesh)
    return {"init": {k: v.numpy() for k, v in flatten(made).items()},
            "numpy": {k: v.numpy() for k, v in flatten(read).items()}}


def job_engine(job: dict, mesh):
    """An engine over the mesh: the leader serves (requests one at a time,
    or ``batches`` in lockstep), the others follow; every rank's pool
    (the pages past the trash page) after the last request."""
    cfg = LlamaConfig(**job["cfg"])
    params = params_from_numpy(job["tree"], "cpu", torch.float32, cfg=cfg)
    engine = Engine(params, cfg, ByteTokenizer(),
                    EngineConfig(**job["engine"]), device="cpu", mesh=mesh)
    out: dict = {}
    if engine.leader:
        if "batches" in job:
            out["tokens"] = torch_tp_ranks.lockstep(engine, job["batches"])
        else:
            out["tokens"] = []
            for ids, kw in job["requests"]:
                stream = engine.submit(ids, SamplingParams(**kw))
                torch_tp_ranks.drive(engine, [stream])
                out["tokens"].append(list(stream.token_ids))
        out["stats"] = dict(engine.stats)
        out["reports"] = engine.rank_reports()
    else:
        engine.follow()
    out["pool"] = {k: v[:, 1:].numpy()
                   for k, v in engine._state["cache"].items()}
    engine.close()
    return out


DRIVES = {"ring": job_ring, "moe": job_moe, "sp": job_sp, "tree": job_tree,
          "engine": job_engine}
