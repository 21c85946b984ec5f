"""Serving over the rest of the mesh on the CPU: expert parallelism (ep),
the ring-attention prefill and score over sp, dp replicas and the CLI's
multi-host rendezvous. Four gloo ranks (``tests/torch_mesh_ranks.py``,
spawned once for the module, every job's mesh made in turn) against the
JAX package on the same mesh shapes of the conftest's CPU devices, with
the same numpy inputs: float32 functions within 1e-5 x max|ref|, engines'
greedy tokens equal and their pools within 1e-5 x max|ref| on every
rank."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks
from generativeaiexamples_tpu.engine import Engine as JEngine
from generativeaiexamples_tpu.engine import EngineConfig as JConfig
from generativeaiexamples_tpu.engine import SamplingParams as JParams
from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
from generativeaiexamples_tpu.models.tokenizer import ByteTokenizer as JTok
from generativeaiexamples_tpu.parallel import MeshPlan as JPlan
from generativeaiexamples_tpu.parallel import make_mesh as jmake_mesh
from generativeaiexamples_tpu.parallel import moe as jmoe
from generativeaiexamples_tpu.parallel.sharding import \
    llama_param_specs as jspecs
from generativeaiexamples_tpu_torch.engine import Engine
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.parallel import mesh as tmesh
from generativeaiexamples_tpu_torch.serving import model_server
from generativeaiexamples_tpu_torch.utils.errors import (ConfigError,
                                                         ShardingError)

TIMEOUT = 300
RTOL = 1e-5
# A tiny Mixtral (tests/test_torch_multichip_serving.py's): 4 experts,
# top-2, capacity factor 1.0 (claims drop), heads 4 / kv heads 2.
MOE = dict(vocab_size=320, hidden_size=64, intermediate_size=96,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
           max_position_embeddings=512, num_experts=4,
           num_experts_per_tok=2, moe_capacity_factor=1.0)
MOE_ECFG = dict(max_slots=2, max_input_length=128, max_output_length=16,
                prefill_buckets=(32,), page_size=16, dtype="float32",
                kv_pool_tokens=None, steps_per_round=4,
                max_prefill_bucket=32, sched_round_budget_tokens=32,
                sched_prefill_chunk_tokens=32)
# The reference's sp serving geometry (__graft_entry__.py): a bucket of
# 16 tokens a sequence shard, page 16.
SP = dict(vocab_size=264, hidden_size=64, intermediate_size=128,
          num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
          max_position_embeddings=1024)
EP_PLANS = {"ep4": dict(ep=4), "ep2_tp2": dict(ep=2, tp=2)}
SP_PLANS = {"sp4": dict(sp=4), "dp2_sp2": dict(dp=2, sp=2)}


def _sp_ecfg(plan):
    b = 16 * plan["sp"]
    return dict(max_slots=2, max_input_length=b, max_output_length=8,
                prefill_buckets=(b,), page_size=16, dtype="float32",
                kv_pool_tokens=None, steps_per_round=4)


def _tree(kw, seed):
    """The reference's init with random norms, in numpy."""
    tree = jax.tree.map(np.asarray, jllama.init_params(
        JL(**kw), jax.random.key(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    layers = dict(tree["layers"])
    for key in ("attn_norm", "mlp_norm"):
        layers[key] = (1 + 0.1 * rng.standard_normal(
            layers[key].shape)).astype(np.float32)
    return {**tree, "layers": layers}


def _prompt(n, salt=0):
    return [1] + [3 + (7 * i + salt) % 250 for i in range(n - 1)]


GREEDY = dict(max_tokens=4, top_k=1, ignore_eos=True)
MOE_BATCHES = [[(_prompt(70), dict(max_tokens=8, top_k=1, ignore_eos=True)),
                (_prompt(9, 1), dict(max_tokens=10, top_k=1,
                                     ignore_eos=True))],
               [(_prompt(70), dict(max_tokens=6, top_k=1, ignore_eos=True))]]


def _sp_requests(plan):
    """The reference's prompt (``[5] * (bucket - 8)``), a prompt of the
    whole bucket but its last 3 rows, and that prompt again (a prefix
    hit: chunks, replicated)."""
    b = 16 * plan["sp"]
    return [([5] * (b - 8), GREEDY), (_prompt(b - 3), GREEDY),
            (_prompt(b - 3), GREEDY)]


def _moe_case():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    ei = rng.standard_normal((4, 6, 64)).astype(np.float32)
    return x, ei


def _sp_case():
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, 250, (2, 32)).astype(np.int32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()
    return dict(tokens=tokens, pos=pos, length=np.array([27], np.int32),
                score_ids=rng.integers(3, 250, (2, 30)).astype(np.int32))


@pytest.fixture(scope="module")
def pinned(tmp_path_factory):
    """Every engine of the module plans under the same fixed costs."""
    path = tmp_path_factory.mktemp("sched") / "PROFILE_default.json"
    path.write_text('{"full_ms_per_step": 2.0, "slots": 8, '
                    '"prefill_ms_per_token": 0.125}')
    keys = ("SCHED_PROFILE_JSON", "SCHED_ONLINE_CALIB", "ENGINE_SPEC_DECODE",
            "KV_HOST_POOL_TOKENS", "ENGINE_WATCHDOG_STALL_S")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(SCHED_PROFILE_JSON=str(path), SCHED_ONLINE_CALIB="0")
    for k in keys[2:]:
        os.environ.pop(k, None)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def ranks(pinned, tmp_path_factory):
    """Four port ranks running every job of the module; ``get()`` waits
    for the leader's gathered results (the reference runs meanwhile)."""
    import torch.multiprocessing as mp
    x, ei = _moe_case()
    moe_tree = _tree(MOE, 11)
    sp_tree = _tree(SP, 4)
    jobs = []
    for name, plan in EP_PLANS.items():
        jobs.append(dict(name=f"moe_{name}", drive="moe", plan=plan,
                         cfg=MOE, tree=moe_tree, x=x, expert_in=ei))
        jobs.append(dict(name=f"tree_{name}", drive="tree", plan=plan,
                         cfg=MOE, tree=moe_tree, seed=3))
    jobs.append(dict(name="engine_ep2_tp2", drive="engine",
                     plan=EP_PLANS["ep2_tp2"], cfg=MOE, tree=moe_tree,
                     engine=MOE_ECFG, batches=MOE_BATCHES))
    for name, plan in SP_PLANS.items():
        jobs.append(dict(name=f"sp_{name}", drive="sp", plan=plan, cfg=SP,
                         tree=sp_tree, **_sp_case()))
        jobs.append(dict(name=f"engine_{name}", drive="engine", plan=plan,
                         cfg=SP, tree=sp_tree, engine=_sp_ecfg(plan),
                         requests=_sp_requests(plan)))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    path = str(tmp_path_factory.mktemp("mesh") / "group")
    procs = [ctx.Process(target=torch_mesh_ranks.rank_main,
                         args=(r, 4, path, q, jobs), daemon=True)
             for r in range(4)]
    for p in procs:
        p.start()
    box: dict = {}

    def get():
        while len(box) < 4:
            rank, status, out = q.get(timeout=TIMEOUT)
            assert status == "ok", out
            box[rank] = out
        return box[0]
    yield types.SimpleNamespace(get=get)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()


def _jmesh(plan):
    n = int(np.prod(list(plan.values())))
    return jmake_mesh(JPlan(**plan), jax.devices()[:n])


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("plan", [dict(dp=2, ep=2, tp=2),
                                  dict(dp=2, sp=2, tp=2), dict(ep=4, tp=2),
                                  dict(sp=4, dp=2), dict(pp=2, ep=2, sp=2)])
def test_rank_lists_follow_the_references_device_array(plan):
    """Every group's rank list along every axis (and the MoE combine's
    ``ep x tp``) is the reference device array's devices along it."""
    jm = jmake_mesh(JPlan(**{"tp": 1, **plan}), jax.devices()[:8])
    ids = np.vectorize(lambda d: jax.devices().index(d))(jm.devices)
    shape = {a: int(jm.shape[a]) for a in tmesh.AXES}
    for axes in (("dp",), ("pp",), ("ep",), ("sp",), ("tp",), ("ep", "tp")):
        keep = [tmesh.AXES.index(a) for a in axes]
        rest = [i for i in range(5) if i not in keep]
        want = sorted(ids.transpose(rest + keep).reshape(
            -1, int(np.prod([ids.shape[i] for i in keep]))).tolist())
        assert sorted(tmesh.axis_ranks(shape, axes)) == want
    for r in range(8):
        m = tmesh.Mesh(shape=shape, rank=r, world=8)
        at = tuple(int(i[0]) for i in np.nonzero(ids == r))
        assert tuple(m.coords.values()) == at
        assert m.leader == (r == 0)


def test_maybe_init_distributed_multi_host_rank_arithmetic(monkeypatch):
    """Global rank = process id x local ranks + local index, world =
    processes x local ranks; the reference's environment variables stand
    in for missing arguments; a bare host:port is tcp."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k in ("GAIE_COORDINATOR", "GAIE_NUM_PROCESSES", "GAIE_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.maybe_init_distributed("h:1", 2, 1, local_rank=1,
                                        local_ranks=2, device="cpu")
    (a, kw), = calls
    assert (a[0], kw["init_method"], kw["world_size"], kw["rank"]) == (
        "gloo", "tcp://h:1", 4, 3)
    monkeypatch.setenv("GAIE_COORDINATOR", "10.0.0.1:9")
    monkeypatch.setenv("GAIE_NUM_PROCESSES", "3")
    monkeypatch.setenv("GAIE_PROCESS_ID", "2")
    assert tmesh.maybe_init_distributed(local_ranks=2, device="cpu")
    kw = calls[-1][1]
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
        "tcp://10.0.0.1:9", 6, 4)
    monkeypatch.delenv("GAIE_COORDINATOR")
    with pytest.raises(ConfigError, match="coordinator"):
        tmesh.maybe_init_distributed(device="cpu")
    monkeypatch.delenv("GAIE_NUM_PROCESSES")
    monkeypatch.delenv("GAIE_PROCESS_ID")
    assert not tmesh.maybe_init_distributed(device="cpu")
    assert len(calls) == 2


@pytest.mark.parametrize("argv,env,want", [
    ([], {}, ("", 1, 0)),
    (["--coordinator", "h:5", "--num-processes", "2", "--process-id", "1"],
     {}, ("h:5", 2, 1)),
    ([], {"GAIE_COORDINATOR": "h:6", "GAIE_NUM_PROCESSES": "2",
          "GAIE_PROCESS_ID": "0"}, ("h:6", 2, 0)),
    (["--process-id", "1"], {"GAIE_COORDINATOR": "h:6",
                             "GAIE_NUM_PROCESSES": "2"}, ("h:6", 2, 1)),
    (["--num-processes", "2", "--process-id", "0"], {}, "coordinator"),
    (["--coordinator", "h:5", "--num-processes", "2", "--process-id", "2"],
     {}, "process-id"),
])
def test_cli_hosts_take_the_references_flags_and_env(argv, env, want,
                                                     monkeypatch):
    for k in ("GAIE_COORDINATOR", "GAIE_NUM_PROCESSES", "GAIE_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = model_server._parser().parse_args(argv)
    if isinstance(want, str):
        with pytest.raises(ConfigError, match=want):
            model_server.cli_hosts(args)
    else:
        assert model_server.cli_hosts(args) == want


@pytest.mark.parametrize("argv,available,want", [
    (["--device", "cpu", "--coordinator", "h:1", "--num-processes", "2",
      "--process-id", "0"], None, (2, 2, 1)),
    (["--device", "cpu", "--world-size", "4", "--coordinator", "h:1",
      "--num-processes", "2", "--process-id", "1"], None, (4, 4, 1)),
    (["--coordinator", "h:1", "--num-processes", "2", "--process-id", "0"],
     8, (8, 8, 1)),
    (["--device", "cuda:1", "--coordinator", "h:1", "--num-processes", "2",
      "--process-id", "0"], 8, "names one card"),
    (["--device", "cpu", "--world-size", "3", "--coordinator", "h:1",
      "--num-processes", "2", "--process-id", "0"], 4, "does not split"),
])
def test_cli_topology_over_hosts(argv, available, want, monkeypatch):
    """The world over several hosts is global (every host's cards, one
    rank a host on the CPU); ``--device cuda:N`` is refused there, and a
    world must split evenly over the hosts. The CLI has no sp or ep
    flag, as the reference's has none."""
    for k in ("GAIE_COORDINATOR", "GAIE_NUM_PROCESSES", "GAIE_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    parser = model_server._parser()
    flags = {o for a in parser._actions for o in a.option_strings}
    assert not {f for f in flags if "sequence" in f or "expert" in f}
    args = parser.parse_args(argv)
    if isinstance(want, str):
        with pytest.raises(ConfigError, match=want):
            model_server.cli_topology(args, available=available)
    else:
        assert model_server.cli_topology(args, available=available) == want


# ------------------------------------------------------------------- ep

@pytest.mark.parametrize("name", sorted(EP_PLANS))
def test_ep_moe_functions_match_the_reference(ranks, name):
    """``ep_sparse_moe_ffn``, ``sparse_moe_ffn(mesh=)`` and the dense
    ``moe_impl`` on every rank equal the reference's
    ``ep_sparse_moe_ffn`` on the same mesh shape (every rank the whole
    output: routing replicated, one all-reduce over ep x tp), and each
    rank's ``ep_expert_ffn`` block is the reference's at its place."""
    x, ei = _moe_case()
    tree = _tree(MOE, 11)
    lp = {k: jnp.asarray(v[0]) for k, v in tree["layers"].items()}
    cfg = JL(**MOE)
    jm = _jmesh(EP_PLANS[name])
    want = jax.jit(lambda x, lp: jmoe.ep_sparse_moe_ffn(jm, x, lp, cfg))(
        jnp.asarray(x), lp)
    want_ffn = jax.jit(lambda e, g, u, d: jmoe.ep_expert_ffn(
        jm, e, g, u, d))(jnp.asarray(ei), lp["w_gate"], lp["w_up"],
                         lp["w_down"])
    dense = jllama._moe_mlp(jnp.asarray(x), lp,
                            dataclasses.replace(cfg, moe_impl="dense"))
    n = 4 // EP_PLANS[name]["ep"]
    for coords, res in ranks.get()[f"moe_{name}"]:
        _close(res["ep_sparse"], want)
        _close(res["sparse"], want)
        _close(res["dense"], dense)
        e0 = coords["ep"] * n
        _close(res["expert_ffn"], np.asarray(want_ffn)[e0:e0 + n])


@pytest.mark.parametrize("name", sorted(EP_PLANS))
def test_each_ranks_ep_tree_is_the_references_device_block(ranks, name):
    """A rank's tree, read from the numpy tree (``params_from_numpy``) or
    made from a seed (``init_params``: the one-rank tree of that seed,
    split), holds exactly the reference's per-device block of every leaf
    on the same mesh (experts over ep, F over tp)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from generativeaiexamples_tpu_torch.models.weight_cache import flatten
    jm = _jmesh(EP_PLANS[name])
    cfg = JL(**MOE)
    specs = jspecs(cfg, jm)
    flat_specs = {"embed": specs["embed"], "final_norm": specs["final_norm"],
                  "lm_head": specs["lm_head"],
                  **{f"layers/{k}": v for k, v in specs["layers"].items()}}
    tree = _tree(MOE, 11)
    np_flat = {"embed": tree["embed"], "final_norm": tree["final_norm"],
               "lm_head": tree["lm_head"],
               **{f"layers/{k}": v for k, v in tree["layers"].items()}}
    whole = {k: v.numpy() for k, v in flatten(llama.init_params(
        LlamaConfig(**MOE), 3, torch.float32)).items()}
    devices = list(np.asarray(jm.devices).reshape(-1))
    for coords, res in ranks.get()[f"tree_{name}"]:
        r = 0
        for a in tmesh.AXES:
            r = r * jm.shape[a] + coords[a]
        for key, spec in flat_specs.items():
            idx = NamedSharding(jm, P(*spec)).devices_indices_map(
                np_flat[key].shape)[devices[r]]
            np.testing.assert_array_equal(res["numpy"][key],
                                          np_flat[key][idx])
            np.testing.assert_array_equal(res["init"][key], whole[key][idx])


def test_experts_that_do_not_split_over_ep_are_refused():
    """E % ep != 0 is a ``ShardingError`` before any leaf is made, and
    the engine refuses the mesh at construction."""
    cfg = LlamaConfig(**MOE)
    mesh = tmesh.Mesh(shape={"dp": 1, "pp": 1, "ep": 3, "sp": 1, "tp": 1},
                      world=3)
    with pytest.raises(ShardingError, match="num_experts=4 does not split "
                                            "over ep=3"):
        llama.init_params(cfg, 0, torch.float32, mesh=mesh)
    gate = types.SimpleNamespace(mesh=mesh, device=torch.device("cpu"))
    with pytest.raises(ConfigError, match="ep=3"):
        Engine._check_topology(gate, cfg)


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


def _jax_pool(jeng) -> dict:
    return {k: np.asarray(v)[:, 1:] for k, v in
            jeng._state["cache"].items()}


def _check_pools(got: list, want: dict) -> None:
    """Every rank's pool (its tp block of the kv heads) is the
    reference's."""
    for coords, res in got:
        for name, ref in want.items():
            pool = res["pool"][name]
            n = pool.shape[2]
            _close(pool, ref[:, :, coords["tp"] * n:(coords["tp"] + 1) * n])


def test_ep2_tp2_mixtral_engine_matches_the_reference(ranks):
    """A tiny Mixtral at ep = 2 x tp = 2 (each rank 2 experts, F/2 of
    each, heads over tp, replicated over ep), batch by batch in lockstep
    with the reference engine on the same mesh: a 70-token prompt in
    chunks beside a short one, then the long one again (a prefix hit).
    Equal greedy tokens; every rank's pool is the reference's; every
    rank launched the same programs."""
    jeng = JEngine(jax.tree.map(jnp.asarray, _tree(MOE, 11)), JL(**MOE),
                   JTok(), JConfig(**MOE_ECFG), mesh=_jmesh(dict(ep=2,
                                                                 tp=2)))
    want = _jax_lockstep(jeng, MOE_BATCHES)
    pool = _jax_pool(jeng)
    got = ranks.get()["engine_ep2_tp2"]
    lead = got[0][1]
    assert lead["tokens"] == want
    assert lead["stats"]["prefill_chunks"] >= 3
    assert lead["stats"]["prefix_cache_hit_tokens"] > 0
    assert len(lead["reports"]) == 4
    _check_pools(got, pool)


# ------------------------------------------------------------------- sp

@pytest.mark.parametrize("name", sorted(SP_PLANS))
def test_sp_functions_match_the_reference(ranks, name):
    """``apply_sp`` (each rank its dp block of the batch and sp block of
    the sequence), ``apply_prefill_sp`` (each rank its sequence block of
    every layer's K/V, the last valid row's logits on every rank) and
    ``score`` over sp (30 tokens padded to an sp multiple, the NLL rows
    gathered) equal the reference's on the same mesh."""
    c = _sp_case()
    plan = SP_PLANS[name]
    jm = _jmesh(plan)
    params = jax.tree.map(jnp.asarray, _tree(SP, 4))
    cfg = JL(**SP)
    tokens, pos = jnp.asarray(c["tokens"]), jnp.asarray(c["pos"])
    logits = np.asarray(jllama.apply_sp(params, cfg, tokens, pos, jm))
    k, v, last = (np.asarray(a) for a in jllama.apply_prefill_sp(
        params, cfg, tokens[:1], pos[:1], jm, jnp.asarray(c["length"])))
    nll = np.asarray(jllama.score(params, cfg, jnp.asarray(c["score_ids"]),
                                  mesh=jm))
    S, B = 32, 2
    per, bl = S // plan["sp"], B // plan.get("dp", 1)
    for coords, res in ranks.get()[f"sp_{name}"]:
        rows = slice(coords["sp"] * per, (coords["sp"] + 1) * per)
        batch = slice(coords["dp"] * bl, (coords["dp"] + 1) * bl)
        _close(res["apply_sp"], logits[batch, rows])
        _close(res["prefill_k"], k[:, :, rows])
        _close(res["prefill_v"], v[:, :, rows])
        _close(res["prefill_logits"], last)
        _close(res["score"], nll)


@pytest.mark.parametrize("shape,S,match", [
    (dict(sp=1), 16, "needs a mesh with sp > 1"),
    (dict(sp=2, tp=2), 16, "composing sp with tp"),
    (dict(sp=2, ep=2), 16, "composing sp with ep"),
    (dict(sp=2, pp=2), 16, "composing sp with pp"),
    (dict(sp=4, dp=2), 30, "not divisible by sp=4"),
    (dict(sp=4, dp=2), 32, None),
])
def test_validate_sp_mesh_refuses_as_the_reference(shape, S, match):
    full = {a: shape.get(a, 1) for a in tmesh.AXES}
    mesh = types.SimpleNamespace(shape=full)

    def run(fn):
        try:
            return fn(mesh, S, "sp serving prefill")
        except ValueError as exc:
            return str(exc)
    got, want = run(llama.validate_sp_mesh), run(jllama.validate_sp_mesh)
    assert got == want
    if match is None:
        assert got == shape["sp"]
    else:
        assert match in got


@pytest.mark.parametrize("axes,match", [
    (dict(tp=2, sp=2), "composing sp with tp"),
    (dict(tp=1, ep=2, sp=2), "composing sp with ep"),
    (dict(tp=1, pp=2, sp=2), "pp == 1"),
    (dict(tp=1, sp=4), None), (dict(tp=1, dp=2, sp=2), None),
    (dict(tp=2, ep=2), None), (dict(tp=1, ep=4), None),
])
def test_engine_topology_accepts_ep_and_sp(axes, match):
    """The engine serves ep (x tp) and dp x sp meshes; pp and sp composed
    with tp or ep stay refused with the reference's reasons."""
    plan = tmesh.MeshPlan(**axes)
    n = int(np.prod([getattr(plan, a) for a in tmesh.AXES]))
    mesh = tmesh.Mesh(shape={a: getattr(plan, a) for a in tmesh.AXES},
                      world=n)
    gate = types.SimpleNamespace(mesh=mesh, device=torch.device("cpu"))
    if match is None:
        Engine._check_topology(gate, LlamaConfig(**MOE))
        return
    with pytest.raises(ConfigError, match=match):
        Engine._check_topology(gate, LlamaConfig(**MOE))


@pytest.mark.parametrize("name", sorted(SP_PLANS))
def test_sp_engine_matches_the_reference(ranks, name):
    """The reference's sp serving engine (__graft_entry__'s geometry) on
    the same mesh: each one-shot admission is the ring prefill on every
    rank, the prefix hit's chunks and the decode rounds replicated.
    Equal greedy tokens, and every rank's pool (the whole model's: the
    K/V blocks gathered over sp) equals the reference's."""
    plan = SP_PLANS[name]
    jeng = JEngine(jax.tree.map(jnp.asarray, _tree(SP, 4)), JL(**SP),
                   JTok(), JConfig(**_sp_ecfg(plan)), mesh=_jmesh(plan))
    want = []
    with jeng:
        for ids, kw in _sp_requests(plan):
            s = jeng.submit(ids, JParams(**kw))
            s.text()
            want.append(list(s.token_ids))
        pool = _jax_pool(jeng)
    got = ranks.get()[f"engine_{name}"]
    lead = got[0][1]
    assert lead["tokens"] == want
    assert lead["stats"]["prefix_cache_hit_tokens"] > 0
    assert len(lead["reports"]) == 4
    _check_pools(got, pool)


# -------------------------------------------------------------- the CLI

def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def test_cli_over_two_hosts_serves_one_process_text(monkeypatch):
    """Two model-server CLIs on ``--device cpu`` form one tp = 2 group:
    process 0 by flags (``--coordinator``, ``--num-processes``,
    ``--process-id``), process 1 by the reference's environment
    variables. Only process 0 binds HTTP; its greedy text equals one
    process's; /debug/launches lists both ranks; SIGTERM to both ends
    both with code 0."""
    import socket
    ports = []
    for _ in range(3):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    http, http1, rendezvous = ports
    common = ["llama-tiny", "--device", "cpu", "--no-embedder",
              "--grpc-port", "0", "--max-input-length", "64",
              "--max-output-length", "16", "--max-batch-size", "2",
              "--dtype", "float32"]
    env = dict(os.environ, HISTORY_INTERVAL_S="0",
               PYTHONPATH=os.pathsep.join(sys.path))
    for k in ("GAIE_COORDINATOR", "GAIE_NUM_PROCESSES", "GAIE_PROCESS_ID"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "generativeaiexamples_tpu_torch.serving"]
    host0 = cmd + common + ["--port", str(http), "--coordinator",
                            f"127.0.0.1:{rendezvous}", "--num-processes",
                            "2", "--process-id", "0"]
    host1 = cmd + common + ["--port", str(http1)]
    env1 = dict(env, GAIE_COORDINATOR=f"127.0.0.1:{rendezvous}",
                GAIE_NUM_PROCESSES="2", GAIE_PROCESS_ID="1")
    body = {"prompt": "hello mesh", "max_tokens": 8, "temperature": 0}
    with tempfile.TemporaryFile() as log0, tempfile.TemporaryFile() as log1:
        procs = [subprocess.Popen(host0, env=env, stdout=log0,
                                  stderr=subprocess.STDOUT,
                                  start_new_session=True),
                 subprocess.Popen(host1, env=env1, stdout=log1,
                                  stderr=subprocess.STDOUT,
                                  start_new_session=True)]
        base = f"http://127.0.0.1:{http}"
        try:
            deadline = time.monotonic() + TIMEOUT
            while True:
                assert all(p.poll() is None for p in procs), \
                    "a CLI exited"
                try:
                    health = json.loads(_get(base + "/health")[1])
                    break
                except OSError:
                    assert time.monotonic() < deadline, "no /health"
                    time.sleep(0.5)
            assert health["tp"] == 2
            req = urllib.request.Request(
                base + "/v1/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                text = json.loads(resp.read())["choices"][0]["text"]
            ranks = json.loads(_get(base + "/debug/launches")[1])["ranks"]
            assert len(ranks) == 2
            with pytest.raises(OSError):
                _get(f"http://127.0.0.1:{http1}/health", timeout=2)
            for p in procs:
                p.send_signal(signal.SIGTERM)
            codes = [p.wait(timeout=60) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait(10)
        assert codes == [0, 0], [log.seek(0) or log.read()[-2000:]
                                 for log in (log0, log1)]
    # One process with the same flags, in this process.
    args = model_server._parser().parse_args(common)
    engine, _ = model_server._build_rank(args, 1, 1)
    try:
        from generativeaiexamples_tpu_torch.engine import SamplingParams
        engine.start()
        stream = engine.submit(engine.tokenizer.encode(body["prompt"]),
                               SamplingParams(max_tokens=8, temperature=0))
        assert stream.text() == text
    finally:
        engine.close()
