"""The mixture-of-experts path (Mixtral) in the port against the JAX
package, on the CPU.

One numpy tree at a tiny MoE geometry (``tests/test_moe.py``'s: D 64, F
96, 4 experts, top-2) drives both packages (``models/convert.py``), and
every input is drawn from a numpy seed. Tolerances: routing integers
(expert, slot, keep) bit-equal; float32 on both sides elsewhere, so
rtol 2e-4 / atol 1e-5 on logits, 1e-4 on hidden states and float32
pools, 2e-5 on one MoE layer; int8 pools as ``test_torch_gptnext.py``
holds them. Greedy tokens equal exactly."""

import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
from generativeaiexamples_tpu.parallel import moe as jmoe
from generativeaiexamples_tpu_torch.engine import (Engine, EngineConfig,
                                                   SamplingParams)
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import (MIXTRAL_8X7B,
                                                           LlamaConfig)
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.models.tokenizer import ByteTokenizer
from generativeaiexamples_tpu_torch.parallel import moe
from generativeaiexamples_tpu_torch.utils.errors import ConfigError

RTOL, ATOL = 2e-4, 1e-5
LAYER_TOL = 2e-5
TIMEOUT = 60
CFG_KW = dict(vocab_size=288, hidden_size=64, intermediate_size=96,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
              num_experts=4, num_experts_per_tok=2, moe_capacity_factor=2.0)
CFG, JCFG = LlamaConfig(**CFG_KW), JL(**CFG_KW)
EXPERT_KEYS = ("router", "w_gate", "w_up", "w_down")


def _np_tree(seed=7, cfg=JCFG):
    """The JAX init_params tree with random norm weights (the reference
    makes them ones, which would hide a misplaced norm)."""
    tree = jax.tree.map(np.asarray, jllama.init_params(
        cfg, jax.random.key(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    layers = dict(tree["layers"])
    for key in ("attn_norm", "mlp_norm"):
        layers[key] = (1 + 0.1 * rng.standard_normal(
            layers[key].shape)).astype(np.float32)
    return {**tree, "layers": layers}


@pytest.fixture(scope="module")
def model():
    tree = _np_tree()
    return (tree, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu", torch.float32, cfg=CFG))


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t.float() if isinstance(
        t, torch.Tensor) else t), np.asarray(j, np.float32), rtol=rtol,
        atol=atol)


def _layer(tree, i=0):
    return ({k: torch.from_numpy(tree["layers"][k][i].copy())
             for k in EXPERT_KEYS},
            {k: jnp.asarray(tree["layers"][k][i]) for k in EXPERT_KEYS})


# ------------------------------------------------------------- routing


@pytest.mark.parametrize("T,capacity", [(16, 3), (16, 32), (64, 5)])
def test_route_topk_matches_jax(T, capacity):
    """expert, slot and keep bit-equal to JAX's, weights within 1e-6,
    over rows with ties: an all-zero row (every expert tied), two
    identical rows and a row with a two-way tie for its second choice
    (``jax.lax.top_k`` takes the lower index first)."""
    rng = np.random.default_rng(T + capacity)
    logits = rng.normal(size=(T, 4)).astype(np.float32)
    logits[1] = 0.0
    logits[5] = logits[4]
    logits[7] = [3.0, 1.0, 1.0, -2.0]
    got = moe.route_topk(torch.from_numpy(logits), 2, capacity)
    want = jmoe.route_topk(jnp.asarray(logits), 2, capacity)
    for name, g, w in zip(("expert", "slot", "weight", "keep"), got, want):
        if name == "weight":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    assert got[0].reshape(T, 2)[1].tolist() == [0, 1]
    assert got[0].reshape(T, 2)[7].tolist() == [0, 1]
    if capacity < T * 2 // 4:
        assert not bool(got[3].all())      # the capacity binds


@pytest.mark.parametrize("T,E,k,cf", [(8, 8, 2, 2.0), (1024, 8, 2, 2.0),
                                      (7, 4, 2, 1.0), (3, 8, 2, 0.25),
                                      (5, 3, 1, 1.5)])
def test_expert_capacity_is_the_references(T, E, k, cf):
    assert moe.expert_capacity(T, E, k, cf) == jmoe.expert_capacity(
        T, E, k, cf)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_sparse_moe_ffn_matches_jax(model, cf):
    """One MoE layer on (2, 8, D) tokens, without drops (capacity factor
    2: C = T) and with them (0.5)."""
    tree, _, _ = model
    lp, jlp = _layer(tree)
    x = np.random.default_rng(1).normal(size=(2, 8, 64)).astype(np.float32)
    cfg, jcfg = (dataclasses.replace(c, moe_capacity_factor=cf)
                 for c in (CFG, JCFG))
    got = moe.sparse_moe_ffn(torch.from_numpy(x), lp, cfg)
    want = jmoe.sparse_moe_ffn(jnp.asarray(x), jlp, jcfg)
    _close(got, want, rtol=LAYER_TOL, atol=LAYER_TOL)
    T = 16
    C = moe.expert_capacity(T, 4, 2, cf)
    logits = torch.from_numpy(x.reshape(T, 64)) @ lp["router"]
    kept = int(moe.route_topk(logits, 2, C)[3].sum())
    assert (kept == T * 2) == (cf == 2.0)


def test_sparse_matches_dense_when_no_drops(model):
    """The sparse layer against ``_moe_mlp(moe_impl="dense")``, the
    zero-gated all-experts oracle, where nothing drops; the dense form
    equals the JAX package's dense form too."""
    tree, _, _ = model
    lp, jlp = _layer(tree, 1)
    x = np.random.default_rng(2).normal(size=(2, 8, 64)).astype(np.float32)
    sparse = moe.sparse_moe_ffn(torch.from_numpy(x), lp, CFG)
    dense = llama._moe_mlp(torch.from_numpy(x), lp,
                           dataclasses.replace(CFG, moe_impl="dense"))
    _close(sparse, dense.numpy(), rtol=LAYER_TOL, atol=LAYER_TOL)
    jdense = jllama._moe_mlp(jnp.asarray(x), jlp,
                             dataclasses.replace(JCFG, moe_impl="dense"))
    _close(dense, jdense, rtol=LAYER_TOL, atol=LAYER_TOL)


def test_moe_configs_are_supported_and_checked():
    """Mixtral passes ``check_supported``; an unknown ``moe_impl`` raises
    ``ConfigError`` there and in the layer; the tree has the reference's
    leaves (router and 4-D expert stacks, no dense MLP)."""
    llama.check_supported(MIXTRAL_8X7B)
    bad = dataclasses.replace(CFG, moe_impl="ragged")
    with pytest.raises(ConfigError):
        llama.check_supported(bad)
    with pytest.raises(ConfigError):
        llama.init_params(bad, seed=0, dtype=torch.float32)
    with pytest.raises(ConfigError):
        llama._moe_mlp(torch.zeros(1, 1, 64), {}, bad)
    mine = llama.init_params(CFG, seed=0, dtype=torch.float32)
    ref = jllama.init_params(JCFG, jax.random.key(0), dtype=jnp.float32)
    assert ({k: tuple(v.shape) for k, v in mine["layers"].items()}
            == {k: tuple(v.shape) for k, v in ref["layers"].items()})
    assert mine["layers"]["w_gate"].shape == (2, 4, 64, 96)


# ------------------------------------------------------------- forwards


def test_apply_and_score_match_jax(model):
    tree, jp, tp = model
    rng = np.random.default_rng(3)
    B, S = 2, 11
    tokens = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    tl, _ = llama.apply(tp, CFG, torch.from_numpy(tokens),
                        torch.from_numpy(pos))
    jl, _ = jllama.apply(jp, JCFG, jnp.asarray(tokens), jnp.asarray(pos))
    _close(tl, jl)
    # score: one pass and the chunked dense-cache path (chunk 16 < S).
    long = rng.integers(0, CFG.vocab_size, (1, 40)).astype(np.int32)
    for chunk in (64, 16):
        got = llama.score(tp, CFG, torch.from_numpy(long), chunk=chunk)
        want = jllama.score(jp, JCFG, jnp.asarray(long), chunk=chunk)
        _close(got, want, rtol=1e-4, atol=1e-4)


def _pools(kind, rng, shape):
    if kind == "int8":
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": (rng.random(shape[:4]) * 0.02 + 1e-3).astype(
                    np.float32),
                "vs": (rng.random(shape[:4]) * 0.02 + 1e-3).astype(
                    np.float32)}
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _port_pools(pools):
    out = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    for k in ("ks", "vs"):
        if k in out:
            out[k] = out[k].to(torch.bfloat16)
    return out


def _jax_pools(pools):
    return {k: (jnp.asarray(v, jnp.bfloat16) if k in ("ks", "vs")
                else jnp.asarray(v)) for k, v in pools.items()}


def _check_pools(got, want, skip_trash=False):
    for name in got:
        g = got[name].float().numpy() if got[name].dtype != torch.int8 \
            else got[name].numpy().astype(np.int32)
        w = np.asarray(want[name]).astype(np.float32 if got[name].dtype
                                          != torch.int8 else np.int32)
        if skip_trash:
            g, w = g[:, 1:], w[:, 1:]
        if got[name].dtype == torch.int8:
            assert np.abs(g - w).max() <= 1, name
        elif name in ("ks", "vs"):
            np.testing.assert_allclose(g, w, rtol=8e-3, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_apply_decode_paged_matches_jax(model, kind):
    """Four slots, one idle: the idle row claims expert slots too, as in
    the reference; the live rows' logits and the pools match."""
    _, jp, tp = model
    rng = np.random.default_rng(4)
    page, W = 16, 3
    lengths = np.array([5, 0, 16, 33], np.int32)     # slot 1 idle
    B = len(lengths)
    N = 1 + B * W
    shape = (CFG.num_layers, N, CFG.num_kv_heads, page, CFG.head_dim)
    pools = _pools(kind, rng, shape)
    table = (1 + np.arange(B * W)).reshape(B, W).astype(np.int32)
    live = lengths > 0
    wp = np.where(live, table[np.arange(B), lengths // page], 0
                  ).astype(np.int32)
    off = np.where(live, lengths % page, 0).astype(np.int32)
    tokens = rng.integers(0, CFG.vocab_size, (B, 1)).astype(np.int32)
    pos = lengths[:, None]
    t = torch.from_numpy
    tl, tcache = llama.apply_decode_paged(
        tp, CFG, t(tokens), t(pos), _port_pools(pools), t(table), t(wp),
        t(off))
    jl, jcache = jllama.apply_decode_paged(
        jp, JCFG, jnp.asarray(tokens), jnp.asarray(pos), _jax_pools(pools),
        jnp.asarray(table), jnp.asarray(lengths + 1), jnp.asarray(wp),
        jnp.asarray(off), use_kernel=False)
    _close(tl[live], np.asarray(jl)[live], rtol=1e-3 if kind == "int8"
           else RTOL, atol=ATOL if kind == "f32" else 1e-3)
    _check_pools(tcache, jcache, skip_trash=True)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_apply_prefill_paged_matches_jax(model, kind):
    """A chunk of 2 pages after 1 cached page (its padding rows claim
    expert slots beside the prompt's): hidden states of the valid rows
    and the pools after the scatter."""
    _, jp, tp = model
    rng = np.random.default_rng(5)
    page, C, N, W = 16, 32, 8, 6
    start_pages, n = 1, 27
    start = start_pages * page
    shape = (CFG.num_layers, N, CFG.num_kv_heads, page, CFG.head_dim)
    pools = _pools(kind, rng, shape)
    tokens = rng.integers(3, CFG.vocab_size, (1, C)).astype(np.int32)
    tokens[0, n:] = 0
    positions = (start + np.arange(C, dtype=np.int32))[None, :]
    table = np.zeros((1, W), np.int32)
    table[0, :start_pages + 2] = rng.permutation(np.arange(1, N))[:3]
    t = torch.from_numpy
    th, tcache = llama.apply_prefill_paged(
        tp, CFG, t(tokens), t(positions), _port_pools(pools), t(table),
        torch.tensor([start + n], dtype=torch.int32),
        torch.tensor([start_pages], dtype=torch.int32))
    jh, jcache = jllama.apply_prefill_paged(
        jp, JCFG, jnp.asarray(tokens), jnp.asarray(positions),
        _jax_pools(pools), jnp.asarray(table),
        jnp.asarray([start + n], jnp.int32), jnp.int32(start_pages))
    atol = 1e-4 if kind == "f32" else 2e-3
    np.testing.assert_allclose(th.numpy()[0, :n], np.asarray(jh)[0, :n],
                               atol=atol)
    _check_pools(tcache, jcache)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_apply_verify_paged_matches_jax(model, kind):
    """Three slots (one idle) scoring S = 4 positions each."""
    _, jp, tp = model
    rng = np.random.default_rng(6)
    page, S, P, n_pages = 16, 4, 4, 16
    B = 3
    shape = (CFG.num_layers, n_pages, CFG.num_kv_heads, page, CFG.head_dim)
    pools = _pools(kind, rng, shape)
    table = np.stack([rng.permutation(np.arange(1, n_pages))[:P]
                      for _ in range(B)]).astype(np.int32)
    pos = np.array([page - 2, 2 * page + 5, 0], np.int32)
    n_draft = np.array([S - 1, 1, 0], np.int32)
    tokens = rng.integers(3, CFG.vocab_size, (B, S)).astype(np.int32)
    offs = np.arange(S, dtype=np.int32)
    positions = pos[:, None] + offs[None, :]
    active = np.array([True, True, False])
    ok = active[:, None] & (offs[None, :] <= n_draft[:, None])
    pages = np.take_along_axis(table, positions // page, axis=1)
    wp = np.where(ok, pages, 0).astype(np.int32)
    off = (positions % page).astype(np.int32)
    valid = (pos + S).astype(np.int32)
    t = torch.from_numpy
    logits, tcache = llama.apply_verify_paged(
        tp, CFG, t(tokens), t(positions), _port_pools(pools), t(table),
        t(valid), t(wp), t(off))
    jlogits, jcache = jllama.apply_verify_paged(
        jp, JCFG, jnp.asarray(tokens), jnp.asarray(positions),
        _jax_pools(pools), jnp.asarray(table), jnp.asarray(valid),
        jnp.asarray(wp), jnp.asarray(off))
    live = ok.any(axis=1)
    np.testing.assert_allclose(logits.numpy()[live],
                               np.asarray(jlogits)[live],
                               atol=1e-4 if kind == "f32" else 2e-3)
    _check_pools(tcache, jcache, skip_trash=True)


# ---------------------------------------------------------------- engine

ENGINE_KW = dict(max_slots=2, max_input_length=128, max_output_length=16,
                 prefill_buckets=(32,), page_size=16, dtype="float32",
                 kv_pool_tokens=None, steps_per_round=4,
                 max_prefill_bucket=32, sched_round_budget_tokens=32,
                 sched_prefill_chunk_tokens=32)


@pytest.fixture
def pinned_schedule(monkeypatch, tmp_path):
    """Both engines plan under the same fixed costs and budget."""
    for name in ("ENGINE_SPEC_DECODE", "KV_HOST_POOL_TOKENS",
                 "ENGINE_WATCHDOG_STALL_S"):
        monkeypatch.delenv(name, raising=False)
    prof = tmp_path / "PROFILE_default.json"
    prof.write_text('{"full_ms_per_step": 2.0, "slots": 8, '
                    '"prefill_ms_per_token": 0.125}')
    monkeypatch.setenv("SCHED_PROFILE_JSON", str(prof))
    monkeypatch.setenv("SCHED_ONLINE_CALIB", "0")


def _prompt(n, salt=0):
    return [1] + [3 + (7 * i + salt) % 250 for i in range(n - 1)]


def _drive(engine, streams, limit=600):
    """The port engine's serve loop by hand: each ``_step`` reads its
    outputs back before the next plan."""
    for _ in range(limit):
        if all(s.finish_reason is not None for s in streams) \
                and not engine._slots:
            return streams
        engine._step()
    raise AssertionError("requests did not finish")


def _jax_lockstep(jeng, batches, limit=600):
    """The JAX engine's serve loop by hand, in the port's lockstep (as
    ``tests/test_torch_spec_decode.py`` drives it): each plan waits until
    every dispatched output was read back, so both engines run the same
    rounds over the same slots. Each batch is submitted when the previous
    one finished."""
    jeng._stopped.clear()
    worker = threading.Thread(target=jeng._harvest_worker, daemon=True)
    jeng._harvest_thread = worker
    worker.start()
    out = []
    try:
        for batch in batches:
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
            out.append([s.token_ids for s in streams])
    finally:
        jeng._stopped.set()
        worker.join(TIMEOUT)
        jeng._harvest_thread = None
    return out


def test_engine_greedy_tokens_match_jax_engine(pinned_schedule):
    """Capacity factor 1.0: at decode T = 2 slots, C = 1 a expert, so
    claims drop whenever both slots' choices meet, and an idle slot's
    row claims too. A 70-token prompt admitted in chunks of 32 beside a
    short one, then the long prompt again (a prefix-cache hit), through
    both engines in lockstep: equal greedy tokens, and drops happened."""
    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JConfig
    from generativeaiexamples_tpu.engine import SamplingParams as JParams
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    cfg = dataclasses.replace(CFG, moe_capacity_factor=1.0)
    jcfg = dataclasses.replace(JCFG, moe_capacity_factor=1.0)
    tree = _np_tree(seed=11)
    runs = [[(_prompt(70), 8), (_prompt(9, 1), 10)], [(_prompt(70), 6)]]

    def batch(sp_cls, spec):
        return lambda e: [e.submit(p, sp_cls(max_tokens=m, top_k=1,
                                             ignore_eos=True))
                          for p, m in spec]

    engine = Engine(params_from_numpy(tree, "cpu", torch.float32, cfg=cfg),
                    cfg, ByteTokenizer(), EngineConfig(**ENGINE_KW),
                    device="cpu")
    drops = []
    route = moe.route_topk

    def counting(logits, k, capacity):
        out = route(logits, k, capacity)
        drops.append(int((~out[3]).sum()))
        return out
    moe.route_topk = counting
    try:
        out = [[s.token_ids for s in _drive(engine, batch(SamplingParams,
                                                          spec)(engine))]
               for spec in runs]
    finally:
        moe.route_topk = route
    jeng = JEngine(jax.tree.map(jnp.asarray, tree), jcfg, JTok(),
                   JConfig(**ENGINE_KW))
    jout = _jax_lockstep(jeng, [batch(JParams, spec) for spec in runs])
    assert out == jout
    st = engine.stats
    assert st["prefill_chunks"] >= 3
    assert st["prefix_cache_hit_tokens"] > 0
    assert sum(drops) > 0
    engine.close()


class _HostSyncs(TorchDispatchMode):
    """Records the operations a CUDA graph cannot capture: a device value
    read on the host, a host value copied in, a data-dependent shape
    (``tests/test_torch_graphs.py``'s guard)."""

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


def test_moe_bodies_make_no_host_read(model):
    """The MoE layer, and the engine's admission, decode-round and chunk
    bodies over it (the programs the card captures), read nothing on the
    host: the capacity is static per shape and the routing stays on the
    device."""
    _, _, tp = model
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, 8, 64)).astype(np.float32))
    lp = llama.layer_params(tp, 0)
    with _HostSyncs() as mode:
        moe.sparse_moe_ffn(x, lp, dataclasses.replace(
            CFG, moe_capacity_factor=0.5))
    assert mode.seen == []
    engine = Engine(tp, CFG, ByteTokenizer(), EngineConfig(**ENGINE_KW),
                    device="cpu")
    engine.submit(_prompt(20), SamplingParams(max_tokens=8, top_k=1))
    engine._step()                    # stages a real request's inputs
    for greedy in (True, False):
        with _HostSyncs() as mode:
            engine._admit_body(engine._buckets[-1], greedy)
            engine._round_body(2, greedy)
            engine._chunk_extend_body(engine._buckets[-1],
                                      engine.CHUNK_MODES[0])
            engine._chunk_final_body(engine._buckets[-1], greedy, False)
        assert mode.seen == [], greedy
    engine.close()


# ------------------------------------------------------ training, quant


def test_train_step_loss_and_grads_match_jax(model):
    """``make_train_step``'s loss and the first gradients of the router
    and the expert stacks (through the scatter and the gather) equal
    ``jax.grad`` of the reference's training loss on the same batch, with
    capacity drops (cf 0.5)."""
    from generativeaiexamples_tpu import training as jtraining
    from generativeaiexamples_tpu_torch.training import (make_train_step,
                                                         trainable)
    tree, _, _ = model
    cfg = dataclasses.replace(CFG, moe_capacity_factor=0.5)
    jcfg = dataclasses.replace(JCFG, moe_capacity_factor=0.5)
    rng = np.random.default_rng(8)
    B, S = 2, 12
    seq = rng.integers(3, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 9:] = 0
    batch = {"tokens": seq[:, :-1], "targets": seq[:, 1:], "mask": mask}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    def jfn(p):     # the reference's make_train_step loss_fn
        logits, _ = jllama.apply(p, jcfg, jb["tokens"], positions,
                                 kv_valid_len=jnp.sum(jb["mask"], axis=-1))
        return jtraining.cross_entropy_loss(logits, jb["targets"],
                                            jb["mask"])
    jl, jg = jax.value_and_grad(jfn)(jax.tree.map(jnp.asarray, tree))

    params = params_from_numpy(tree, "cpu", torch.float32, cfg=cfg)
    step = make_train_step(cfg, torch.optim.SGD(trainable(params), lr=0.0))
    loss = step(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in EXPERT_KEYS:
        _close(params["layers"][k].grad, jg["layers"][k], rtol=1e-3,
               atol=1e-6)


def test_quantize_params_leaves_experts_raw(model):
    """int4_awq (group 32) quantizes the attention projections and the
    head bit-equal to the JAX ``quantize_params`` and leaves the router
    and the 4-D expert stacks raw, as the reference does; the quantized
    forward matches the reference's."""
    from generativeaiexamples_tpu.ops.quant import \
        quantize_params as jquantize
    from generativeaiexamples_tpu_torch.ops.quant import (is_quantized,
                                                          quantize_params)
    tree, jp, tp = model
    jq = jax.tree.map(np.asarray, jquantize(jp, "int4_awq", 32))
    mine = quantize_params(tp, "int4_awq", group_size=32)
    quantized = sorted(k for k, v in mine["layers"].items()
                       if is_quantized(v))
    assert quantized == sorted(k for k, v in jq["layers"].items()
                               if isinstance(v, dict))
    assert quantized == ["wk", "wo", "wq", "wv"]
    for key in EXPERT_KEYS:
        assert mine["layers"][key] is tp["layers"][key]
    for key in quantized:
        for leaf, arr in jq["layers"][key].items():
            np.testing.assert_array_equal(mine["layers"][key][leaf].numpy(),
                                          arr)
    carried = params_from_numpy(jq, "cpu", torch.float32, cfg=CFG)
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, CFG.vocab_size, (2, 9)).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    tl, _ = llama.apply(carried, CFG, torch.from_numpy(tokens),
                        torch.from_numpy(pos))
    jl, _ = jllama.apply(jax.tree.map(jnp.asarray, jq), JCFG,
                         jnp.asarray(tokens), jnp.asarray(pos))
    _close(tl, jl, rtol=1e-3, atol=1e-4)


# ------------------------------------------------ checkpoints and serving


def _hf_state(tree, cfg):
    """HF Mixtral names (``block_sparse_moe.*``) for a reference-layout
    tree, each matrix stored (out, in) as HF does."""
    st = {"model.embed_tokens.weight": tree["embed"],
          "model.norm.weight": tree["final_norm"],
          "lm_head.weight": tree["lm_head"].T}
    lay = tree["layers"]
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        st[pre + "input_layernorm.weight"] = lay["attn_norm"][i]
        st[pre + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        for ours, theirs in (("wq", "q"), ("wk", "k"), ("wv", "v"),
                             ("wo", "o")):
            st[pre + f"self_attn.{theirs}_proj.weight"] = lay[ours][i].T
        st[pre + "block_sparse_moe.gate.weight"] = lay["router"][i].T
        for e in range(cfg.num_experts):
            for ours, w in (("w_gate", "w1"), ("w_down", "w2"),
                            ("w_up", "w3")):
                st[pre + f"block_sparse_moe.experts.{e}.{w}.weight"] = \
                    lay[ours][i, e].T
    return {k: torch.from_numpy(np.array(v))
            for k, v in st.items()}


def _hf_config(cfg):
    return {"architectures": ["MixtralForCausalLM"],
            "model_type": "mixtral", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "num_local_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok}


# The checkpoint's geometry: the tiny one at the golden-tiny tokenizer's
# 32k vocabulary.
HF_KW = {**CFG_KW, "vocab_size": 32000}


@pytest.fixture(scope="module")
def mixtral_dir(tmp_path_factory):
    """A tiny Mixtral in an HF directory: two safetensors shards with an
    index, its ``config.json`` and the golden-tiny tokenizer. Returns
    (directory, the reference-layout tree it was written from)."""
    import json
    import shutil

    from generativeaiexamples_tpu_torch.models import safetensors as st
    tree = _np_tree(seed=12, cfg=JL(**HF_KW))
    d = tmp_path_factory.mktemp("mixtral")
    cfg = LlamaConfig(**HF_KW)
    st.save_sharded(_hf_state(tree, cfg), str(d), shards=2)
    (d / "config.json").write_text(json.dumps(_hf_config(cfg)))
    golden = os.path.join(os.path.dirname(__file__), "fixtures",
                          "golden_tiny", "tokenizer.model")
    shutil.copy(golden, d / "tokenizer.model")
    return d, tree


def test_hf_mixtral_checkpoint_loads_as_the_reference(mixtral_dir):
    """The port's loader maps the HF names as the reference's loader does
    (router transposed, experts stacked [layer][expert], transposed):
    bit-equal to the reference's tree and to the tree it was written
    from; an incomplete expert set and an MoE geometry for the GPTQ and
    NeMo loaders raise typed errors."""
    from generativeaiexamples_tpu.models.import_hf import \
        load_checkpoint as jload
    from generativeaiexamples_tpu_torch.models import import_hf
    from generativeaiexamples_tpu_torch.models.configs import \
        config_for_checkpoint
    from generativeaiexamples_tpu_torch.models.import_nemo import \
        load_nemo_checkpoint
    from generativeaiexamples_tpu_torch.models.import_quantized import \
        load_quantized_checkpoint
    from generativeaiexamples_tpu_torch.models.weight_cache import flatten
    from generativeaiexamples_tpu_torch.utils.errors import ModelLoadError
    mixtral_dir, tree = mixtral_dir
    tp = params_from_numpy(tree, "cpu", torch.float32,
                           cfg=LlamaConfig(**HF_KW))
    cfg = config_for_checkpoint(str(mixtral_dir), MIXTRAL_8X7B)
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.hidden_size,
            cfg.num_kv_heads) == (4, 2, 64, 2)
    got = import_hf.load_checkpoint(str(mixtral_dir), cfg,
                                    dtype=torch.float32, device="cpu")
    jcfg = JL(**{f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)})
    want = params_from_numpy(jax.tree.map(np.asarray, jload(
        str(mixtral_dir), jcfg, dtype=jnp.float32)), "cpu", torch.float32,
        cfg=cfg)
    fg, fw, ft = flatten(got), flatten(want), flatten(tp)
    assert set(fg) == set(fw) == set(ft)
    for name in fg:
        assert torch.equal(fg[name], fw[name]), name
        assert torch.equal(fg[name], ft[name]), name
    state = _hf_state(tree, cfg)
    del state["model.layers.1.block_sparse_moe.experts.3.w2.weight"]
    with pytest.raises(ModelLoadError, match="w_down"):
        import_hf.params_from_named_tensors(iter(state.items()), cfg,
                                            torch.float32, "cpu")
    for loader in (load_quantized_checkpoint, load_nemo_checkpoint):
        with pytest.raises(ConfigError, match="mixture-of-experts"):
            loader(str(mixtral_dir), cfg, torch.float32, "cpu")


def test_weight_cache_round_trips_a_served_moe_tree(tmp_path, monkeypatch,
                                                     model):
    """The served int4_awq tree (int4 attention beside raw 4-D experts
    and router) comes back from the weight cache bit-equal."""
    from generativeaiexamples_tpu_torch.models import weight_cache
    from generativeaiexamples_tpu_torch.ops.quant import quantize_params
    monkeypatch.setenv("GAIE_WEIGHT_CACHE_DIR", str(tmp_path / "wc"))
    monkeypatch.delenv("GAIE_WEIGHT_CACHE", raising=False)
    _, _, tp = model
    tree = quantize_params(params_from_numpy(
        jax.tree.map(np.asarray, model[0]), "cpu", torch.bfloat16, cfg=CFG),
        "int4_awq", group_size=32)
    assert weight_cache.save("mixtral-tiny-test", tree)
    back = weight_cache.load("mixtral-tiny-test")
    fa, fb = weight_cache.flatten(tree), weight_cache.flatten(back)
    assert set(fa) == set(fb)
    assert fb["layers/w_gate"].shape == (2, 4, 64, 96)
    for name, t in fa.items():
        assert fb[name].dtype == t.dtype and torch.equal(fb[name], t), name


@pytest.mark.parametrize("source", ["random", "checkpoint"])
def test_build_services_serves_mixtral_on_the_cpu(monkeypatch, tmp_path,
                                                  mixtral_dir, source):
    """``build_services("mixtral-8x7b-instruct", device="cpu")`` serves
    ``/v1/completions`` from random weights (the registry entry cut to
    the tiny geometry) and from the HF directory (its geometry from
    ``config.json``), int4_awq (experts raw) over an int8 pool. The CLI
    takes the reference's model types, ``mixtral`` among them."""
    import json
    import urllib.request

    from conftest import serve_app
    from generativeaiexamples_tpu.serving.model_server import \
        _TYPE_DEFAULT_NAME
    from generativeaiexamples_tpu_torch.models import configs
    from generativeaiexamples_tpu_torch.ops.quant import is_quantized
    from generativeaiexamples_tpu_torch.serving import model_server
    monkeypatch.setenv("GAIE_WEIGHT_CACHE_DIR", str(tmp_path / "wc"))
    monkeypatch.setitem(configs.MODEL_REGISTRY, "mixtral-8x7b-instruct",
                        dataclasses.replace(CFG, vocab_size=32000))
    assert model_server.TYPE_DEFAULT_NAME == _TYPE_DEFAULT_NAME
    ecfg = EngineConfig(max_slots=2, max_input_length=64,
                        max_output_length=8, prefill_buckets=(32, 64),
                        page_size=16, dtype="float32", kv_quant="int8")
    engine, name = model_server.build_services(
        model_server.TYPE_DEFAULT_NAME["mixtral"], engine_cfg=ecfg,
        device="cpu", quantization="int4_awq",
        model_path=str(mixtral_dir[0]) if source == "checkpoint" else "")
    assert name == "mixtral-8x7b-instruct"
    assert engine.model_cfg.num_experts == 4
    lay = engine.params["layers"]
    assert is_quantized(lay["wq"]) and not is_quantized(lay["w_gate"])
    app = model_server.create_server_app(engine, model_name=name)
    try:
        with serve_app(app) as base:
            req = urllib.request.Request(
                base + "/v1/completions", data=json.dumps(
                    {"prompt": "The experts", "max_tokens": 6,
                     "temperature": 0}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                body = json.loads(resp.read())
    finally:
        engine.close()
    assert body["model"] == name and body["object"] == "text_completion"
    assert 1 <= body["usage"]["completion_tokens"] <= 6
