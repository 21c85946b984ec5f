"""Ring attention of the port (``parallel/ring_attention.py``) on four
spawned gloo ranks (``tests/torch_mesh_ranks.py``, spawned once for the
module) against the JAX package's ``ring_gqa_attention`` under
``shard_map`` on the conftest's CPU devices and against dense
``gqa_attention``, with the same numpy inputs, float32, tolerance 1e-5 x
max|ref|: sp = 4 and sp = 2 (dp = 2 x sp = 2), causal and not, queries
tiled across the shard, a query shard whose first visiting blocks are
fully masked."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks
from generativeaiexamples_tpu.ops.attention import gqa_attention as jgqa
from generativeaiexamples_tpu.parallel import MeshPlan as JPlan
from generativeaiexamples_tpu.parallel import make_mesh as jmake_mesh
from generativeaiexamples_tpu.parallel.ring_attention import \
    ring_gqa_attention as jring
from generativeaiexamples_tpu_torch.ops.attention import gqa_attention
from generativeaiexamples_tpu_torch.parallel import ring_attention as tring
from generativeaiexamples_tpu_torch.parallel.mesh import Mesh

TIMEOUT = 240
RTOL = 1e-5
B, S, H, KV, HD = 2, 32, 8, 2, 16
# sp = 4 and dp = 2 x sp = 2 over the same four ranks; 3-row query tiles
# do not divide the shard, so the last tile of each is short.
PLANS = {"sp4": dict(sp=4), "dp2_sp2": dict(dp=2, sp=2)}


def _case(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return dict(q=q, k=k, v=v, pos=pos)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp
    jobs = [dict(name=name, drive="ring", plan=plan, q_tile=3, **_case())
            for name, plan in PLANS.items()]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    path = str(tmp_path_factory.mktemp("ring") / "group")
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


def _jax_ring(plan: dict, causal: bool) -> np.ndarray:
    """The reference's ring over sp under ``shard_map`` (batch over dp)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    c = _case()
    n = int(np.prod(list(plan.values())))
    mesh = jmake_mesh(JPlan(**plan), jax.devices()[:n])
    dp = "dp" if plan.get("dp", 1) > 1 else None
    spec = P(dp, "sp")
    fn = shard_map(
        lambda q, k, v, p: jring(q, k, v, p, axis_name="sp",
                                 axis_size=plan["sp"], causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec, spec), out_specs=spec,
        check_rep=False)
    return np.asarray(jax.jit(fn)(*(jnp.asarray(c[n]) for n in
                                    ("q", "k", "v", "pos"))))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_ring_matches_the_references_ring_and_dense(ranks, name, causal):
    """Every rank's block of the port's ring equals the reference ring's
    and dense attention's rows there (causality across shards by
    absolute position; the non-causal ring sees every key)."""
    got = ranks.get()[name]
    c = _case()
    want = _jax_ring(PLANS[name], causal)
    dense = np.asarray(jgqa(*(jnp.asarray(c[n]) for n in ("q", "k", "v")),
                            jnp.asarray(c["pos"]), None, causal=causal))
    n_sp = PLANS[name]["sp"]
    per = S // n_sp
    for coords, res in got:
        rows = slice(coords["sp"] * per, (coords["sp"] + 1) * per)
        block = res[f"causal={causal}"]
        for ref in (want, dense):
            np.testing.assert_allclose(
                block, ref[:, rows], rtol=0,
                atol=RTOL * np.abs(ref).max())
    # dp replicas of one sp rank hold the same block.
    by_sp: dict = {}
    for coords, res in got:
        by_sp.setdefault(coords["sp"], []).append(res[f"causal={causal}"])
    for blocks in by_sp.values():
        for b in blocks[1:]:
            np.testing.assert_array_equal(b, blocks[0])


def test_fully_masked_block_contributes_exactly_zero():
    """A visiting block every key of which lies after every query leaves
    the softmax state exactly as it was (the masked-exp trick, not
    exp(NEG - NEG)); the next block's update then equals a fresh one."""
    g = torch.Generator().manual_seed(3)
    Bq, tq, Sk, hd, G = 1, 4, 6, 8, 2
    qk = torch.randn(Bq * KV, G * tq, hd, generator=g)
    kb = torch.randn(Bq * KV, Sk, hd, generator=g)
    vb = torch.randn(Bq * KV, Sk, hd, generator=g)
    pos = torch.arange(tq, dtype=torch.int32)[None]
    fresh = [torch.zeros(Bq * KV, G * tq, hd),
             torch.full((Bq * KV, G * tq), tring.NEG_INF),
             torch.zeros(Bq * KV, G * tq)]
    state = [t.clone() for t in fresh]
    # Keys at positions 100.. are after every query: all masked.
    tring.block_update(*state, qk, pos, kb, vb, 100, True, 0.3)
    for a, b in zip(state, fresh):
        assert torch.equal(a, b)
    tring.block_update(*state, qk, pos, kb, vb, 0, True, 0.3)
    tring.block_update(*fresh, qk, pos, kb, vb, 0, True, 0.3)
    for a, b in zip(state, fresh):
        assert torch.equal(a, b)


def test_ring_of_one_shard_is_dense_attention_in_tiles():
    """With sp = 1 worth of keys (the local block only) the ring's tiled
    block update is dense causal GQA: one tile or many."""
    c = _case(1)
    q, k, v, pos = (torch.from_numpy(c[n]) for n in ("q", "k", "v", "pos"))
    mesh = Mesh(shape={"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 1})
    want = gqa_attention(q, k, v, pos)
    for tile in (S, 5):
        got = tring.ring_gqa_attention(q, k, v, pos, mesh=mesh, q_tile=tile)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=RTOL * want.abs().max().item())
