"""The port's mesh, sharding rules, sharded initialization and the
sampler's cross-rank merges (``parallel/``, ``models/llama.py``,
``ops/fused_sampler.py``) against the JAX package, on the CPU.

The port's ``Mesh`` is one rank's view; these tests build it directly
for each rank (no process group: the rules read only the axis sizes and
the rank) and hold it to the reference's ``make_mesh`` over the
conftest's 8 CPU devices. Exact throughout: specs are equal tuples,
shards equal the reference's per-device arrays bit for bit, merged ids
equal, merged logsumexps within 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
from generativeaiexamples_tpu.ops import fused_sampler as jfs
from generativeaiexamples_tpu.ops import quant as jquant
from generativeaiexamples_tpu.parallel import mesh as jmesh
from generativeaiexamples_tpu.parallel import sharding as jsharding
from generativeaiexamples_tpu.utils.errors import ShardingError as JShardErr
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import (LLAMA2_70B,
                                                           MIXTRAL_8X7B,
                                                           LlamaConfig)
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.ops import fused_sampler as tfs
from generativeaiexamples_tpu_torch.parallel import mesh as tmesh
from generativeaiexamples_tpu_torch.parallel import sharding as tsharding
from generativeaiexamples_tpu_torch.utils.errors import (ConfigError,
                                                        ShardingError)

# Geometries: llama with KV 2 (so tp 4 and 8 replicate wk/wv), GPT-Next
# with every bias, a tiny Mixtral.
GEOMS = {
    "llama": dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                  num_layers=2, num_heads=8, num_kv_heads=2, head_dim=16),
    "gptnext": dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                    num_layers=2, num_heads=8, num_kv_heads=8, head_dim=16,
                    norm="layernorm1p", mlp="squared_relu", attn_bias=True,
                    mlp_bias=True),
    "moe": dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=8, num_kv_heads=4, head_dim=8,
                num_experts=4, num_experts_per_tok=2),
}


def _mesh(plan: tmesh.MeshPlan, n: int, rank: int = 0) -> tmesh.Mesh:
    plan = plan.resolve(n)
    return tmesh.Mesh(shape={a: getattr(plan, a) for a in tmesh.AXES},
                      rank=rank, world=n)


def _jmesh(tp: int, **axes):
    plan = jmesh.MeshPlan(tp=tp, **axes)
    n = tp * int(np.prod(list(axes.values()) or [1]))
    return jmesh.make_mesh(plan, jax.devices()[:n])


def _errors(fn):
    try:
        return ("ok", fn())
    except (ValueError, JShardErr, ShardingError) as exc:
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("plan,n", [
    (dict(dp=2), 8), (dict(dp=3), 8), (dict(dp=2, tp=8), 8),
    (dict(tp=4), 4), (dict(pp=2, tp=2), 4), (dict(), 8)])
def test_mesh_plan_resolution_matches_the_reference(plan, n):
    got = _errors(lambda: tmesh.MeshPlan(**plan).resolve(n))
    want = _errors(lambda: jmesh.MeshPlan(**plan).resolve(n))
    assert got[0].replace("ShardingError", "E") == want[0].replace(
        "ShardingError", "E")
    if got[0] == "ok":
        assert dataclasses.astuple(got[1]) == dataclasses.astuple(want[1])
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("spec", ["tp=2", "tp=2,sp=2", " dp=2 , tp=4 ",
                                  "tp", "xx=2", "tp=2,tp=2", "tp=0", ""])
def test_parse_mesh_spec_matches_the_reference(spec):
    assert _errors(lambda: tmesh.parse_mesh_spec(spec)) == \
        _errors(lambda: jmesh.parse_mesh_spec(spec))


def test_mesh_coords_put_tp_innermost():
    """Rank r's coordinates are the reference mesh's device r's: row-major
    over (dp, pp, ep, sp, tp)."""
    jm = jmesh.make_mesh(jmesh.MeshPlan(dp=2, tp=4), jax.devices()[:8])
    devs = np.asarray(jm.devices)
    for r in range(8):
        m = _mesh(tmesh.MeshPlan(dp=2, tp=4), 8, r)
        at = tuple(int(i[0]) for i in np.nonzero(devs == jax.devices()[r]))
        assert tuple(m.coords.values()) == at
        assert m.tp == 4 and m.tp_rank == at[-1] and m.leader == (r == 0)
    # One process without a group: a one-rank mesh, no collective groups.
    single = tmesh.make_mesh(device="cpu")
    assert single.shape == {"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 1}
    assert single.tp_group is None
    assert not tmesh.maybe_init_distributed("", 1, 0, device="cpu")
    with pytest.raises(ConfigError, match="coordinator"):
        tmesh.maybe_init_distributed("", 2, 0, device="cpu")


def _spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_param_specs_match_the_reference(geom, tp):
    """``llama_param_specs`` (KV below tp included) equals the
    reference's, and the head's split (its spec through
    ``quantized_leaf_specs`` for a quantized head) is the reference's
    ``lm_head_specs`` over raw and quantized heads."""
    tcfg, jcfg = LlamaConfig(**GEOMS[geom]), JL(**GEOMS[geom])
    tm, jm = _mesh(tmesh.MeshPlan(tp=tp), tp), _jmesh(tp)
    specs = tsharding.llama_param_specs(tcfg, tm)
    assert _spec_tuples(jsharding.llama_param_specs(jcfg, jm)) == specs
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jcfg, jax.random.key(0), dtype=jnp.float32))
    for mode in (None, "int8", "int4_awq"):
        head = (tree if mode is None else jax.tree.map(
            np.asarray, jquant.quantize_params(tree, mode, group_size=32)))
        got = (tsharding.quantized_leaf_specs(head["lm_head"],
                                              specs["lm_head"])
               if mode else specs["lm_head"])
        assert _spec_tuples(jllama.lm_head_specs(head, jm)) == \
            {"lm_head": got}
    assert llama.kernel_tp_compatible(tcfg, tm) == \
        jllama.kernel_tp_compatible(jcfg, jm)


def test_specs_on_a_dp_tp_mesh_match_the_reference():
    tcfg, jcfg = LlamaConfig(**GEOMS["llama"]), JL(**GEOMS["llama"])
    tm = _mesh(tmesh.MeshPlan(dp=2, tp=4), 8)
    jm = _jmesh(4, dp=2)
    assert _spec_tuples(jsharding.llama_param_specs(jcfg, jm)) == \
        tsharding.llama_param_specs(tcfg, tm)


def _np_tree(cfg: JL, mode, seed=0):
    """The reference's tree in numpy, quantized by its ``quantize_params``
    (``mode``), with AWQ smoothing (``pre_scale``) and GPTQ zero points
    (``gbias``) added to the grouped leaves where asked."""
    tree = jax.tree.map(np.asarray, jllama.init_params(
        cfg, jax.random.key(seed), dtype=jnp.float32))
    if mode is None:
        return tree
    base = "int4_awq" if mode in ("awq", "gptq") else mode
    tree = jax.tree.map(np.asarray,
                        jquant.quantize_params(tree, base, group_size=32))
    rng = np.random.default_rng(seed)
    leaves = [v for v in tree["layers"].values() if isinstance(v, dict)]
    for leaf in leaves + [tree["lm_head"]]:
        if mode == "awq":
            K = 2 * leaf["q4"].shape[-2]
            leaf["pre_scale"] = (1 + rng.random(leaf["q4"].shape[:-2] + (K,))
                                 ).astype(np.float32)
        if mode == "gptq":
            leaf["gbias"] = rng.standard_normal(
                leaf["gscale"].shape).astype(np.float32)
    return tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("mode", [None, "int8", "int4", "awq", "gptq"])
@pytest.mark.parametrize("geom,tp", [("llama", 2), ("llama", 4),
                                     ("gptnext", 4), ("moe", 2)])
def test_shard_params_equals_the_references_device_arrays(geom, tp, mode):
    """Each rank's ``shard_params`` slice of every leaf (raw, int8, int4,
    AWQ ``pre_scale``, GPTQ ``gbias``) equals the array the reference's
    ``jax.device_put`` under its ``NamedSharding`` places on that rank's
    device, and ``params_from_numpy(..., mesh=)`` carries it across."""
    jcfg, tcfg = JL(**GEOMS[geom]), LlamaConfig(**GEOMS[geom])
    tree = _np_tree(jcfg, mode)
    jm = _jmesh(tp)
    placed = jsharding.shard_params(tree, jm,
                                    jsharding.llama_param_specs(jcfg, jm))
    want = dict(_flat(placed))
    for r in range(tp):
        tm = _mesh(tmesh.MeshPlan(tp=tp), tp, r)
        got = dict(_flat(tsharding.shard_params(
            tree, tm, tsharding.llama_param_specs(tcfg, tm))))
        assert got.keys() == want.keys()
        device = jax.devices()[r]
        for key, arr in want.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == device)
            ref = np.asarray(shard.data)
            assert got[key].shape == ref.shape, key
            assert np.array_equal(got[key], ref), key
        carried = dict(_flat(params_from_numpy(tree, "cpu", torch.float32,
                                               cfg=tcfg, mesh=tm)))
        for key, arr in got.items():
            t = carried[key]
            assert tuple(t.shape) == arr.shape, key
            assert np.array_equal(t.numpy(), arr.astype(t.numpy().dtype)), key


@pytest.mark.parametrize("quantization", ["", "int8", "int4", "int4_awq"])
@pytest.mark.parametrize("geom,tp", [("llama", 2), ("llama", 4),
                                     ("gptnext", 2), ("moe", 2)])
def test_sharded_init_is_the_whole_init_split(geom, tp, quantization):
    """``init_params(..., mesh=)`` on each rank equals ``shard_params``
    of the whole tree made from the same seed, quantized whole first:
    a tp model is the tp = 1 model of its seed."""
    cfg = LlamaConfig(**GEOMS[geom])
    whole = llama.init_params(cfg, 5, torch.float32, quantization=quantization,
                              group_size=32)
    for r in range(tp):
        tm = _mesh(tmesh.MeshPlan(tp=tp), tp, r)
        got = dict(_flat(llama.init_params(cfg, 5, torch.float32, mesh=tm,
                                           quantization=quantization,
                                           group_size=32)))
        want = dict(_flat(tsharding.shard_params(
            whole, tm, tsharding.llama_param_specs(cfg, tm))))
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("quantization", ["int8", "int4", "int4_awq"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_quantized_init_is_quantize_params_of_the_raw_init(geom,
                                                           quantization):
    """``init_params(quantization=)`` quantizes the leaves
    ``quantize_params`` quantizes (one ``quantizable`` rule: the
    projections and the head, never the router or the expert stacks),
    and to the same values."""
    from generativeaiexamples_tpu_torch.ops.quant import quantize_params
    cfg = LlamaConfig(**GEOMS[geom])
    got = dict(_flat(llama.init_params(cfg, 5, torch.float32,
                                       quantization=quantization,
                                       group_size=32)))
    want = dict(_flat(quantize_params(llama.init_params(cfg, 5,
                                                        torch.float32),
                                      quantization, group_size=32)))
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_quantizing_a_row_parallel_shard_is_not_the_whole_leaf():
    """Why ``init_params`` quantizes before it splits: per-channel scales
    over a row-parallel weight's K/tp rows (wo, w_down) differ from the
    whole weight's."""
    from generativeaiexamples_tpu_torch.ops.quant import quantize_tensor
    w = torch.randn(64, 16, generator=torch.Generator().manual_seed(0))
    whole = quantize_tensor(w, 8)["scale"]
    half = quantize_tensor(w[:32], 8)["scale"]
    assert not torch.equal(whole, half)


@pytest.mark.parametrize("cfg,tp,want", [
    (LLAMA2_70B, 4, (16, 2, 7168, 8000, None)),
    (MIXTRAL_8X7B, 4, (8, 2, 3584, 8000, None)),
    (LlamaConfig(**GEOMS["llama"]), 4, (2, 1, 64, 128, (0,))),
    (LlamaConfig(**GEOMS["llama"]), 8, (1, 1, 32, 64, (0,))),
])
def test_tp_layout_gives_each_rank_its_heads(cfg, tp, want):
    """A rank's geometry: H/tp query heads, KV/tp kv heads (or, with
    wk/wv replicated, the kv heads its query heads read), F/tp, V/tp."""
    lay = llama.tp_layout(cfg, _FakeGroups(tp))
    got = (lay.cfg.num_heads, lay.cfg.num_kv_heads,
           lay.cfg.intermediate_size, lay.cfg.vocab_size, lay.kv_select)
    assert got == want
    assert lay.q_sharded


class _FakeGroups(tmesh.Mesh):
    """A rank-0 mesh that reports a group (``tp_layout`` only asks
    whether one exists)."""

    def __init__(self, tp: int):
        super().__init__(shape={"dp": 1, "pp": 1, "ep": 1, "sp": 1,
                                "tp": tp}, tp_group=object())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_merges_match_the_reference_under_shard_map(n):
    """The three cross-rank merges over gathered carries equal the
    reference's under ``shard_map`` on ``n`` CPU devices: the running
    argmax (ties to the lowest shard), the candidate top-k (stable
    across shards) and the logsumexp."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    rng = np.random.default_rng(n)
    B, K = 3, 8
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("tp",))
    # Values on a coarse grid so shards tie.
    val = np.round(rng.standard_normal((n, B)) * 2) / 2
    val = val.astype(np.float32)
    idx = (np.arange(n)[:, None] * 100 + rng.integers(0, 100, (n, B))
           ).astype(np.int32)
    # "+ 0.0" turns the grid's -0.0 into 0.0: XLA's top_k orders -0.0
    # below +0.0, a sort (the port's, one card or many) takes them as
    # equal (ROADMAP C).
    cv = (np.sort(np.round(rng.standard_normal((n, B, K)) * 2) / 2,
                  axis=-1)[..., ::-1] + 0.0).astype(np.float32)
    ci = (np.arange(n)[:, None, None] * 100
          + rng.integers(0, 100, (n, B, K))).astype(np.int32)
    cp = rng.standard_normal((n, B, K)).astype(np.float32)
    lse = rng.standard_normal((n, B)).astype(np.float32)

    def body(v, i, cv_, ci_, cp_, l):
        _, win = jfs._merge_running_max("tp", v[0], i[0])
        c = jfs._merge_candidates("tp", cv_[0], ci_[0], cp_[0], K)
        return win, c[0], c[1], c[2], jfs._merge_lse("tp", l[0])

    ref = shard_map(body, mesh=mesh,
                    in_specs=(P("tp"),) * 6, out_specs=(P(),) * 5,
                    check_rep=False)(val, idx, cv, ci, cp, lse)
    ref = [np.asarray(r) for r in ref]
    t = [torch.from_numpy(a) for a in (val, idx, cv, ci, cp, lse)]
    _, win = tfs.merge_running_max(t[0], t[1])
    mv, mi, mp = tfs.merge_candidates(t[2], t[3], t[4], K)
    assert np.array_equal(win.numpy(), ref[0])
    assert np.array_equal(mv.numpy(), ref[1])
    assert np.array_equal(mi.numpy(), ref[2])
    assert np.array_equal(mp.numpy(), ref[3])
    np.testing.assert_allclose(tfs.merge_lse(t[5]).numpy(), ref[4],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("V,n", [(320, 2), (320, 4), (32000, 4),
                                 (32000, 3), (256000, 8), (100, 2)])
def test_tp_shardable_is_the_references(V, n):
    assert tfs.tp_shardable(V, n) == jfs.tp_shardable(V, n)
