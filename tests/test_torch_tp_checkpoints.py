"""Checkpoints read rank by rank: every format the port reads, loaded with
a tensor-parallel rank's mesh, gives that rank's shard of the whole tree
bit for bit, against both the port's whole load split by
``shard_params`` and the JAX package's importer's tree split the same
way (``params_from_numpy(..., mesh=)``), on the same files.

Loading holds no collective, so each rank's view is a ``Mesh`` made
here (no process group); the ranks of the serving path, the weight cache
and the quantization at load (a MAX all-reduce) run in gloo processes in
``tests/test_torch_tp_features.py``. float32 throughout; nothing here has
a tolerance."""

import os

import jax
import numpy as np
import pytest
import torch

from torch_checkpoints import hf_state, write_hf_dir

from generativeaiexamples_tpu_torch.models import import_hf, llama
from generativeaiexamples_tpu_torch.models import weight_cache
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.parallel import mesh as tmesh
from generativeaiexamples_tpu_torch.parallel.sharding import (
    llama_param_specs, shard_params)
from generativeaiexamples_tpu_torch.utils.errors import ConfigError

# Heads 4 / kv heads 2: kv heads split at tp = 2 and are replicated (each
# rank keeping the ones its query heads read) at tp = 4.
LLAMA = dict(vocab_size=320, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             max_position_embeddings=256)
MOE = dict(LLAMA, intermediate_size=96, num_experts=4, num_experts_per_tok=2)
# GPTQ/AWQ groups that tile each rank's K rows at tp = 2 and 4.
GROUP = 16


def _mesh(tp: int, rank: int) -> tmesh.Mesh:
    return tmesh.Mesh(shape={"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": tp},
                      rank=rank, world=tp, tp_group=object())


def _tree(cfg: LlamaConfig, seed: int) -> dict:
    """A float32 numpy tree of ``cfg`` with random norms."""
    t = llama.init_params(cfg, seed=seed, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    tree = {k: ({n: x.numpy() for n, x in v.items()} if isinstance(v, dict)
                else v.numpy()) for k, v in t.items()}
    for leaves, key in ((tree["layers"], "attn_norm"),
                        (tree["layers"], "mlp_norm"), (tree, "final_norm")):
        leaves[key] = (1 + 0.1 * rng.standard_normal(leaves[key].shape)
                       ).astype(np.float32)
    return tree


def write_safetensors(d, cfg, tree) -> str:
    """Three files and their index, as HF releases ship."""
    return write_hf_dir(str(d), cfg, tree, shards=3)


def write_bin(d, cfg, tree) -> str:
    os.makedirs(d, exist_ok=True)
    torch.save(hf_state(tree, cfg), os.path.join(d, "pytorch_model.bin"))
    return str(d)


def write_meta(d, cfg, tree, mp: int = 2) -> str:
    """Meta ``consolidated.0i.pth`` files: q/k rows in the interleaved
    RoPE order, every tensor split over ``mp`` files along fairscale's
    axis (``import_hf._META_SHARD_DIM``)."""
    def to_meta(w, n):
        out_dim, in_dim = w.shape
        return (w.reshape(n, 2, cfg.head_dim // 2, in_dim)
                 .permute(0, 2, 1, 3).reshape(out_dim, in_dim))
    names = {"input_layernorm.weight": "attention_norm.weight",
             "post_attention_layernorm.weight": "ffn_norm.weight",
             "self_attn.q_proj.weight": "attention.wq.weight",
             "self_attn.k_proj.weight": "attention.wk.weight",
             "self_attn.v_proj.weight": "attention.wv.weight",
             "self_attn.o_proj.weight": "attention.wo.weight",
             "mlp.gate_proj.weight": "feed_forward.w1.weight",
             "mlp.up_proj.weight": "feed_forward.w3.weight",
             "mlp.down_proj.weight": "feed_forward.w2.weight"}
    meta = {}
    for key, t in hf_state(tree, cfg).items():
        key = key.removeprefix("model.")
        if key == "embed_tokens.weight":
            meta["tok_embeddings.weight"] = t
        elif key in ("norm.weight",):
            meta[key] = t
        elif key == "lm_head.weight":
            meta["output.weight"] = t
        else:
            _, li, rest = key.split(".", 2)
            if rest == "self_attn.q_proj.weight":
                t = to_meta(t, cfg.num_heads)
            elif rest == "self_attn.k_proj.weight":
                t = to_meta(t, cfg.num_kv_heads)
            meta[f"layers.{li}.{names[rest]}"] = t
    os.makedirs(d, exist_ok=True)
    for i in range(mp):
        part = {}
        for k, t in meta.items():
            dim = import_hf._meta_shard_dim(k)
            part[k] = (t.clone() if dim is None
                       else t.chunk(mp, dim)[i].contiguous())
        torch.save(part, os.path.join(d, f"consolidated.{i:02d}.pth"))
    return str(d)


def write_gptq(d, cfg, tree) -> str:
    from torch_checkpoints import gptq_state, write_state
    return write_state(str(d), gptq_state(cfg, GROUP, seed=3)[0],
                       "safetensors")


def write_awq(d, cfg, tree) -> str:
    from torch_checkpoints import awq_state
    os.makedirs(d, exist_ok=True)
    torch.save(awq_state(cfg, GROUP, seed=4)[0],
               os.path.join(d, "pytorch_model.bin"))
    return str(d)


def write_nemo(d, cfg, tree) -> str:
    from torch_checkpoints import megatron_state, nemo_yaml
    from torch_checkpoints import write_nemo as write
    os.makedirs(d, exist_ok=True)
    write(os.path.join(d, "model.nemo"), megatron_state(tree, cfg),
          nemo_yaml(cfg))
    return str(d)


WRITERS = {"safetensors": write_safetensors, "bin": write_bin,
           "meta_pth": write_meta, "gptq": write_gptq, "awq": write_awq,
           "nemo": write_nemo}


def _jax_tree(path, cfg):
    """The JAX package's import of ``path``, as numpy."""
    from generativeaiexamples_tpu.models.configs import LlamaConfig as JL
    from generativeaiexamples_tpu.models.import_hf import \
        load_checkpoint as jload
    import jax.numpy as jnp
    from dataclasses import asdict
    tree = jload(path, JL(**asdict(cfg)), dtype=jnp.float32)
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return weight_cache.flatten(tree)


def _assert_equal(got, want, label):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), label
    for k in g:
        assert g[k].dtype == w[k].dtype, (label, k, g[k].dtype, w[k].dtype)
        assert torch.equal(g[k], w[k]), (label, k)


@pytest.mark.parametrize("fmt,kind,tp", [
    ("safetensors", "llama", 2), ("safetensors", "llama", 4),
    ("bin", "llama", 2), ("meta_pth", "llama", 2), ("gptq", "llama", 2),
    ("gptq", "llama", 4), ("awq", "llama", 2), ("nemo", "llama", 2),
    ("safetensors", "moe", 2)])
def test_each_rank_reads_its_shard_bit_for_bit(tmp_path, fmt, kind, tp):
    """Every rank's ``load_checkpoint(..., mesh=)`` equals ``shard_params``
    of the port's whole load and of the JAX importer's tree, leaf for
    leaf and bit for bit: bf16-free float32 leaves, GPTQ's q4/gscale/gbias
    and AWQ's pre_scale cut on whole packed words and groups, Meta's two
    model-parallel files, a ``.nemo`` archive read leaf by leaf, a
    Mixtral (each expert's w1/w3 by columns, w2 by rows, the router
    whole)."""
    cfg = LlamaConfig(**(MOE if kind == "moe" else LLAMA))
    path = WRITERS[fmt](tmp_path / fmt, cfg, _tree(cfg, 7))
    whole = import_hf.load_checkpoint(path, cfg, torch.float32, "cpu")
    ref = _jax_tree(path, cfg)
    for rank in range(tp):
        mesh = _mesh(tp, rank)
        got = import_hf.load_checkpoint(path, cfg, torch.float32, "cpu",
                                        mesh=mesh)
        _assert_equal(got, shard_params(whole, mesh,
                                        llama_param_specs(cfg, mesh)),
                      f"{fmt} tp={tp} rank {rank} vs the port's whole")
        _assert_equal(got, params_from_numpy(ref, "cpu", torch.float32,
                                             cfg=cfg, mesh=mesh),
                      f"{fmt} tp={tp} rank {rank} vs the JAX importer")


def test_a_rank_block_off_the_checkpoint_groups_is_refused(tmp_path):
    """A group-128 GPTQ checkpoint of llama-2-7b's FFN width at tp = 4:
    each rank would hold F/4 = 2752 rows of w_down, 21.5 groups, so the
    load is refused with ``ConfigError`` naming the dims; at tp = 2 (5504
    rows, 43 groups) it loads."""
    from torch_checkpoints import gptq_state, write_state
    cfg = LlamaConfig(vocab_size=256, hidden_size=512,
                      intermediate_size=11008, num_layers=1, num_heads=4,
                      num_kv_heads=4, head_dim=128,
                      max_position_embeddings=256)
    path = write_state(str(tmp_path / "gptq7b"),
                       gptq_state(cfg, 128, seed=5)[0], "safetensors")
    with pytest.raises(ConfigError, match=r"2752 of K=11008 rows .* "
                                          r"128-row groups"):
        import_hf.load_checkpoint(path, cfg, torch.float32, "cpu",
                                  mesh=_mesh(4, 1))
    got = import_hf.load_checkpoint(path, cfg, torch.float32, "cpu",
                                    mesh=_mesh(2, 1))
    assert got["layers"]["w_down"]["gscale"].shape == (1, 43, 512)


def test_each_rank_keeps_its_own_weight_cache_entries(tmp_path,
                                                      monkeypatch):
    """A save prunes only entries of its own model, dtype, quantization
    and rank (the identity's prefix and an old content hash): another
    rank's entry, another topology's and the one-card entry stay."""
    monkeypatch.setenv("GAIE_WEIGHT_CACHE_DIR", str(tmp_path))
    tree = {"w": torch.ones(2)}
    names = ["m-float32-raw-aaaa", "m-float32-raw-tp2-r0-aaaa",
             "m-float32-raw-tp2-r1-aaaa", "m-float32-raw-tp4-r0-aaaa"]
    for name in names:
        assert weight_cache.save(name, tree)
    assert weight_cache.save("m-float32-raw-tp2-r0-bbbb", tree,
                             prune_prefix="m-float32-raw-tp2-r0-")
    kept = sorted(n.removesuffix("-torch") for n in os.listdir(tmp_path))
    assert kept == sorted(set(names) - {"m-float32-raw-tp2-r0-aaaa"}
                          | {"m-float32-raw-tp2-r0-bbbb"})
    assert weight_cache.save("m-float32-raw-cccc", tree,
                             prune_prefix="m-float32-raw-")
    kept = sorted(n.removesuffix("-torch") for n in os.listdir(tmp_path))
    assert "m-float32-raw-aaaa" not in kept
    assert "m-float32-raw-tp2-r1-aaaa" in kept


def _mapped(path: str) -> bool:
    """Whether this process maps ``path`` (``/proc/self/maps``)."""
    with open("/proc/self/maps") as f:
        return any(line.rstrip().endswith(path) for line in f)


@pytest.mark.parametrize("dtype,shape,idx", [
    (torch.bfloat16, (12, 40), (slice(3, 9),)),              # rows
    (torch.bfloat16, (12, 40), (slice(None), slice(10, 20))),  # row spans
    (torch.int32, (6, 4, 10), (slice(1, 3), slice(None), slice(5, 10))),
    (torch.float16, (5, 6, 8), (slice(None), slice(2, 4))),
    (torch.float32, (7,), ()),                                 # whole
])
def test_a_stored_block_equals_the_mapped_block(tmp_path, dtype, shape,
                                                idx):
    """``StoredTensor[idx]`` (read span by span) gives the bytes of the
    memory-mapped tensor's block, and leaves the file unmapped."""
    from generativeaiexamples_tpu_torch.models import safetensors as st
    rng = np.random.default_rng(len(shape))
    full = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, size=shape,
                                         dtype=np.int32)).to(dtype)
    path = str(tmp_path / "t.safetensors")
    # A leading odd-sized tensor puts the block's tensor at an offset that
    # is no multiple of a row.
    st.save_file({"pad": torch.zeros(3, dtype=torch.int8), "t": full}, path)
    stored = dict(st.iter_stored(path))["t"]
    got = stored[idx]
    assert got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got, full[idx])
    assert torch.equal(stored.read(), full)
    assert not _mapped(path)
