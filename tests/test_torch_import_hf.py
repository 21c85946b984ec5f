"""The port's checkpoint import (``models/import_hf.py``) and its
safetensors reader and writer (``models/safetensors.py``) against the JAX
package's loader and the ``safetensors`` and ``transformers`` packages,
on the CPU.

Tolerances: every tree comparison is bit-exact (``torch.equal``): both
loaders read the same stored values and cast them once, float16 ->
float32 exactly and float32 -> bfloat16 rounding to nearest even on both
sides. The forward against transformers' logits: rtol and atol 2e-4.
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.models import import_hf
from generativeaiexamples_tpu_torch.models import safetensors as st
from generativeaiexamples_tpu_torch.models.configs import (
    GOLDEN_TINY, LLAMA2_7B, LLAMA_TINY, config_for_checkpoint)
from generativeaiexamples_tpu_torch.models.convert import params_from_numpy
from generativeaiexamples_tpu_torch.utils.errors import (
    ConfigError, ModelLoadError, UnsupportedFormatError)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_tiny")
GOLDEN_FILE = os.path.join(GOLDEN, "model.safetensors")


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got, want), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_golden_load_matches_jax_loader_bit_for_bit(dtype):
    """golden_tiny's F16 tensors through the port's ``load_checkpoint``
    equal the JAX ``load_checkpoint`` carried over by
    ``convert.params_from_numpy``, bit for bit, in float32 and bf16."""
    from generativeaiexamples_tpu.models.configs import GOLDEN_TINY as JCFG
    from generativeaiexamples_tpu.models.import_hf import \
        load_checkpoint as jload

    jp = jload(GOLDEN, JCFG, dtype=getattr(jnp, dtype))
    want = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                             getattr(torch, dtype), cfg=GOLDEN_TINY)
    got = import_hf.load_checkpoint(GOLDEN, GOLDEN_TINY,
                                    dtype=getattr(torch, dtype),
                                    device="cpu")
    _assert_trees_equal(got, want)


def test_golden_format_and_config():
    assert import_hf.detect_checkpoint_format(GOLDEN) == "safetensors"
    assert config_for_checkpoint(GOLDEN, LLAMA2_7B) == GOLDEN_TINY
    assert config_for_checkpoint(os.path.dirname(GOLDEN),
                                 LLAMA_TINY) == LLAMA_TINY


def test_reader_matches_the_safetensors_package_on_golden():
    from safetensors.torch import load_file
    want = load_file(GOLDEN_FILE)
    got = dict(st.iter_file(GOLDEN_FILE))
    assert set(got) == set(want) and len(got) == 2 + 9 * 2 + 1
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float16, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.int8, torch.int32,
                                   torch.int64])
def test_reader_reads_what_the_package_writes(tmp_path, dtype):
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(3)
    tensors = {
        "a": torch.randn(5, 7, generator=g) * 100,
        "b.scalar": torch.randn((), generator=g) * 100,
        "c": torch.randn(3, 1, 4, generator=g) * 100,
        "empty": torch.zeros(0, 3),
    }
    tensors = {k: v.to(dtype) for k, v in tensors.items()}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = st.load_file(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_writer_round_trips_sharded_with_index(tmp_path):
    """``save_sharded`` over 3 files: the index maps every name to its
    file and totals the bytes; both readers give back every tensor."""
    from safetensors.torch import load_file
    tensors = st.load_file(GOLDEN_FILE)
    files = st.save_sharded(tensors, str(tmp_path), shards=3)
    assert files == [f"model-0000{i}-of-00003.safetensors"
                     for i in (1, 2, 3)]
    with open(tmp_path / st.INDEX_NAME) as f:
        index = json.load(f)
    assert set(index["weight_map"]) == set(tensors)
    assert set(index["weight_map"].values()) == set(files)
    assert index["metadata"]["total_size"] == sum(
        t.numel() * t.element_size() for t in tensors.values())
    back = {}
    for name in files:
        ours = st.load_file(str(tmp_path / name))
        theirs = load_file(str(tmp_path / name))
        assert set(ours) == set(theirs) and ours
        for k in ours:
            assert torch.equal(ours[k], theirs[k])
            assert index["weight_map"][k] == name
        back.update(ours)
    for k, v in tensors.items():
        assert torch.equal(back[k], v), k
    # The sharded directory loads as the single file does.
    got = import_hf.load_checkpoint(str(tmp_path), GOLDEN_TINY,
                                    dtype=torch.float32, device="cpu")
    want = import_hf.load_checkpoint(GOLDEN, GOLDEN_TINY,
                                     dtype=torch.float32, device="cpu")
    _assert_trees_equal(got, want)


def test_misaligned_tensor_offset_still_loads(tmp_path):
    """A 3-byte int8 tensor ahead of a float32 one puts the latter at an
    odd offset (the format allows it): the reader copies it into an
    aligned buffer and gives the stored values."""
    a = np.arange(3, dtype=np.int8)
    b = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    c = np.arange(6, dtype=np.float16)
    header = {"a": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [3, 4],
                    "data_offsets": [3, 51]},
              "c": {"dtype": "F16", "shape": [6], "data_offsets": [51, 63]}}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(blob)) + blob + a.tobytes()
                     + b.tobytes() + c.tobytes())
    got = st.load_file(str(path))
    np.testing.assert_array_equal(got["a"].numpy(), a)
    np.testing.assert_array_equal(got["b"].numpy(), b)
    np.testing.assert_array_equal(got["c"].numpy(), c)
    assert got["b"].data_ptr() % 4 == 0 and got["c"].data_ptr() % 2 == 0


def test_reader_refuses_a_truncated_file(tmp_path):
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", 1 << 20) + b"{}")
    with pytest.raises(ModelLoadError, match="runs past"):
        st.load_file(str(path))


# --------------------------------------------- the other formats, via HF

@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=LLAMA_TINY.vocab_size,
        hidden_size=LLAMA_TINY.hidden_size,
        intermediate_size=LLAMA_TINY.intermediate_size,
        num_hidden_layers=LLAMA_TINY.num_layers,
        num_attention_heads=LLAMA_TINY.num_heads,
        num_key_value_heads=LLAMA_TINY.num_kv_heads,
        max_position_embeddings=LLAMA_TINY.max_position_embeddings,
        rms_norm_eps=LLAMA_TINY.rms_norm_eps,
        rope_theta=LLAMA_TINY.rope_theta, attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


@pytest.fixture(scope="module")
def hf_params(hf_model):
    return import_hf.params_from_hf_model(hf_model, LLAMA_TINY,
                                          dtype=torch.float32, device="cpu")


def _meta_state_dict(hf_model, cfg):
    """HF weights under Meta/fairscale names, q/k rows in the interleaved
    RoPE order (the inverse of HF's conversion permutation)."""
    def permute_to_meta(w, n_heads):
        out_dim, in_dim = w.shape
        return (w.reshape(n_heads, 2, cfg.head_dim // 2, in_dim)
                 .permute(0, 2, 1, 3).reshape(out_dim, in_dim))

    names = {
        "input_layernorm.weight": "attention_norm.weight",
        "post_attention_layernorm.weight": "ffn_norm.weight",
        "self_attn.q_proj.weight": "attention.wq.weight",
        "self_attn.k_proj.weight": "attention.wk.weight",
        "self_attn.v_proj.weight": "attention.wv.weight",
        "self_attn.o_proj.weight": "attention.wo.weight",
        "mlp.gate_proj.weight": "feed_forward.w1.weight",
        "mlp.up_proj.weight": "feed_forward.w3.weight",
        "mlp.down_proj.weight": "feed_forward.w2.weight",
    }
    meta = {}
    for key, t in hf_model.state_dict().items():
        t = t.detach().clone()
        key = key.removeprefix("model.")
        if key == "embed_tokens.weight":
            meta["tok_embeddings.weight"] = t
        elif key == "norm.weight":
            meta["norm.weight"] = t
        elif key == "lm_head.weight":
            meta["output.weight"] = t
        elif ".rotary_emb." not in key:
            _, li, rest = key.split(".", 2)
            if rest == "self_attn.q_proj.weight":
                t = permute_to_meta(t, cfg.num_heads)
            elif rest == "self_attn.k_proj.weight":
                t = permute_to_meta(t, cfg.num_kv_heads)
            meta[f"layers.{li}.{names[rest]}"] = t.contiguous()
    return meta


def test_hf_model_import_matches_the_jax_importer(hf_model, hf_params):
    """``params_from_hf_model`` equals the JAX one, bit for bit."""
    from generativeaiexamples_tpu.models.import_hf import \
        params_from_hf_model as jfrom_hf
    jp = jfrom_hf(hf_model, LLAMA_TINY, dtype=jnp.float32)
    want = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                             torch.float32, cfg=LLAMA_TINY)
    _assert_trees_equal(hf_params, want)


def test_forward_matches_transformers(hf_model, hf_params):
    """The imported tree through the port's ``llama.apply`` gives
    transformers' ``LlamaForCausalLM`` logits within rtol 2e-4 and atol
    2e-4 (the reference's ``test_llama_golden.py`` tolerance; float32,
    different summation orders)."""
    from generativeaiexamples_tpu_torch.models import llama
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, LLAMA_TINY.vocab_size, size=(2, 17), dtype=np.int32))
    positions = torch.arange(17, dtype=torch.int32).expand(2, 17)
    with torch.no_grad():
        ours, _ = llama.apply(hf_params, LLAMA_TINY, tokens, positions)
        theirs = hf_model(tokens.long()).logits.float()
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_pytorch_bin_import_matches_hf(hf_model, hf_params, tmp_path):
    sd = {k: v.detach().clone() for k, v in hf_model.state_dict().items()}
    half = len(sd) // 2
    items = list(sd.items())
    torch.save(dict(items[:half]), tmp_path / "pytorch_model-00001.bin")
    torch.save(dict(items[half:]), tmp_path / "pytorch_model-00002.bin")
    (tmp_path / "training_args.bin").write_bytes(b"not a state dict")
    assert import_hf.detect_checkpoint_format(str(tmp_path)) == "pytorch_bin"
    got = import_hf.load_checkpoint(str(tmp_path), LLAMA_TINY,
                                    dtype=torch.float32, device="cpu")
    _assert_trees_equal(got, hf_params)


@pytest.mark.parametrize("shards", [1, 2])
def test_meta_pth_import_matches_hf(hf_model, hf_params, tmp_path, shards):
    """A Meta rendering of the same weights (fairscale names, interleaved
    RoPE rows), in one consolidated file or two TP shards split along
    each tensor's fairscale axis, loads to the HF tree."""
    meta = _meta_state_dict(hf_model, LLAMA_TINY)
    parts = [{} for _ in range(shards)]
    for key, t in meta.items():
        dim = import_hf._meta_shard_dim(key) if shards > 1 else None
        pieces = ([t] * shards if dim is None
                  else torch.chunk(t, shards, dim=dim))
        for part, piece in zip(parts, pieces):
            part[key] = piece.clone().contiguous()
    parts[0]["rope.freqs"] = torch.ones(LLAMA_TINY.head_dim // 2)
    for i, part in enumerate(parts):
        torch.save(part, tmp_path / f"consolidated.{i:02d}.pth")
    assert import_hf.detect_checkpoint_format(str(tmp_path)) == "meta_pth"
    got = import_hf.load_checkpoint(str(tmp_path), LLAMA_TINY,
                                    dtype=torch.float32, device="cpu")
    _assert_trees_equal(got, hf_params)


def test_safetensors_dir_matches_hf(hf_model, hf_params, tmp_path):
    """The HF state dict written by the port's sharded writer loads to
    the same tree (the path ``chip_smoke.py`` takes at 7B width)."""
    st.save_sharded(hf_model.state_dict(), str(tmp_path), shards=2)
    got = import_hf.load_checkpoint(str(tmp_path), LLAMA_TINY,
                                    dtype=torch.float32, device="cpu")
    _assert_trees_equal(got, hf_params)


# ------------------------------------------------ GPTQ, AWQ and NeMo dirs

# llama-tiny's reduction dims (128, 352) take groups of 32.
QGROUP = 32


def _gptq_dir(d):
    from torch_checkpoints import gptq_state, write_state
    write_state(d, gptq_state(LLAMA_TINY, QGROUP)[0], "safetensors")


def _awq_dir(d):
    from torch_checkpoints import awq_state
    torch.save(awq_state(LLAMA_TINY, QGROUP)[0], d / "pytorch_model.bin")


def _nemo_dir(d):
    from torch_checkpoints import megatron_state, nemo_yaml, write_nemo
    from generativeaiexamples_tpu_torch.models import llama
    tree = llama.init_params(LLAMA_TINY, seed=4, dtype=torch.float32)
    tree = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict)
                else v.numpy()) for k, v in tree.items()}
    write_nemo(str(d / "model.nemo"), megatron_state(tree, LLAMA_TINY),
               nemo_yaml(LLAMA_TINY))


def _gptq_bin_dir(d):
    from torch_checkpoints import gptq_state
    torch.save(gptq_state(LLAMA_TINY, QGROUP, seed=2)[0], d / "model.pt")


@pytest.mark.parametrize("make,fmt", [(_gptq_dir, "gptq"), (_awq_dir, "awq"),
                                      (_nemo_dir, "nemo"),
                                      (_gptq_bin_dir, "gptq")],
                         ids=["gptq", "awq", "nemo", "gptq-pt"])
def test_quantized_and_nemo_dirs_are_refused(tmp_path, make, fmt):
    """Once refused, these formats now load: each directory is sniffed,
    loaded by ``load_checkpoint`` to the tree the JAX package's
    ``load_checkpoint`` makes of it (bit for bit: group-wise int4 leaves
    for GPTQ and AWQ, raw leaves for NeMo), and runs a finite forward."""
    from generativeaiexamples_tpu.models.configs import LLAMA_TINY as JCFG
    from generativeaiexamples_tpu.models.import_hf import \
        load_checkpoint as jload
    from generativeaiexamples_tpu_torch.models import llama
    make(tmp_path)
    assert import_hf.detect_checkpoint_format(str(tmp_path)) == fmt
    got = import_hf.load_checkpoint(str(tmp_path), LLAMA_TINY,
                                    dtype=torch.float32, device="cpu")
    want = params_from_numpy(jax.tree.map(np.asarray, jload(
        str(tmp_path), JCFG, dtype=jnp.float32)), "cpu", torch.float32,
        cfg=LLAMA_TINY)
    _assert_trees_equal(got, want)
    leaf = got["layers"]["w_up"]
    if fmt == "nemo":
        assert isinstance(leaf, torch.Tensor)
    else:
        assert set(leaf) == {"gptq": {"q4", "gscale", "gbias"},
                             "awq": {"q4", "gscale", "pre_scale"}}[fmt]
    logits, _ = llama.apply(got, LLAMA_TINY, torch.tensor([[1, 2, 3]]),
                            torch.arange(3)[None, :])
    assert torch.isfinite(logits).all()


def test_bad_checkpoints_raise_typed_errors(tmp_path):
    tensors = st.load_file(GOLDEN_FILE)
    with pytest.raises(ModelLoadError, match="does not exist"):
        import_hf.load_checkpoint(str(tmp_path / "nope"), GOLDEN_TINY,
                                  device="cpu")
    with pytest.raises(UnsupportedFormatError, match="no recognized"):
        import_hf.load_checkpoint(str(tmp_path), GOLDEN_TINY, device="cpu")
    # A tensor short of a layer.
    part = {k: v for k, v in tensors.items()
            if k != "model.layers.1.mlp.up_proj.weight"}
    with pytest.raises(ModelLoadError, match="w_up"):
        import_hf.params_from_named_tensors(iter(part.items()), GOLDEN_TINY,
                                            torch.float32, "cpu")
    # A geometry the tensors do not fit, a layer past the config's depth.
    with pytest.raises(ConfigError, match="shape"):
        import_hf.params_from_named_tensors(iter(tensors.items()),
                                            LLAMA_TINY, torch.float32, "cpu")
    from dataclasses import replace
    with pytest.raises(ConfigError, match="past the config"):
        import_hf.params_from_named_tensors(
            iter(tensors.items()), replace(GOLDEN_TINY, num_layers=1),
            torch.float32, "cpu")
    moe = {"model.layers.0.block_sparse_moe.gate.weight": torch.zeros(2, 2)}
    with pytest.raises(ConfigError, match="experts"):
        import_hf.params_from_named_tensors(iter(moe.items()), GOLDEN_TINY,
                                            torch.float32, "cpu")
    # The device rule of every entry point.
    if not torch.cuda.is_available():
        with pytest.raises(ConfigError, match="no CUDA device"):
            import_hf.load_checkpoint(GOLDEN, GOLDEN_TINY)
