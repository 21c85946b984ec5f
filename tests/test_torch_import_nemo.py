"""``.nemo`` import in the port against the JAX package, on the CPU (the
reference's scenarios: ``tests/test_gptnext.py`` and the NeMo cases of
``tests/test_import_quantized.py``), for both families: the llama family
(swiglu, fused [gate; up]) and GPT-Next (squared-ReLU, layernorm1p
offsets). Leaves must come out bit-equal to the reference importer's
(both only slice and transpose the archive's float32 tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models.configs import GPTNEXT_TINY as JGPT
from generativeaiexamples_tpu.models.configs import LlamaConfig as JConfig
from generativeaiexamples_tpu.models.import_nemo import \
    load_nemo_checkpoint as jload
from generativeaiexamples_tpu_torch.models.configs import (
    GPTNEXT_TINY, LlamaConfig, config_for_checkpoint)
from generativeaiexamples_tpu_torch.models.import_hf import (
    detect_checkpoint_format, load_checkpoint)
from generativeaiexamples_tpu_torch.models.import_nemo import (
    load_nemo_checkpoint, read_flat_yaml)
from generativeaiexamples_tpu_torch.utils.errors import ModelLoadError
from torch_checkpoints import megatron_state, nemo_yaml, write_nemo

LLAMA_KW = dict(vocab_size=64, hidden_size=16, intermediate_size=32,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=4,
                max_position_embeddings=64)
FAMILIES = {
    "llama": (LlamaConfig(**LLAMA_KW), JConfig(**LLAMA_KW)),
    "gptnext": (GPTNEXT_TINY, JGPT),
}


def _tree(jcfg, seed):
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jcfg, jax.random.key(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    layers = {k: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
                  if k.endswith(("_norm", "_norm_b")) else v)
              for k, v in tree["layers"].items()}
    out = {**tree, "layers": layers}
    for k in ("final_norm", "final_norm_b"):
        if k in tree:
            out[k] = tree[k] + rng.standard_normal(tree[k].shape).astype(
                np.float32) * 0.1
    return out


@pytest.fixture(scope="module", params=list(FAMILIES))
def archive(request, tmp_path_factory):
    cfg, jcfg = FAMILIES[request.param]
    tree = _tree(jcfg, 3)
    d = tmp_path_factory.mktemp(f"nemo_{request.param}")
    path = write_nemo(str(d / "model.nemo"), megatron_state(tree, cfg),
                      nemo_yaml(cfg))
    return cfg, jcfg, tree, str(d), path


def test_nemo_import_matches_the_reference(archive):
    """Both families: every leaf equals the tree the archive was made
    from and the reference importer's, bit for bit; the GPT-Next tree
    has no w_gate and carries the norm offsets."""
    cfg, jcfg, tree, d, path = archive
    assert detect_checkpoint_format(d) == "nemo"
    mine = load_checkpoint(d, cfg, torch.float32, "cpu")
    ref = jload(path, jcfg, dtype=jnp.float32)
    assert set(mine["layers"]) == set(ref["layers"]) == set(tree["layers"])
    for key, arr in tree["layers"].items():
        np.testing.assert_array_equal(mine["layers"][key].numpy(), arr,
                                      err_msg=key)
        np.testing.assert_array_equal(np.asarray(ref["layers"][key]), arr,
                                      err_msg=key)
    for key in ("embed", "final_norm", "final_norm_b", "lm_head"):
        assert (key in mine) == (key in ref)
        if key in ref:
            np.testing.assert_array_equal(mine[key].numpy(), tree[key])
    if cfg.mlp == "squared_relu":
        assert "w_gate" not in mine["layers"]
        assert "attn_norm_b" in mine["layers"] and "final_norm_b" in mine


def test_nemo_forward_matches_jax(archive):
    """The imported tree's forward equals the JAX forward over the
    reference's import (rtol 2e-4, atol 1e-5: float32 both)."""
    from generativeaiexamples_tpu_torch.models import llama
    cfg, jcfg, _, d, path = archive
    tokens = np.array([[1, 2, 3, 17]], np.int32)
    pos = np.arange(4, dtype=np.int32)[None, :]
    tl, _ = llama.apply(load_nemo_checkpoint(d, cfg, torch.float32, "cpu"),
                        cfg, torch.from_numpy(tokens), torch.from_numpy(pos))
    jl, _ = jllama.apply(jload(path, jcfg, dtype=jnp.float32), jcfg,
                         jnp.asarray(tokens), jnp.asarray(pos))
    assert torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=1e-5)


def test_nemo_config_mismatch_rejected(archive):
    cfg, _, _, d, _ = archive
    with pytest.raises(ModelLoadError, match="num_layers"):
        load_nemo_checkpoint(d, dataclasses.replace(cfg, num_layers=3),
                             torch.float32, "cpu")


def test_family_mismatch_rejected(archive):
    """A swiglu (2F-row) archive against a squared-ReLU config and the
    reverse error loudly instead of mis-mapping (both importers)."""
    from generativeaiexamples_tpu.utils.errors import \
        ModelLoadError as JModelLoadError
    cfg, jcfg, _, d, path = archive
    if cfg.mlp == "squared_relu":
        other = dataclasses.replace(cfg, norm="rmsnorm", mlp="swiglu")
        jother = dataclasses.replace(jcfg, norm="rmsnorm", mlp="swiglu")
    else:
        other = dataclasses.replace(cfg, mlp="squared_relu")
        jother = dataclasses.replace(jcfg, mlp="squared_relu")
    with pytest.raises(ModelLoadError):
        load_nemo_checkpoint(d, other, torch.float32, "cpu")
    with pytest.raises(JModelLoadError):
        jload(path, jother, dtype=jnp.float32)


def test_yaml_fallback_reads_the_flat_keys_as_pyyaml_does(tmp_path):
    """The importer reads model_config.yaml's top-level scalar keys
    itself: on NeMo-style configs every key it returns equals
    yaml.safe_load's, and it returns every top-level scalar of the
    document (nested blocks and lists skipped). One form differs on
    purpose: PyYAML's YAML 1.1 reads ``1e-5`` (no dot) as a string, the
    reader as YAML 1.2's float, so an archive's ``layernorm_epsilon:
    1e-5`` reaches the geometry whether or not PyYAML is installed."""
    for cfg, _ in FAMILIES.values():
        text = nemo_yaml(cfg, rotary_base=10000, name="'megatron_gpt'",
                         share_embeddings_and_output_weights="False")
        want = yaml.safe_load(text)
        got = read_flat_yaml(text)
        scalars = {k: v for k, v in want.items()
                   if not isinstance(v, (dict, list))}
        assert got == scalars
    assert read_flat_yaml("a: 1\nb:\n  c: 2\nd: 'x: y'  # note\n") == {
        "a": 1, "d": "x: y"}
    text = "layernorm_epsilon: 1e-5\nrotary_base: 500000\n"
    assert yaml.safe_load(text)["layernorm_epsilon"] == "1e-5"
    assert read_flat_yaml(text) == {"layernorm_epsilon": 1e-5,
                                    "rotary_base": 500000}
    cut = dataclasses.replace(GPTNEXT_TINY, num_layers=1)
    write_nemo(str(tmp_path / "m.nemo"), {},
               nemo_yaml(cut).replace("layernorm_epsilon: 1.0e-05",
                                      "layernorm_epsilon: 1e-3"))
    got = config_for_checkpoint(str(tmp_path), GPTNEXT_TINY)
    assert got == dataclasses.replace(cut, rms_norm_eps=1e-3)


def test_build_services_takes_the_archive_geometry(tmp_path, monkeypatch):
    """``config_for_checkpoint`` reads a .nemo's model_config.yaml, so a
    depth-cut archive serves under its own geometry through
    ``build_services`` (a registry name for the family)."""
    from generativeaiexamples_tpu_torch.engine import (EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models.tokenizer import \
        ByteTokenizer
    from generativeaiexamples_tpu_torch.serving.model_server import \
        build_services
    monkeypatch.setenv("GAIE_WEIGHT_CACHE_DIR", str(tmp_path / "wc"))
    cut = dataclasses.replace(GPTNEXT_TINY, num_layers=1)
    tree = _tree(dataclasses.replace(JGPT, num_layers=1), 5)
    write_nemo(str(tmp_path / "m.nemo"), megatron_state(tree, cut),
               nemo_yaml(cut))
    assert config_for_checkpoint(str(tmp_path), GPTNEXT_TINY) == cut
    engine, _ = build_services(
        "gptnext-tiny", model_path=str(tmp_path), device="cpu",
        tokenizer=ByteTokenizer(),
        engine_cfg=EngineConfig(max_slots=2, max_input_length=64,
                                max_output_length=8, prefill_buckets=(32,),
                                page_size=16, dtype="float32",
                                kv_pool_tokens=None))
    assert engine.model_cfg == cut
    with engine:
        s = engine.submit([1, 5, 7, 9], SamplingParams(
            max_tokens=4, top_k=1, ignore_eos=True))
        s.text()
    assert len(s.token_ids) == 4
    engine.close()
