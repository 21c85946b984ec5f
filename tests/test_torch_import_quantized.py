"""GPTQ and AWQ checkpoint import in the port against the JAX package, on
the CPU (the reference's scenarios, ``tests/test_import_quantized.py``).

Synthetic checkpoints in the wire formats (``torch_checkpoints.py``) go
through both packages' importers. The quantized leaves must come out bit
for bit the same (both do the reference's float32 arithmetic on the same
bytes); products and forwards are held as stated per test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.models.configs import LlamaConfig as JConfig
from generativeaiexamples_tpu.models.import_quantized import \
    load_quantized_checkpoint as jload
from generativeaiexamples_tpu.ops import quant as jquant
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.models.configs import LlamaConfig
from generativeaiexamples_tpu_torch.models.import_hf import (
    detect_checkpoint_format, load_checkpoint, sniff_quantized_format)
from generativeaiexamples_tpu_torch.models.import_quantized import \
    load_quantized_checkpoint
from generativeaiexamples_tpu_torch.ops import quant
from generativeaiexamples_tpu_torch.ops.int4_matmul import int4_matmul
from generativeaiexamples_tpu_torch.utils.errors import ModelLoadError
from torch_checkpoints import awq_state, gptq_state, write_state

# The reference's tiny geometry: D=16, F=32, L=2, H=4, KV=2, hd=4, V=64,
# group 8.
KW = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=2,
          num_heads=4, num_kv_heads=2, head_dim=4,
          max_position_embeddings=64)
TINY, JTINY = LlamaConfig(**KW), JConfig(**KW)
GROUP = 8


def _leaf(tree, key, i):
    return {k: v[i] for k, v in tree["layers"][key].items()}


@pytest.fixture(scope="module")
def gptq(tmp_path_factory):
    state, golden = gptq_state(TINY, GROUP)
    d = write_state(tmp_path_factory.mktemp("gptq"), state, "pt")
    return (d, golden, load_quantized_checkpoint(d, TINY, torch.float32,
                                                 "cpu"),
            jload(d, JTINY, dtype=jnp.float32))


@pytest.fixture(scope="module")
def awq(tmp_path_factory):
    state, golden = awq_state(TINY, GROUP)
    d = write_state(tmp_path_factory.mktemp("awq"), state, "pt")
    return (d, golden, load_quantized_checkpoint(d, TINY, torch.float32,
                                                 "cpu"),
            jload(d, JTINY, dtype=jnp.float32))


def _assert_leaves_equal(mine, ref):
    assert set(mine["layers"]) == set(ref["layers"])
    for key, leaf in ref["layers"].items():
        if isinstance(leaf, dict):
            assert set(mine["layers"][key]) == set(leaf), key
            for name, arr in leaf.items():
                got = mine["layers"][key][name]
                assert got.dtype == (torch.int8 if name == "q4"
                                     else torch.float32), (key, name)
                np.testing.assert_array_equal(got.numpy(), np.asarray(arr),
                                              err_msg=f"{key}/{name}")
        else:
            np.testing.assert_array_equal(mine["layers"][key].numpy(),
                                          np.asarray(leaf), err_msg=key)
    for key in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(mine[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)


def test_gptq_golden_dequant_parity(gptq):
    """The sniffers name the format; every GPTQ leaf equals the
    reference importer's bit for bit and dequantizes to the weights the
    checkpoint encodes (rtol/atol 1e-6: the zero-point product is one
    float32 rounding)."""
    d, golden, mine, ref = gptq
    assert sniff_quantized_format(d) == "gptq"
    assert detect_checkpoint_format(d) == "gptq"
    _assert_leaves_equal(mine, ref)
    for i in range(TINY.num_layers):
        for key, proj in (("wq", "self_attn.q_proj"),
                          ("w_down", "mlp.down_proj")):
            leaf = _leaf(mine, key, i)
            assert set(leaf) == {"q4", "gscale", "gbias"}
            np.testing.assert_allclose(
                quant.dequantize(leaf, torch.float32).numpy(),
                golden[f"{i}.{proj}"], rtol=1e-6, atol=1e-6)


def test_gptq_matmul_matches_dequant(gptq):
    """The port's product of a GPTQ leaf (on the CPU the reference's
    ``_grouped_matmul``) against x @ the encoded weight (rtol/atol 1e-5)
    and against the JAX product of the same leaf (1e-6)."""
    _, golden, mine, ref = gptq
    x = np.random.default_rng(3).standard_normal((2, 16)).astype(np.float32)
    y = quant.matmul(torch.from_numpy(x), _leaf(mine, "w_up", 0)).numpy()
    np.testing.assert_allclose(y, x @ golden["0.mlp.up_proj"], rtol=1e-5,
                               atol=1e-5)
    jy = np.asarray(jquant.matmul(jnp.asarray(x), _leaf(ref, "w_up", 0)))
    np.testing.assert_allclose(y, jy, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gbias_plain_version_matches_jax_grouped_matmul(dtype):
    """``int4_matmul_plain`` with GPTQ zero points (what a CPU tensor
    takes, and what the kernel is held to on the card) against the JAX
    ``_grouped_matmul`` on the same leaf and inputs, at a width whose
    groups the tensor-core paths take (K = 256, group 128). float32:
    1e-5 (the same float32 terms summed in another order: einsum's
    against the frameworks' own, about 256 ulps of the outputs' scale);
    bf16 x and out: one bf16 rounding of the same float32 sum, so 8e-3."""
    rng = np.random.default_rng(9)
    K, N, G = 256, 64, 2
    q = rng.integers(-8, 8, (K, N)).astype(np.int8)
    q4 = ((q[0::2] & 0x0F) | (q[1::2] << 4)).astype(np.int8)
    gscale = rng.uniform(0.01, 0.05, (G, N)).astype(np.float32)
    gbias = ((7 - rng.integers(0, 16, (G, N))) * gscale).astype(np.float32)
    x = rng.standard_normal((5, K)).astype(np.float32)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = int4_matmul(torch.from_numpy(x).to(td), torch.from_numpy(q4),
                      torch.from_numpy(gscale), gbias=torch.from_numpy(gbias))
    want = jquant._grouped_matmul(
        jnp.asarray(x).astype(jd), jnp.asarray(q),
        {"gscale": jnp.asarray(gscale), "gbias": jnp.asarray(gbias)})
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_gptq_forward_matches_jax(gptq):
    """A forward over the GPTQ tree: logits equal the JAX forward over the
    reference importer's tree (rtol 1e-4, atol 1e-5; float32 both)."""
    _, _, mine, ref = gptq
    tokens = np.array([[1, 5, 9, 33]], np.int32)
    pos = np.arange(4, dtype=np.int32)[None, :]
    tl, _ = llama.apply(mine, TINY, torch.from_numpy(tokens),
                        torch.from_numpy(pos))
    jl, _ = jllama.apply(ref, JTINY, jnp.asarray(tokens), jnp.asarray(pos))
    assert torch.isfinite(tl).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)


def test_gptq_safetensors_loads_as_pt(tmp_path, gptq):
    """The same GPTQ tensors as a safetensors file, read by the port's own
    reader, through ``load_checkpoint``: the same tree."""
    state, _ = gptq_state(TINY, GROUP)
    d = write_state(tmp_path, state, "safetensors")
    _assert_leaves_equal(load_checkpoint(d, TINY, torch.float32, "cpu"),
                         gptq[3])


def test_gptq_act_order_is_refused(tmp_path):
    """A non-trivial g_idx (act-order) is refused by both importers."""
    from generativeaiexamples_tpu.utils.errors import \
        ModelLoadError as JModelLoadError
    state, _ = gptq_state(TINY, GROUP, act_order=True)
    d = write_state(tmp_path, state, "pt")
    with pytest.raises(ModelLoadError, match="act-order"):
        load_quantized_checkpoint(d, TINY, torch.float32, "cpu")
    with pytest.raises(JModelLoadError, match="act-order"):
        jload(d, JTINY, dtype=jnp.float32)


def test_awq_import_parity(awq):
    """AWQ leaves bit-equal to the reference's; the dequantized weight
    (pre-scale folded in) within the int4 rounding bound of the
    checkpoint's; the product exact against x @ the dequantized weight
    (rtol 1e-5) and equal to the JAX product (1e-6)."""
    d, golden, mine, ref = awq
    assert sniff_quantized_format(d) == "awq"
    _assert_leaves_equal(mine, ref)
    w, pre = golden["0.self_attn.q_proj"]
    wT = w.T
    leaf = _leaf(mine, "wq", 0)
    assert set(leaf) == {"q4", "gscale", "pre_scale"}
    deq = quant.dequantize(leaf, torch.float32).numpy()
    K, N = wT.shape
    G = K // GROUP
    amax = np.abs(w).reshape(N, G, GROUP).max(-1)
    scale_rep = np.repeat(amax.T / 8.0, GROUP, axis=0)
    # Half an LSB of rounding, one LSB where a positive group maximum
    # clips from 8 to 7.
    assert (np.abs(deq - pre[:, None] * wT)
            <= pre[:, None] * scale_rep * 1.01 + 1e-6).all()
    x = np.random.default_rng(5).standard_normal((3, 16)).astype(np.float32)
    y = quant.matmul(torch.from_numpy(x), leaf).numpy()
    np.testing.assert_allclose(y, x @ deq, rtol=1e-5, atol=1e-5)
    jy = np.asarray(jquant.matmul(jnp.asarray(x), _leaf(ref, "wq", 0)))
    np.testing.assert_allclose(y, jy, rtol=1e-6, atol=1e-6)


def test_int4_awq_mode_quantizes_grouped_and_runs():
    """quantize_params(int4_awq) on the same numpy tree as the JAX
    package's: the same bytes, and the quantized forward tracks the
    float one (cos > 0.85, the reference's bar)."""
    from generativeaiexamples_tpu_torch.models.convert import \
        params_from_numpy
    tree = jax.tree.map(np.asarray, jllama.init_params(
        JTINY, jax.random.key(0), dtype=jnp.float32))
    params = params_from_numpy(tree, "cpu", torch.float32, cfg=TINY)
    qp = quant.quantize_params(params, "int4_awq", group_size=GROUP)
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, tree), "int4_awq",
                                group_size=GROUP)
    assert "gscale" in qp["layers"]["wq"]
    assert qp["layers"]["wq"]["q4"].shape[1] == TINY.hidden_size // 2
    for leaf in ("q4", "gscale"):
        np.testing.assert_array_equal(qp["layers"]["w_down"][leaf].numpy(),
                                      np.asarray(jq["layers"]["w_down"][leaf]))
    tokens = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)[None, :]
    logits, _ = llama.apply(qp, TINY, tokens, pos)
    ref, _ = llama.apply(params, TINY, tokens, pos)
    assert torch.isfinite(logits).all()
    cos = float((logits * ref).sum() / (logits.norm() * ref.norm()))
    assert cos > 0.85


def test_grouped_quantize_roundtrip():
    """Group-wise int4 round trip within half an LSB, bit-equal to the
    JAX quantizer."""
    w = np.random.default_rng(7).standard_normal((32, 8)).astype(np.float32)
    leaf = quant.quantize_tensor_grouped(torch.from_numpy(w), group_size=8)
    deq = quant.dequantize(leaf, torch.float32)
    scale_rep = leaf["gscale"].repeat_interleave(8, dim=0)
    assert float(((deq - torch.from_numpy(w)).abs() / scale_rep).max()) \
        <= 0.5 + 1e-3
    jleaf = jquant.quantize_tensor_grouped(jnp.asarray(w), group_size=8)
    np.testing.assert_array_equal(leaf["q4"].numpy(),
                                  np.asarray(jleaf["q4"]))


def test_gptq_serves_on_the_cpu_engine(tmp_path, monkeypatch):
    """A GPTQ directory through ``build_services(model_path=...)``, its
    geometry from config.json: the engine's greedy tokens equal the JAX
    engine's over the reference importer's tree."""
    import json

    from generativeaiexamples_tpu.engine import Engine as JEngine
    from generativeaiexamples_tpu.engine import EngineConfig as JEC
    from generativeaiexamples_tpu.engine import SamplingParams as JSP
    from generativeaiexamples_tpu.models.tokenizer import \
        ByteTokenizer as JTok
    from generativeaiexamples_tpu_torch.engine import (EngineConfig,
                                                       SamplingParams)
    from generativeaiexamples_tpu_torch.models.tokenizer import \
        ByteTokenizer
    from generativeaiexamples_tpu_torch.serving.model_server import \
        build_services
    monkeypatch.setenv("GAIE_WEIGHT_CACHE_DIR", str(tmp_path / "wc"))
    monkeypatch.setenv("SCHED_ONLINE_CALIB", "0")
    cfg = dataclasses.replace(TINY, vocab_size=300, head_dim=16,
                              hidden_size=64, num_heads=4, num_kv_heads=2,
                              intermediate_size=128)
    state, _ = gptq_state(cfg, 32)
    d = write_state(tmp_path / "ckpt", state, "safetensors")
    with open(tmp_path / "ckpt" / "config.json", "w") as f:
        json.dump({"vocab_size": 300, "hidden_size": 64,
                   "intermediate_size": 128, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "max_position_embeddings": 64}, f)
    kw = dict(max_slots=2, max_input_length=64, max_output_length=16,
              prefill_buckets=(32, 64), page_size=16, dtype="float32",
              kv_pool_tokens=None, sched_round_budget_tokens=128)
    engine, _ = build_services("llama-tiny", model_path=d, device="cpu",
                               tokenizer=ByteTokenizer(),
                               engine_cfg=EngineConfig(**kw))
    assert engine.model_cfg == cfg
    assert "gbias" in engine.params["layers"]["w_gate"]
    prompts = [[1, 7, 9, 11, 40], [1] + list(range(3, 40))]
    streams = [engine.submit(p, SamplingParams(max_tokens=8, top_k=1,
                                               ignore_eos=True))
               for p in prompts]
    with engine:
        got = [(s.text(), s.token_ids)[1] for s in streams]
    engine.close()
    jcfg = JConfig(**{**KW, **dict(vocab_size=300, head_dim=16,
                                   hidden_size=64, intermediate_size=128)})
    with JEngine(jload(d, jcfg, dtype=jnp.float32), jcfg, JTok(),
                 JEC(**kw)) as jeng:
        js = [jeng.submit(p, JSP(max_tokens=8, top_k=1, ignore_eos=True))
              for p in prompts]
        want = [(s.text(), s.token_ids)[1] for s in js]
    assert got == want
