"""Synthetic GPTQ, AWQ and NeMo checkpoints for the port's CPU tests, in
the wire formats the importers read (the reference's test builders:
``tests/test_import_quantized.py``): GPTQ int32-packed ``qweight``/
``qzeros`` with ``scales``; AMMO-AWQ weights with per-group
``weight_quantizer._amax`` and ``input_quantizer._pre_quant_scale``; a
``.nemo`` tar of ``model_config.yaml`` and a megatron-named
``model_weights.ckpt``."""

import io
import os
import tarfile

import numpy as np
import torch


def proj_shapes(cfg) -> dict:
    """HF projection -> (K, N) in the port's input-major orientation."""
    D, F, q, kv = (cfg.hidden_size, cfg.intermediate_size, cfg.q_dim,
                   cfg.kv_dim)
    return {"self_attn.q_proj": (D, q), "self_attn.k_proj": (D, kv),
            "self_attn.v_proj": (D, kv), "self_attn.o_proj": (q, D),
            "mlp.gate_proj": (D, F), "mlp.up_proj": (D, F),
            "mlp.down_proj": (F, D)}


def pack_int32(u4: np.ndarray, axis: int) -> np.ndarray:
    """uint4 values -> int32 packed along ``axis`` (value j at bits 4j)."""
    u = np.moveaxis(u4.astype(np.uint32), axis, 0)
    out = np.zeros((u.shape[0] // 8, *u.shape[1:]), np.uint32)
    for j in range(8):
        out |= u[j::8] << (4 * j)
    return np.moveaxis(out.view(np.int32), 0, axis)


def _dense(rng, cfg, state, golden):
    D, V = cfg.hidden_size, cfg.vocab_size
    for i in range(cfg.num_layers):
        for name in ("input_layernorm", "post_attention_layernorm"):
            w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
            state[f"model.layers.{i}.{name}.weight"] = torch.from_numpy(w)
    for key, shape in (("model.embed_tokens.weight", (V, D)),
                       ("lm_head.weight", (V, D))):
        state[key] = torch.from_numpy(
            (rng.standard_normal(shape) * D ** -0.5).astype(np.float32))
    state["model.norm.weight"] = torch.ones(D)
    return state, golden


def gptq_state(cfg, group: int, seed: int = 0, act_order: bool = False):
    """(state dict, {"i.proj": dequantized (K, N) float32}) of a GPTQ
    checkpoint: w = (u - 1 - uz) * s per group, u and uz random uint4."""
    rng = np.random.default_rng(seed)
    state, golden = {}, {}
    for i in range(cfg.num_layers):
        for proj, (K, N) in proj_shapes(cfg).items():
            G = K // group
            u = rng.integers(0, 16, size=(K, N), dtype=np.uint8)
            uz = rng.integers(0, 15, size=(G, N), dtype=np.uint8)
            s = rng.uniform(0.01, 0.2, size=(G, N)).astype(np.float32) \
                * K ** -0.5
            base = f"model.layers.{i}.{proj}"
            state[f"{base}.qweight"] = torch.from_numpy(pack_int32(u, 0))
            state[f"{base}.qzeros"] = torch.from_numpy(pack_int32(uz, 1))
            state[f"{base}.scales"] = torch.from_numpy(s).to(torch.float16)
            g_idx = np.arange(K, dtype=np.int32) // group
            if act_order:
                g_idx = rng.permutation(g_idx).astype(np.int32)
            state[f"{base}.g_idx"] = torch.from_numpy(g_idx)
            # The fp16 scales are what the importer reads.
            golden[f"{i}.{proj}"] = (
                u.astype(np.float32) - 1.0 - np.repeat(uz, group, 0)
            ) * np.repeat(s.astype(np.float16).astype(np.float32), group, 0)
    return _dense(rng, cfg, state, golden)


def awq_state(cfg, group: int, seed: int = 1):
    """(state dict, {"i.proj": (weight (out, in), pre_scale)}) of an
    AMMO-AWQ checkpoint."""
    rng = np.random.default_rng(seed)
    state, golden = {}, {}
    for i in range(cfg.num_layers):
        for proj, (K, N) in proj_shapes(cfg).items():
            w = (rng.standard_normal((N, K)) * K ** -0.5).astype(np.float32)
            G = K // group
            amax = np.abs(w).reshape(N, G, group).max(-1).astype(np.float32)
            pre = rng.uniform(0.5, 2.0, size=(K,)).astype(np.float32)
            base = f"model.layers.{i}.{proj}"
            state[f"{base}.weight"] = torch.from_numpy(w)
            state[f"{base}.weight_quantizer._amax"] = torch.from_numpy(amax)
            state[f"{base}.input_quantizer._pre_quant_scale"] = \
                torch.from_numpy(pre)
            golden[f"{i}.{proj}"] = (w, pre)
    return _dense(rng, cfg, state, golden)


def write_state(d, state, kind: str) -> str:
    """``state`` into directory ``d`` as one ``model.safetensors``
    ("safetensors") or ``model_quantized.pt`` ("pt")."""
    from generativeaiexamples_tpu_torch.models.safetensors import save_file
    os.makedirs(d, exist_ok=True)
    if kind == "safetensors":
        save_file({k: v.contiguous() for k, v in state.items()},
                  os.path.join(d, "model.safetensors"))
    else:
        torch.save(state, os.path.join(d, "model_quantized.pt"))
    return str(d)


def megatron_state(tree: dict, cfg) -> dict:
    """The port/reference numpy tree of ``cfg`` fused into megatron
    naming: per KV group [q x g, k, v] rows of query_key_value, [gate; up]
    (swiglu) or up alone (squared-ReLU) in dense_h_to_4h, (out, in)
    orientation, layernorm1p offsets as the norms' biases."""
    P = "model.language_model."
    hd, KV, D = cfg.head_dim, cfg.num_kv_heads, cfg.hidden_size
    g = cfg.num_heads // KV
    lay = tree["layers"]
    state = {}
    for i in range(cfg.num_layers):
        base = f"{P}encoder.layers.{i}."
        q = lay["wq"][i].T.reshape(KV, g * hd, D)
        k = lay["wk"][i].T.reshape(KV, hd, D)
        v = lay["wv"][i].T.reshape(KV, hd, D)
        fused = np.concatenate([np.concatenate([q[j], k[j], v[j]], 0)
                                for j in range(KV)], 0)
        state[base + "self_attention.query_key_value.weight"] = fused
        state[base + "self_attention.dense.weight"] = lay["wo"][i].T
        up = lay["w_up"][i].T
        state[base + "mlp.dense_h_to_4h.weight"] = (
            up if "w_gate" not in lay
            else np.concatenate([lay["w_gate"][i].T, up], 0))
        state[base + "mlp.dense_4h_to_h.weight"] = lay["w_down"][i].T
        state[base + "input_layernorm.weight"] = lay["attn_norm"][i]
        state[base + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        if "attn_norm_b" in lay:
            state[base + "input_layernorm.bias"] = lay["attn_norm_b"][i]
            state[base + "post_attention_layernorm.bias"] = \
                lay["mlp_norm_b"][i]
    state[P + "embedding.word_embeddings.weight"] = tree["embed"]
    state[P + "encoder.final_layernorm.weight"] = tree["final_norm"]
    if "final_norm_b" in tree:
        state[P + "encoder.final_layernorm.bias"] = tree["final_norm_b"]
    state[P + "output_layer.weight"] = tree["lm_head"].T
    return {k: torch.from_numpy(np.array(v, np.float32, copy=True))
            for k, v in state.items()}


def write_nemo(path: str, state: dict, config_yaml: str) -> str:
    """A ``.nemo`` tar at ``path``: ``model_config.yaml`` (the given text)
    and ``model_weights.ckpt``, written straight into the archive."""
    buf = io.BytesIO()
    torch.save(state, buf)
    with tarfile.open(path, "w") as tar:
        for name, blob in (("model_config.yaml", config_yaml.encode()),
                           ("model_weights.ckpt", buf.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return path


def nemo_yaml(cfg, **extra) -> str:
    """A model_config.yaml of ``cfg``'s geometry in NeMo's key names, with
    a nested block and a list (which a flat reader must skip)."""
    lines = [f"num_layers: {cfg.num_layers}",
             f"hidden_size: {cfg.hidden_size}",
             f"ffn_hidden_size: {cfg.intermediate_size}",
             f"num_attention_heads: {cfg.num_heads}",
             f"num_query_groups: {cfg.num_kv_heads}",
             f"max_position_embeddings: {cfg.max_position_embeddings}",
             f"normalization: {cfg.norm}",
             "activation: " + ("squared-relu" if cfg.mlp == "squared_relu"
                               else "fast-swiglu"),
             "bias: false  # no projection biases",
             "precision: bf16",
             "tokenizer:",
             "  library: sentencepiece",
             "  model: nemo:tokenizer.model",
             "optim:",
             "  name: fused_adam",
             "  betas:",
             "  - 0.9",
             "  - 0.98",
             "seq_len_interpolation_factor: null",
             "layernorm_epsilon: 1.0e-05"]
    lines += [f"{k}: {v}" for k, v in extra.items()]
    return "\n".join(lines) + "\n"
