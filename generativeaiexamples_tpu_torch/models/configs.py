"""Model architecture configs and the named-model registry.

A copy of the reference package's ``models/configs.py`` decoder configs
(the port imports nothing from that package). The geometry is the same
data; only the llama/swiglu/rmsnorm family is served by this slice
(``models/llama.py`` rejects the others). ``EncoderConfig`` and
``ENCODER_REGISTRY`` are the reference's encoder geometries (e5-large-v2
and the tiny test encoder), served by ``models/encoder.py``."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class LlamaConfig:
    """Decoder-only transformer (Llama-2 family geometry)."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rope_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    # MoE (Mixtral): 0 experts = dense MLP.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_impl: str = "sparse"
    moe_capacity_factor: float = 2.0
    # GPT-Next/Nemotron knobs: norm "rmsnorm" | "layernorm1p",
    # mlp "swiglu" | "squared_relu".
    norm: str = "rmsnorm"
    mlp: str = "swiglu"
    attn_bias: bool = False
    mlp_bias: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


LLAMA2_7B = LlamaConfig()
LLAMA2_13B = LlamaConfig(hidden_size=5120, intermediate_size=13824,
                         num_layers=40, num_heads=40, num_kv_heads=40)
LLAMA2_70B = LlamaConfig(hidden_size=8192, intermediate_size=28672,
                         num_layers=80, num_heads=64, num_kv_heads=8)
CODELLAMA_13B = replace(LLAMA2_13B, vocab_size=32016, rope_theta=1_000_000.0,
                        max_position_embeddings=16384)
MIXTRAL_8X7B = LlamaConfig(hidden_size=4096, intermediate_size=14336,
                           num_layers=32, num_heads=32, num_kv_heads=8,
                           rope_theta=1_000_000.0,
                           max_position_embeddings=32768,
                           num_experts=8, num_experts_per_tok=2)
NEMOTRON_8B = LlamaConfig(vocab_size=256000, hidden_size=4096,
                          intermediate_size=16384, num_layers=32,
                          num_heads=32, num_kv_heads=32, head_dim=128,
                          max_position_embeddings=4096,
                          norm="layernorm1p", mlp="squared_relu",
                          attn_bias=False, mlp_bias=False)
GPTNEXT_TINY = LlamaConfig(vocab_size=512, hidden_size=128,
                           intermediate_size=256, num_layers=2,
                           num_heads=4, num_kv_heads=4, head_dim=32,
                           max_position_embeddings=512,
                           norm="layernorm1p", mlp="squared_relu")
LLAMA_TINY = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=352,
                         num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                         max_position_embeddings=512)
GOLDEN_TINY = LlamaConfig(vocab_size=32000, hidden_size=64,
                          intermediate_size=176, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=16,
                          max_position_embeddings=512,
                          tie_word_embeddings=False)
LLAMA_1B = LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5632, num_layers=22,
                       num_heads=32, num_kv_heads=4, head_dim=64)


@dataclass(frozen=True)
class EncoderConfig:
    """BERT-style bidirectional encoder (e5-large-v2 geometry)."""
    vocab_size: int = 30522
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


E5_LARGE_V2 = EncoderConfig()
ENCODER_TINY = EncoderConfig(vocab_size=512, hidden_size=64,
                             intermediate_size=128, num_layers=2, num_heads=4,
                             max_position_embeddings=128)

MODEL_REGISTRY: dict[str, LlamaConfig] = {
    "llama-2-7b-chat": LLAMA2_7B,
    "llama-2-13b-chat": LLAMA2_13B,
    "llama-2-70b-chat": LLAMA2_70B,
    "codellama-13b-instruct": CODELLAMA_13B,
    "mixtral-8x7b-instruct": MIXTRAL_8X7B,
    "nemotron-8b-chat": NEMOTRON_8B,
    "gptnext-tiny": GPTNEXT_TINY,
    "llama-tiny": LLAMA_TINY,
    "golden-tiny": GOLDEN_TINY,
    "llama-1b": LLAMA_1B,
}

ENCODER_REGISTRY: dict[str, EncoderConfig] = {
    "intfloat/e5-large-v2": E5_LARGE_V2,
    "e5-large-v2": E5_LARGE_V2,
    "encoder-tiny": ENCODER_TINY,
}


def get_model_config(name: str) -> LlamaConfig:
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}") from None


# HF ``config.json`` fields -> LlamaConfig fields.
_HF_FIELDS = {
    "vocab_size": "vocab_size", "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "num_hidden_layers": "num_layers", "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
    "max_position_embeddings": "max_position_embeddings",
    "rope_theta": "rope_theta", "rms_norm_eps": "rms_norm_eps",
    "tie_word_embeddings": "tie_word_embeddings",
    "num_local_experts": "num_experts",
    "num_experts_per_tok": "num_experts_per_tok",
}


def config_for_checkpoint(path: str, base: LlamaConfig) -> LlamaConfig:
    """``base`` with the geometry a checkpoint directory's HF
    ``config.json`` states, where it has one (a depth-cut or renamed
    checkpoint then loads under its own geometry); ``base`` unchanged
    otherwise. A config.json without ``head_dim`` implies
    hidden_size / num_attention_heads, and one without
    ``num_key_value_heads`` implies as many KV heads as heads."""
    cfg_file = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_file):
        return base
    with open(cfg_file) as f:
        hf = json.load(f)
    kw = {ours: hf[theirs] for theirs, ours in _HF_FIELDS.items()
          if hf.get(theirs) is not None}
    if "head_dim" not in kw and "hidden_size" in kw and "num_heads" in kw:
        kw["head_dim"] = kw["hidden_size"] // kw["num_heads"]
    if "num_kv_heads" not in kw and "num_heads" in kw:
        kw["num_kv_heads"] = kw["num_heads"]
    scaling = hf.get("rope_scaling") or {}
    if scaling.get("type", scaling.get("rope_type")) == "linear":
        kw["rope_scaling_factor"] = float(scaling["factor"])
    return replace(base, **kw)
