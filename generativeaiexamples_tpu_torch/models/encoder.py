"""BERT-style bidirectional encoder (e5-large-v2 family) in PyTorch — port
of the reference package's ``models/encoder.py``.

Parameters are a plain dict keyed and shaped like the reference's tree,
layers stacked on a leading L (a Python loop walks them where the
reference scans), projections input-major (``x @ W``):

  embed: word (V,D), pos (P,D), type (T,D), ln_scale (D,), ln_bias (D,)
  layers: wq/wk/wv/wo (L,D,D), bq/bk/bv/bo (L,D),
    attn_ln_s/attn_ln_b (L,D),
    w_in (L,D,F), b_in (L,F), w_out (L,F,D), b_out (L,D),
    mlp_ln_s/mlp_ln_b (L,D)

The arithmetic is the reference's: LayerNorm in float32 (eps from the
config, 1e-12), attention scores in float32 with a ``-1e30`` key mask,
exact GELU, masked mean pooling and an L2 norm. The reference left the
encoder to XLA, not Pallas, so plain PyTorch calls are the port.
"""

from __future__ import annotations

import math
import re
from typing import Any, Iterator, Mapping, Union

import numpy as np
import torch

from ..utils.errors import ModelLoadError
from .configs import EncoderConfig
from .convert import _to_tensor

Params = dict[str, Any]


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _shapes(cfg: EncoderConfig) -> dict[str, dict[str, tuple[int, ...]]]:
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    layers = {k: (L, D, D) for k in ("wq", "wk", "wv", "wo")}
    layers.update({k: (L, D) for k in (
        "bq", "bk", "bv", "bo", "attn_ln_s", "attn_ln_b", "b_out",
        "mlp_ln_s", "mlp_ln_b")})
    layers.update(w_in=(L, D, F), b_in=(L, F), w_out=(L, F, D))
    return {"embed": {"word": (cfg.vocab_size, D),
                      "pos": (cfg.max_position_embeddings, D),
                      "type": (cfg.type_vocab_size, D),
                      "ln_scale": (D,), "ln_bias": (D,)},
            "layers": layers}


def init_params(cfg: EncoderConfig, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: Union[str, torch.device] = "cpu") -> Params:
    """Random weights made on ``device`` from ``seed``, scaled as the
    reference's ``init_params`` scales them (normal / sqrt(fan-in); unit
    LayerNorm scales, zero biases). The draws differ from JAX's: weights
    shared with the reference go through ``encoder_params_from_numpy``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    D, F = cfg.hidden_size, cfg.intermediate_size

    def norm(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dtype)

    out: Params = {"embed": {}, "layers": {}}
    for group, shapes in _shapes(cfg).items():
        for name, shape in shapes.items():
            if name in ("ln_scale", "attn_ln_s", "mlp_ln_s"):
                t = torch.ones(shape, dtype=dtype, device=device)
            elif name.startswith(("b", "ln_bias", "attn_ln_b", "mlp_ln_b")):
                t = torch.zeros(shape, dtype=dtype, device=device)
            else:
                t = norm(shape, F if name == "w_out" else D)
            out[group][name] = t
    return out


def apply(params: Params, cfg: EncoderConfig, tokens: torch.Tensor,
          attention_mask: torch.Tensor) -> torch.Tensor:
    """Forward pass → last hidden states (B, S, D).

    tokens: (B, S) integer ids, attention_mask: (B, S) {0,1}."""
    B, S = tokens.shape
    H = cfg.num_heads
    hd = cfg.hidden_size // H
    eps = cfg.layer_norm_eps

    e = params["embed"]
    h = e["word"][tokens.long()] + e["pos"][None, :S] + e["type"][0][None,
                                                                     None]
    h = _layernorm(h, e["ln_scale"], e["ln_bias"], eps)
    # (B, 1, 1, S) additive key mask in float32.
    bias = torch.zeros(attention_mask.shape, dtype=torch.float32,
                       device=h.device).masked_fill(
        attention_mask == 0, -1e30)[:, None, None, :]
    lp = params["layers"]
    for i in range(cfg.num_layers):
        q = (h @ lp["wq"][i] + lp["bq"][i]).view(B, S, H, hd)
        k = (h @ lp["wk"][i] + lp["bk"][i]).view(B, S, H, hd)
        v = (h @ lp["wv"][i] + lp["bv"][i]).view(B, S, H, hd)
        scores = torch.einsum("bshd,bthd->bhst", q.float(),
                              k.float()) / math.sqrt(hd)
        probs = torch.softmax(scores + bias, dim=-1).to(h.dtype)
        ctx = torch.einsum("bhst,bthd->bshd", probs, v).reshape(B, S, -1)
        h = _layernorm(h + (ctx @ lp["wo"][i] + lp["bo"][i]),
                       lp["attn_ln_s"][i], lp["attn_ln_b"][i], eps)
        ffn = torch.nn.functional.gelu(h @ lp["w_in"][i] + lp["b_in"][i],
                                       approximate="none")
        h = _layernorm(h + (ffn @ lp["w_out"][i] + lp["b_out"][i]),
                       lp["mlp_ln_s"][i], lp["mlp_ln_b"][i], eps)
    return h


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor,
              normalize: bool = True) -> torch.Tensor:
    """Masked mean pooling + optional L2 norm — the e5 recipe (float32)."""
    maskf = attention_mask.float()[..., None]
    summed = (hidden.float() * maskf).sum(dim=1)
    pooled = summed / maskf.sum(dim=1).clamp_min(1e-9)
    if normalize:
        pooled = pooled / torch.linalg.vector_norm(pooled, dim=-1,
                                                   keepdim=True)
    return pooled


def encoder_params_from_numpy(tree: Mapping[str, Any], cfg: EncoderConfig,
                              device: Union[str, torch.device] = "cpu",
                              dtype: torch.dtype = torch.float32) -> Params:
    """Carry a reference-layout encoder tree of numpy arrays (or anything
    ``np.array`` takes) into the port's parameters on ``device`` in
    ``dtype``; every leaf is checked against ``cfg``'s geometry."""
    dev = torch.device(device)
    out: Params = {}
    for group, shapes in _shapes(cfg).items():
        src = tree.get(group)
        if src is None or set(src) != set(shapes):
            raise ModelLoadError(
                f"encoder tree group {group!r} holds "
                f"{sorted(src or ())}; expected {sorted(shapes)}")
        out[group] = {}
        for name, shape in shapes.items():
            leaf = src[name]
            t = (leaf.to(device=dev, dtype=dtype, copy=True).contiguous()
                 if isinstance(leaf, torch.Tensor)
                 else _to_tensor(leaf, dev, dtype))
            if tuple(t.shape) != shape:
                raise ModelLoadError(f"encoder {group}/{name}: shape "
                                     f"{tuple(t.shape)}, expected {shape}")
            out[group][name] = t
    return out


# --------------------------------------------------------------- HF import

_EMBED_KEYS = {
    "embeddings.word_embeddings.weight": "word",
    "embeddings.position_embeddings.weight": "pos",
    "embeddings.token_type_embeddings.weight": "type",
    "embeddings.LayerNorm.weight": "ln_scale",
    "embeddings.LayerNorm.bias": "ln_bias",
}

_LAYER_KEYS = {
    "attention.self.query.weight": ("wq", True),
    "attention.self.query.bias": ("bq", False),
    "attention.self.key.weight": ("wk", True),
    "attention.self.key.bias": ("bk", False),
    "attention.self.value.weight": ("wv", True),
    "attention.self.value.bias": ("bv", False),
    "attention.output.dense.weight": ("wo", True),
    "attention.output.dense.bias": ("bo", False),
    "attention.output.LayerNorm.weight": ("attn_ln_s", False),
    "attention.output.LayerNorm.bias": ("attn_ln_b", False),
    "intermediate.dense.weight": ("w_in", True),
    "intermediate.dense.bias": ("b_in", False),
    "output.dense.weight": ("w_out", True),
    "output.dense.bias": ("b_out", False),
    "output.LayerNorm.weight": ("mlp_ln_s", False),
    "output.LayerNorm.bias": ("mlp_ln_b", False),
}


def params_from_named_tensors(tensors: Iterator[tuple[str, Any]],
                              cfg: EncoderConfig,
                              dtype: torch.dtype = torch.float32,
                              device: Union[str, torch.device] = "cpu",
                              ) -> Params:
    """HF BertModel-named tensors (names with or without the ``bert.``
    prefix; torch tensors, e.g. from ``models/safetensors.py``, or numpy
    arrays) → the param tree on ``device``. Linear weights are stored
    (out, in) by HF and transposed here to the input-major layout."""
    L = cfg.num_layers
    embed: dict[str, Any] = {}
    layer_acc: dict[str, list] = {}
    for key, raw in tensors:
        key = key.removeprefix("bert.")
        if key in _EMBED_KEYS:
            embed[_EMBED_KEYS[key]] = raw
            continue
        m = re.match(r"encoder\.layer\.(\d+)\.(.+)$", key)
        if m and m.group(2) in _LAYER_KEYS:
            i = int(m.group(1))
            if i >= L:
                raise ModelLoadError(f"{key}: layer {i} beyond the "
                                     f"config's {L} layers")
            name, transpose = _LAYER_KEYS[m.group(2)]
            t = (raw if isinstance(raw, torch.Tensor)
                 else torch.from_numpy(np.array(raw)))
            layer_acc.setdefault(name, [None] * L)[i] = (
                t.t() if transpose else t)
    if (len(embed) != 5 or len(layer_acc) != len(_LAYER_KEYS)
            or any(x is None for v in layer_acc.values() for x in v)):
        raise ModelLoadError("incomplete encoder checkpoint")
    tree = {"embed": embed,
            "layers": {k: torch.stack(v) for k, v in layer_acc.items()}}
    return encoder_params_from_numpy(tree, cfg, device=device, dtype=dtype)
