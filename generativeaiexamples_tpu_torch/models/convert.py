"""Carry a reference-layout parameter tree, given as numpy arrays, into the
port's parameters.

The tree is keyed exactly as the reference's ``llama.init_params`` keys it
(``embed``, ``layers/{attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up,
w_down}``, ``final_norm``, ``lm_head``) and keeps its ``(D, out)`` weight
orientation: ``models/llama.py`` computes ``x @ W`` on the same layout, so
nothing is transposed here. The same numpy parameters can therefore drive
both packages.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from ..utils.errors import ConfigError
from .configs import LlamaConfig

_LAYER_KEYS = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate",
               "w_up", "w_down")


def _to_tensor(a: Any, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    # A writable copy: jax hands out read-only views, and the tensor must
    # not alias the caller's array.
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16 (jax hands out ml_dtypes'): carry
        # the raw 16-bit words and reinterpret them on the torch side.
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype).contiguous()


def _expected_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    """Shape of every leaf for ``cfg`` (layer leaves under ``layers/``)."""
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    q, kv, V = cfg.q_dim, cfg.kv_dim, cfg.vocab_size
    shapes = {
        "embed": (V, D), "final_norm": (D,),
        "layers/attn_norm": (L, D), "layers/mlp_norm": (L, D),
        "layers/wq": (L, D, q), "layers/wk": (L, D, kv),
        "layers/wv": (L, D, kv), "layers/wo": (L, q, D),
        "layers/w_gate": (L, D, F), "layers/w_up": (L, D, F),
        "layers/w_down": (L, F, D),
    }
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def params_from_numpy(tree: Mapping[str, Any],
                      device: Union[str, torch.device] = "cuda",
                      dtype: torch.dtype = torch.bfloat16,
                      cfg: Optional[LlamaConfig] = None) -> dict[str, Any]:
    """numpy parameter tree -> the port's parameter dict on ``device``.

    Every leaf is cast to ``dtype``. Keys outside the llama-2 family
    (biases, experts, layernorm offsets, quantized leaves) are refused
    rather than dropped. With ``cfg`` every shape is checked too."""
    dev = torch.device(device)
    layers_in = tree.get("layers")
    if not isinstance(layers_in, Mapping):
        raise ConfigError("parameter tree has no 'layers' mapping")
    extra = set(layers_in) - set(_LAYER_KEYS)
    missing = set(_LAYER_KEYS) - set(layers_in)
    top_extra = set(tree) - {"embed", "layers", "final_norm", "lm_head"}
    if extra or missing or top_extra:
        raise ConfigError(
            f"parameter tree is not a llama-2 layout: unexpected "
            f"{sorted(extra | top_extra)}, missing {sorted(missing)}")
    out: dict[str, Any] = {
        "embed": _to_tensor(tree["embed"], dev, dtype),
        "layers": {k: _to_tensor(layers_in[k], dev, dtype)
                   for k in _LAYER_KEYS},
        "final_norm": _to_tensor(tree["final_norm"], dev, dtype),
    }
    if "lm_head" in tree:
        out["lm_head"] = _to_tensor(tree["lm_head"], dev, dtype)
    if cfg is not None:
        flat = {"embed": out["embed"], "final_norm": out["final_norm"],
                **{f"layers/{k}": v for k, v in out["layers"].items()}}
        if "lm_head" in out:
            flat["lm_head"] = out["lm_head"]
        want = _expected_shapes(cfg)
        if set(flat) != set(want):
            raise ConfigError(f"parameter leaves {sorted(flat)} do not match "
                              f"the config's {sorted(want)}")
        for k, shape in want.items():
            if tuple(flat[k].shape) != shape:
                raise ConfigError(f"{k}: shape {tuple(flat[k].shape)} != "
                                  f"{shape} for this config")
    return out
