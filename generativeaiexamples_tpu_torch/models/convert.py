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


_QUANT_KEYS = {"q", "q4", "scale", "gscale", "gbias", "pre_scale"}


def _leaf(a: Any, device: torch.device, dtype: torch.dtype) -> Any:
    """A raw leaf cast to ``dtype``, or a quantized dict leaf
    (``ops/quant.py``) with its int8 ``q``/``q4`` and float32 scales kept
    as they are."""
    if not isinstance(a, Mapping):
        return _to_tensor(a, device, dtype)
    keys = set(a)
    if (keys - _QUANT_KEYS or len(keys & {"q", "q4"}) != 1
            or len(keys & {"scale", "gscale"}) != 1):
        raise ConfigError(f"unknown quantized leaf layout {sorted(keys)}")
    return {k: _to_tensor(v, device, torch.int8 if k in ("q", "q4")
                          else torch.float32) for k, v in a.items()}


def _check_leaf(name: str, leaf: Any, shape: tuple[int, ...]) -> None:
    """``leaf`` is a raw ``shape`` tensor or a quantized leaf of it."""
    if not isinstance(leaf, dict):
        if tuple(leaf.shape) != shape:
            raise ConfigError(f"{name}: shape {tuple(leaf.shape)} != "
                              f"{shape} for this config")
        return
    *lead, K, N = shape
    lead = tuple(lead)
    q = leaf.get("q", leaf.get("q4"))
    want_q = lead + ((K, N) if "q" in leaf else (K // 2, N))
    ok = tuple(q.shape) == want_q and ("q" in leaf or K % 2 == 0)
    if "scale" in leaf:
        ok = ok and tuple(leaf["scale"].shape) == lead + (N,)
    else:
        gs = leaf["gscale"]
        G = gs.shape[-2] if gs.dim() >= 2 else 0
        ok = ok and G > 0 and K % G == 0 and tuple(gs.shape) == lead + (G, N)
        if "gbias" in leaf:
            ok = ok and leaf["gbias"].shape == gs.shape
    if "pre_scale" in leaf:
        ok = ok and tuple(leaf["pre_scale"].shape) == lead + (K,)
    if not ok:
        shapes = {k: tuple(v.shape) for k, v in leaf.items()}
        raise ConfigError(f"{name}: quantized leaf {shapes} does not "
                          f"quantize a {shape} weight")


def params_from_numpy(tree: Mapping[str, Any],
                      device: Union[str, torch.device] = "cuda",
                      dtype: torch.dtype = torch.bfloat16,
                      cfg: Optional[LlamaConfig] = None) -> dict[str, Any]:
    """numpy parameter tree -> the port's parameter dict on ``device``.

    Raw leaves are cast to ``dtype``. Quantized projection leaves (the
    reference's ``quantize_params`` output: int8 ``q``/``q4`` and float32
    ``scale``/``gscale``/``gbias``/``pre_scale``) keep their dtypes, bit
    for bit. Keys outside the llama-2 family (biases, experts, layernorm
    offsets) are refused rather than dropped. With ``cfg`` every shape is
    checked too."""
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
    for name in ("embed", "final_norm", "attn_norm", "mlp_norm"):
        leaf = tree[name] if name in tree else layers_in[name]
        if isinstance(leaf, Mapping):
            raise ConfigError(f"{name} cannot be a quantized leaf")
    out: dict[str, Any] = {
        "embed": _to_tensor(tree["embed"], dev, dtype),
        "layers": {k: _leaf(layers_in[k], dev, dtype) for k in _LAYER_KEYS},
        "final_norm": _to_tensor(tree["final_norm"], dev, dtype),
    }
    if "lm_head" in tree:
        out["lm_head"] = _leaf(tree["lm_head"], dev, dtype)
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
            _check_leaf(k, flat[k], shape)
    return out
