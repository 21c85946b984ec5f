"""Carry a reference-layout parameter tree, given as numpy arrays, into the
port's parameters.

The tree is keyed exactly as the reference's ``llama.init_params`` keys it
(``embed``, ``layers/{attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up,
w_down}``, ``final_norm``, ``lm_head``; a Mixtral tree adds the router
``(L, D, E)`` and its expert stacks are 4-D, ``(L, E, D, F)`` and
``(L, E, F, D)``; a GPT-Next tree has no ``w_gate``
and adds the layernorm1p offsets ``*_norm_b``/``final_norm_b`` and, where
its config says, the biases ``bq``/``bk``/``bv``/``bo``/``b_up``/
``b_down``) and keeps its ``(D, out)`` weight orientation:
``models/llama.py`` computes ``x @ W`` on the same layout, so nothing is
transposed here. The same numpy parameters can therefore drive both
packages.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from ..parallel.mesh import Mesh
from ..parallel.sharding import llama_param_specs, shard_params
from ..utils.errors import ConfigError
from .configs import LlamaConfig
from .llama import bias_shapes, projection_keys, projection_shapes

# The llama-2 tree's layer leaves (the layout a tree is read as when no
# config is given).
_LAYER_KEYS = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate",
               "w_up", "w_down")
# Leaves that are never quantized.
_RAW_KEYS = ("embed", "final_norm", "final_norm_b", "attn_norm", "mlp_norm",
             "attn_norm_b", "mlp_norm_b", "bq", "bk", "bv", "bo", "b_up",
             "b_down", "router")


def layer_keys(cfg: Optional[LlamaConfig]) -> tuple[str, ...]:
    """The layer leaves of ``cfg``'s tree (llama-2's without a config)."""
    if cfg is None:
        return _LAYER_KEYS
    return (("attn_norm", "mlp_norm") + projection_keys(cfg)
            + tuple(k[len("layers/"):] for k in bias_shapes(cfg)
                    if k.startswith("layers/")))


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
    D, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    shapes = {
        "embed": (V, D), "final_norm": (D,),
        "layers/attn_norm": (L, D), "layers/mlp_norm": (L, D),
        **{f"layers/{k}": s for k, s in projection_shapes(cfg).items()},
        **bias_shapes(cfg),
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
        G = gs.shape[-2] if len(gs.shape) >= 2 else 0
        ok = ok and G > 0 and K % G == 0 and tuple(gs.shape) == lead + (G, N)
        if "gbias" in leaf:
            ok = ok and tuple(leaf["gbias"].shape) == tuple(gs.shape)
    if "pre_scale" in leaf:
        ok = ok and tuple(leaf["pre_scale"].shape) == lead + (K,)
    if not ok:
        shapes = {k: tuple(v.shape) for k, v in leaf.items()}
        raise ConfigError(f"{name}: quantized leaf {shapes} does not "
                          f"quantize a {shape} weight")


def params_from_numpy(tree: Mapping[str, Any],
                      device: Union[str, torch.device] = "cuda",
                      dtype: torch.dtype = torch.bfloat16,
                      cfg: Optional[LlamaConfig] = None,
                      mesh: Optional[Mesh] = None) -> dict[str, Any]:
    """numpy parameter tree -> the port's parameter dict on ``device``.

    Raw leaves are cast to ``dtype``. Quantized projection leaves (the
    reference's ``quantize_params`` output, or a GPTQ/AWQ import: int8
    ``q``/``q4`` and float32 ``scale``/``gscale``/``gbias``/``pre_scale``)
    keep their dtypes, bit for bit. The layout is ``cfg``'s family
    (llama-2's without a config): a key outside it (experts without an
    MoE config, or a bias the config does not have) is refused rather
    than dropped, and with ``cfg`` every shape is checked too.

    ``mesh`` (``cfg`` required): the result is this rank's shard of the
    tree (``parallel/sharding.py``), cut from the numpy arrays before
    anything goes to ``device``."""
    dev = torch.device(device)
    if mesh is not None and cfg is None:
        raise ConfigError("params_from_numpy under a mesh needs the config "
                          "(its sharding rules)")
    layers_in = tree.get("layers")
    if not isinstance(layers_in, Mapping):
        raise ConfigError("parameter tree has no 'layers' mapping")
    keys = layer_keys(cfg)
    top = {"embed", "layers", "final_norm", "lm_head"}
    if cfg is not None and cfg.norm == "layernorm1p":
        top.add("final_norm_b")
    extra = set(layers_in) - set(keys)
    missing = set(keys) - set(layers_in)
    top_extra = set(tree) - top
    if extra or missing or top_extra:
        raise ConfigError(
            f"parameter tree is not this config's layout: unexpected "
            f"{sorted(extra | top_extra)}, missing {sorted(missing)}")
    for name in _RAW_KEYS:
        leaf = tree[name] if name in tree else layers_in.get(name)
        if isinstance(leaf, Mapping):
            raise ConfigError(f"{name} cannot be a quantized leaf")
    if cfg is not None:
        flat = {k: v for k, v in tree.items() if k != "layers"}
        flat.update({f"layers/{k}": v for k, v in layers_in.items()})
        want = _expected_shapes(cfg)
        if set(flat) != set(want):
            raise ConfigError(f"parameter leaves {sorted(flat)} do not match "
                              f"the config's {sorted(want)}")
        for k, shape in want.items():
            _check_leaf(k, flat[k], shape)
    if mesh is not None:
        tree = shard_params(
            {k: (dict(v) if isinstance(v, Mapping) else v)
             for k, v in tree.items()}, mesh, llama_param_specs(cfg, mesh))
        layers_in = tree["layers"]
    out: dict[str, Any] = {
        "embed": _to_tensor(tree["embed"], dev, dtype),
        "layers": {k: _leaf(layers_in[k], dev, dtype) for k in keys},
        "final_norm": _to_tensor(tree["final_norm"], dev, dtype),
    }
    for name in ("final_norm_b", "lm_head"):
        if name in tree:
            out[name] = _leaf(tree[name], dev, dtype)
    return out
