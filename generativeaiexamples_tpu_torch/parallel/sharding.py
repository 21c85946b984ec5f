"""Sharding rules for the parameter tree (megatron-style tensor
parallelism) — port of the reference's ``parallel/sharding.py``.

A spec is a tuple with one entry per tensor axis: the mesh axis that
splits it, or None (the reference's ``PartitionSpec``, whose entries it
equals). The rules are the reference's:

  wq/wk/wv  (L, D, heads*hd)  column-parallel: the output dim over tp
  wo        (L, heads*hd, D)  row-parallel: the input dim over tp
  w_gate/up (L, D, F)         column-parallel
  w_down    (L, F, D)         row-parallel
  embed     (V, D)            V over tp (vocab-parallel)
  lm_head   (D, V)            V over tp
  MoE experts (L, E, ...)     E over ep, then tp on the inner dims
  (dp and sp replicate every leaf)

The reference hands the annotated tree to ``jax.device_put`` and GSPMD
places it; in the port every rank holds its own slice
(``shard_params``) and the model adds the all-reduce after each
row-parallel product itself (``models/llama.py``). KV projections shard
over tp only when the kv heads divide it; otherwise wk/wv stay
replicated (``kv_tp`` None), as in the reference.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from ..models.configs import LlamaConfig
from ..ops.quant import is_quantized
from ..utils.errors import ShardingError
from .mesh import Mesh

Spec = tuple
Specs = dict[str, Any]


def _axis_on(mesh: Mesh, name: str) -> Optional[str]:
    """Axis name if it exists in the mesh with size > 1, else None."""
    return name if mesh.shape.get(name, 1) > 1 else None


def _kv_tp(cfg: LlamaConfig, mesh: Mesh) -> Optional[str]:
    tp = _axis_on(mesh, "tp")
    return tp if tp and cfg.num_kv_heads % mesh.shape["tp"] == 0 else None


def llama_param_specs(cfg: LlamaConfig, mesh: Mesh) -> Specs:
    """The spec of every leaf of ``cfg``'s tree on ``mesh``; experts that
    do not split over ep are a ``ShardingError`` here, before any leaf is
    made or read."""
    tp = _axis_on(mesh, "tp")
    pp = _axis_on(mesh, "pp")
    ep = _axis_on(mesh, "ep")
    if ep and cfg.num_experts and cfg.num_experts % mesh.shape["ep"]:
        raise ShardingError(f"num_experts={cfg.num_experts} does not split "
                            f"over ep={mesh.shape['ep']}")
    kv_tp = _kv_tp(cfg, mesh)
    q_tp = tp if tp and cfg.num_heads % mesh.shape["tp"] == 0 else None

    layers: Specs = {
        "attn_norm": (pp, None),
        "mlp_norm": (pp, None),
        "wq": (pp, None, q_tp),
        "wk": (pp, None, kv_tp),
        "wv": (pp, None, kv_tp),
        "wo": (pp, q_tp, None),
    }
    # GPT-Next/Nemotron: norm offsets replicated; projection biases shard
    # like their projection's output dim, bo replicated (added once,
    # after the all-reduce).
    if cfg.norm == "layernorm1p":
        layers["attn_norm_b"] = (pp, None)
        layers["mlp_norm_b"] = (pp, None)
    if cfg.attn_bias:
        layers.update({"bq": (pp, q_tp), "bk": (pp, kv_tp),
                       "bv": (pp, kv_tp), "bo": (pp, None)})
    if cfg.num_experts:
        layers.update({
            "router": (pp, None, None),
            "w_gate": (pp, ep, None, tp),
            "w_up": (pp, ep, None, tp),
            "w_down": (pp, ep, tp, None),
        })
    elif cfg.mlp == "squared_relu":
        layers.update({"w_up": (pp, None, tp), "w_down": (pp, tp, None)})
        if cfg.mlp_bias:
            layers.update({"b_up": (pp, tp), "b_down": (pp, None)})
    else:
        layers.update({
            "w_gate": (pp, None, tp),
            "w_up": (pp, None, tp),
            "w_down": (pp, tp, None),
        })
    specs: Specs = {
        "embed": (tp, None),
        "layers": layers,
        "final_norm": (None,),
    }
    if cfg.norm == "layernorm1p":
        specs["final_norm_b"] = (None,)
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, tp)
    return specs


def quantized_leaf_specs(leaf: dict, spec: Spec) -> Specs:
    """The spec of each part of a quantized leaf whose weight has
    ``spec`` (the reference's rule): ``q``/``q4`` take it; ``gscale`` and
    ``gbias`` (..., G, N) too, the group axis standing where K stood;
    ``pre_scale`` (..., K) drops the output axis; a per-channel
    ``scale`` (..., N) drops the reduction axis (replicated for a
    row-parallel weight)."""
    w = tuple(spec)
    out = {}
    for k in leaf:
        if k in ("q", "q4", "gscale", "gbias"):
            out[k] = w
        elif k == "pre_scale":
            out[k] = w[:-1]
        else:
            out[k] = w[:-2] + w[-1:] if len(w) >= 2 else ()
    return out


Array = Union[torch.Tensor, np.ndarray]


def shard_slices(shape: tuple, spec: Spec, mesh: Mesh) -> tuple:
    """The index of this rank's block of an array of ``shape`` under
    ``spec``; raises ``ShardingError`` where an axis does not divide."""
    coords = mesh.coords
    idx = []
    for dim, axis in enumerate(tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        n = mesh.shape[axis] if axis is not None else 1
        if n == 1:
            idx.append(slice(None))
            continue
        if shape[dim] % n:
            raise ShardingError(
                f"axis {dim} of a {tuple(shape)} leaf does not split over "
                f"{axis}={n}")
        step = shape[dim] // n
        idx.append(slice(coords[axis] * step, (coords[axis] + 1) * step))
    return tuple(idx)


def shard_shape(shape: tuple, spec: Spec, mesh: Optional[Mesh]) -> tuple:
    """The shape of this rank's block of an array of ``shape`` under
    ``spec`` (``shape`` itself without a mesh)."""
    if mesh is None:
        return tuple(shape)
    return tuple(len(range(*s.indices(n))) for s, n in
                 zip(shard_slices(tuple(shape), spec, mesh), shape))


def block_index(shape: tuple, spec: Spec, mesh: Optional[Mesh]) -> tuple:
    """``shard_slices``, or the whole array without a mesh."""
    if mesh is None:
        return (slice(None),) * len(shape)
    return shard_slices(tuple(shape), spec, mesh)


def shard_array(x: Array, spec: Spec, mesh: Mesh) -> Array:
    """This rank's block of ``x`` under ``spec``: ``x`` itself when
    nothing splits it, else a contiguous copy (a view would keep the
    whole leaf alive)."""
    idx = shard_slices(tuple(x.shape), spec, mesh)
    if all(s == slice(None) for s in idx):
        return x
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x[idx])
    return x[idx].clone(memory_format=torch.contiguous_format)


def shard_params(params: Any, mesh: Mesh, specs: Any) -> Any:
    """This rank's slice of a parameter tree (the reference's
    ``shard_params`` places the whole tree on the mesh; each rank here
    keeps its own block of every leaf). Leaves are torch tensors or numpy
    arrays; quantized dict leaves split by ``quantized_leaf_specs``."""
    def walk(p: Any, s: Any) -> Any:
        if isinstance(p, dict):
            if is_quantized(p):
                sub = quantized_leaf_specs(p, s)
                return {k: shard_array(v, sub[k], mesh)
                        for k, v in p.items()}
            return {k: walk(v, s[k]) for k, v in p.items()}
        return shard_array(p, s, mesh)

    return walk(params, specs)
