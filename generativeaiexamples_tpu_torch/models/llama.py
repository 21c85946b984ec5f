"""Llama-family decoder in PyTorch — port of the reference's
``models/llama.py``: llama-2 (rmsnorm, swiglu, no biases), Mixtral (its
MLP a sparse mixture of swiglu experts, ``parallel/moe.py``) and
GPT-Next/Nemotron (layernorm1p, squared-ReLU MLP without a gate,
optional biases).

Parameters are a plain dict of tensors keyed and shaped exactly like the
reference's parameter tree, so weights carry across without transposes
(``models/convert.py``). Every projection is stored input-major and the
forward is ``x @ W``:

  embed:       (V, D)
  layers:
    attn_norm: (L, D)         mlp_norm: (L, D)
    wq: (L, D, H*hd)  wk: (L, D, KV*hd)  wv: (L, D, KV*hd)  wo: (L, H*hd, D)
    w_gate/w_up: (L, D, F)    w_down: (L, F, D)   (no w_gate: squared_relu)
    router: (L, D, E)  w_gate/w_up: (L, E, D, F)  w_down: (L, E, F, D)
                                                   [num_experts: E experts]
    attn_norm_b/mlp_norm_b: (L, D)                 [layernorm1p]
    bq: (L, H*hd)  bk/bv: (L, KV*hd)  bo: (L, D)   [attn_bias]
    b_up: (L, F)   b_down: (L, D)                  [mlp_bias]
  final_norm:  (D,)            final_norm_b: (D,)  [layernorm1p]
  lm_head:     (D, V)          (absent when embeddings are tied)

After ``ops.quant.quantize_params`` each projection and ``lm_head`` is a
dict leaf of the same stacked shape (``ops/quant.py``), and every
``x @ W`` goes through ``ops.quant.matmul``; the router and the 4-D
expert stacks stay raw, as in the reference.

The reference scans over stacked layers; here a Python loop walks them
(``layer_params``), and KV caches and the paged pool are updated in place
where the reference threaded them through its scan carry.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Iterator, Optional, Union

import torch

from ..ops.attention import gqa_attention
from ..ops.kv_quant import SCALE_DTYPE, dequantize_rows, quantize_rows
from ..ops.paged_attention import paged_attention_decode
from ..ops.quant import matmul as qmm
from ..ops.quant import matmul_f32 as qmm_f32
from ..ops.quant import MODES as QUANT_MODES
from ..ops.quant import quantizable, quantize_leaf
from ..ops.rmsnorm import layernorm1p, rmsnorm
from ..ops.rope import apply_rope, rope_frequencies
from ..parallel.comm import all_gather, all_reduce_, sharded
from ..parallel.mesh import Mesh
from ..parallel.moe import sparse_moe_ffn, topk_lowest_index_first
from ..parallel.sharding import (llama_param_specs, quantized_leaf_specs,
                                 shard_array)
from ..utils.errors import ConfigError, ShardingError
from .configs import LlamaConfig

Params = dict[str, Any]
KVCache = dict[str, torch.Tensor]  # {"k", "v"[, "ks", "vs"]}


NORMS = ("rmsnorm", "layernorm1p")
MLPS = ("swiglu", "squared_relu")
MOE_IMPLS = ("sparse", "dense")


def check_supported(cfg: LlamaConfig) -> None:
    """The port serves the reference's families: llama-2, Mixtral (its
    ``moe_impl`` "sparse", the default, or "dense", the zero-gated
    all-experts oracle) and GPT-Next."""
    if cfg.norm not in NORMS or cfg.mlp not in MLPS:
        raise ConfigError(f"unknown norm {cfg.norm!r} or mlp {cfg.mlp!r}; "
                          f"known: {NORMS}, {MLPS}")
    if cfg.num_experts and cfg.moe_impl not in MOE_IMPLS:
        raise ConfigError(f"unknown moe_impl {cfg.moe_impl!r}; expected "
                          f"'sparse' or 'dense'")


def projection_keys(cfg: LlamaConfig) -> tuple[str, ...]:
    """The layer's weight matrices, in forward order: six without a gate
    (squared_relu), seven with one; an MoE layer's router and its three
    expert stacks (``(E, D, F)`` a layer) after the attention's four."""
    return tuple(projection_shapes(cfg))


def projection_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    """The stacked shape of every layer weight matrix, in forward
    order."""
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    shapes = {"wq": (L, D, cfg.q_dim), "wk": (L, D, cfg.kv_dim),
              "wv": (L, D, cfg.kv_dim), "wo": (L, cfg.q_dim, D)}
    if cfg.num_experts:
        E = cfg.num_experts
        shapes.update({"router": (L, D, E), "w_gate": (L, E, D, F),
                       "w_up": (L, E, D, F), "w_down": (L, E, F, D)})
        return shapes
    if cfg.mlp != "squared_relu":
        shapes["w_gate"] = (L, D, F)
    shapes.update({"w_up": (L, D, F), "w_down": (L, F, D)})
    return shapes


def bias_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, ...]]:
    """Every bias and norm-offset leaf ``cfg`` adds (layer leaves keyed
    ``layers/...``), with its shape."""
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    out: dict[str, tuple[int, ...]] = {}
    if cfg.norm == "layernorm1p":
        out.update({"layers/attn_norm_b": (L, D),
                    "layers/mlp_norm_b": (L, D), "final_norm_b": (D,)})
    if cfg.attn_bias:
        out.update({"layers/bq": (L, cfg.q_dim), "layers/bk": (L, cfg.kv_dim),
                    "layers/bv": (L, cfg.kv_dim), "layers/bo": (L, D)})
    if cfg.mlp_bias and cfg.mlp == "squared_relu" and not cfg.num_experts:
        out.update({"layers/b_up": (L, F), "layers/b_down": (L, D)})
    return out


def init_params(cfg: LlamaConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: Union[str, torch.device] = "cpu", *,
                mesh: Optional[Mesh] = None, quantization: str = "",
                group_size: int = 128) -> Params:
    """Random-init parameter tree, made on ``device`` from ``seed`` (for
    tests and benchmarks; normal(0, 1/sqrt(fan_in)) like the reference,
    though the two frameworks' random streams differ). Leaves are drawn in
    float32 slabs of at most 64 Mi elements along their leading axis (one
    layer at a time where a layer is larger: Mixtral's ``w_gate`` is
    1.88 GB of float32 a layer), so the float32 transient stays small
    beside the weights.

    ``quantization`` (an ``ops.quant`` mode; ``group_size`` for
    int4_awq) quantizes each projection and the head as
    ``ops.quant.quantize_params`` would, slab by slab (a slab of the
    stacked leaves is whole layers). Under ``mesh`` every rank draws every
    full leaf, slab by slab, from the same seed and keeps only its block
    (``parallel/sharding.py``), quantized before it is split (a
    per-channel scale over K/tp rows of a row-parallel weight would not
    be the whole weight's): a sharded tree is the unsharded tree of the
    same seed, split, and no rank ever holds a whole stacked leaf."""
    check_supported(cfg)
    if quantization and quantization not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {quantization!r}")
    if mesh is not None and mesh.shape.get("pp", 1) > 1:
        raise ShardingError("init_params splits leaves across ranks over "
                            "tp/ep only: pp would split the layer stack")
    gen = torch.Generator(device=device).manual_seed(seed)
    D, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    specs = llama_param_specs(cfg, mesh) if mesh is not None else None

    def split(w, spec):
        if spec is None:
            return w
        if isinstance(w, dict):
            sub = quantized_leaf_specs(w, spec)
            return {k: shard_array(v, sub[k], mesh) for k, v in w.items()}
        return shard_array(w, spec, mesh)

    def quantize(w):
        return quantize_leaf(w, quantization, group_size) if quantization \
            else w

    def slabs(shape, fan_in):
        row = 1
        for n in shape[1:]:
            row *= n
        step = max(1, (64 << 20) // row)
        for i in range(0, shape[0], step):
            n = min(step, shape[0] - i)
            yield (torch.randn((n, *shape[1:]), generator=gen, device=device,
                               dtype=torch.float32)
                   * fan_in ** -0.5).to(dtype)

    def whole(shape, fan_in, spec=None, quant=False):
        """A leaf assembled whole (the embedding, the head), then
        quantized and split."""
        out = torch.empty(shape, dtype=dtype, device=device)
        at = 0
        for slab in slabs(shape, fan_in):
            out[at:at + slab.shape[0]] = slab
            at += slab.shape[0]
        return split(quantize(out) if quant else out, spec)

    def stacked(shape, fan_in, spec=None, quant=False):
        """A stacked layer leaf, slab by slab (whole layers each): each
        slab quantized and split, then written into this rank's leaf."""
        out, at = None, 0
        for slab in slabs(shape, fan_in):
            part = split(quantize(slab) if quant else slab, spec)
            parts = part if isinstance(part, dict) else {"": part}
            if out is None:
                out = {k: torch.empty((shape[0], *v.shape[1:]),
                                      dtype=v.dtype, device=device)
                       for k, v in parts.items()}
            for k, v in parts.items():
                out[k][at:at + v.shape[0]] = v
            at += slab.shape[0]
        return out if isinstance(part, dict) else out[""]

    def layer_spec(key):
        return None if specs is None else specs["layers"][key]

    # layernorm1p stores its weights centred at 0 (applied as 1 + w).
    norm_w = torch.zeros if cfg.norm == "layernorm1p" else torch.ones
    layers = {
        "attn_norm": norm_w((L, D), dtype=dtype, device=device),
        "mlp_norm": norm_w((L, D), dtype=dtype, device=device),
    }
    # Each matrix's fan-in is its input width, the second-to-last axis.
    for key, shape in projection_shapes(cfg).items():
        layers[key] = stacked(shape, shape[-2], layer_spec(key),
                              quant=quantizable(key, shape))
    params: Params = {
        "embed": whole((V, D), D, None if specs is None else specs["embed"]),
        "layers": layers,
        "final_norm": norm_w((D,), dtype=dtype, device=device),
    }
    # Biases and norm offsets start at zero, as the reference's do.
    for key, shape in bias_shapes(cfg).items():
        t = torch.zeros(shape, dtype=dtype, device=device)
        if key.startswith("layers/"):
            layers[key[len("layers/"):]] = split(t, layer_spec(
                key[len("layers/"):]))
        else:
            params[key] = t
    if not cfg.tie_word_embeddings:
        params["lm_head"] = whole((D, V), D, None if specs is None
                                  else specs["lm_head"],
                                  quant=quantizable("lm_head", (D, V)))
    return params



def layer_params(params: Params, i: int) -> dict[str, Any]:
    """Layer ``i``'s slice of the stacked layer leaves (views). A
    quantized leaf is sliced leaf by leaf: ``{"q4": (L, K/2, N),
    "gscale": (L, G, N)}`` becomes ``{"q4": (K/2, N), "gscale": (G, N)}``."""
    return {k: ({n: t[i] for n, t in v.items()} if isinstance(v, dict)
                else v[i])
            for k, v in params["layers"].items()}


def param_tensors(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a parameter tree, quantized dict leaves included."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from param_tensors(v)
    else:
        yield tree


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Union[str, torch.device] = "cpu") -> KVCache:
    """Dense absolute-position cache {"k","v"}: (L, B, T, KV, hd)."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(cfg: LlamaConfig, n_pages: int, page_size: int,
                        dtype: torch.dtype = torch.bfloat16,
                        device: Union[str, torch.device] = "cpu",
                        quantized: bool = False) -> KVCache:
    """Block-pool KV cache {"k","v"}: (L, n_pages, KV, page, hd), the
    reference's layout (KV heads ahead of the page dim, so one kv head's
    page is a contiguous (page, hd) tile). Page 0 is the trash page:
    writes for inactive slots and prefill-bucket overhang land there.

    ``quantized``: int8 pools plus bf16 per-row scale pools "ks"/"vs"
    shaped (L, n_pages, KV, page) (``ops/kv_quant.py``), about half the
    bytes per cached token."""
    shape = (cfg.num_layers, n_pages, cfg.num_kv_heads, page_size,
             cfg.head_dim)
    if not quantized:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(shape[:4], dtype=SCALE_DTYPE, device=device),
            "vs": torch.zeros(shape[:4], dtype=SCALE_DTYPE, device=device)}


def kv_cache_quantized(kv_cache: KVCache) -> bool:
    """Whether a paged pool carries int8 rows and scale pools."""
    return "ks" in kv_cache


def kernel_tp_compatible(cfg: LlamaConfig, mesh: Optional[Mesh]) -> bool:
    """Whether each rank can run the paged decode kernel on its own shard
    (the reference's gate for its shard_mapped kernel call): only tp may
    split attention state, and both head counts must divide it."""
    if mesh is None:
        return True
    tp = mesh.shape.get("tp", 1)
    if mesh.shape.get("pp", 1) != 1:
        return False
    return (cfg.num_kv_heads % tp == 0 and cfg.num_heads % tp == 0
            and (cfg.num_kv_heads // tp) > 0)


@dataclass(frozen=True)
class TPLayout:
    """One rank's share of the model under a mesh (``tp_layout``).

    ``cfg`` is the rank's geometry: its query heads (H/tp when they
    divide tp, else all H: attention then runs whole on every rank), its
    kv heads, its F/tp MLP columns and its V/tp vocab rows. ``kv_select``
    names the global kv heads a rank keeps when wk/wv stay replicated
    (kv heads do not divide tp): the heads its query heads read, so its
    pool holds those alone."""
    cfg: LlamaConfig
    mesh: Optional[Mesh]
    q_sharded: bool
    kv_select: Optional[tuple[int, ...]]


def kv_heads_held(cfg: LlamaConfig, tp: int, rank: int) -> tuple[int, ...]:
    """The model's kv heads that tp rank ``rank`` keeps in its pool, in
    its pool's order (``tp_layout``'s split): a contiguous run of KV/tp
    when the kv heads divide tp, else those its query heads read."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if tp == 1:
        return tuple(range(KV))
    if KV % tp == 0:
        n = KV // tp
        return tuple(range(rank * n, (rank + 1) * n))
    # wk/wv replicated: keep the kv heads this rank's query heads read
    # (one per group, in head order), so the local grouping is even.
    q_sharded = H % tp == 0
    heads = H // tp if q_sharded else H
    G = H // KV
    first = rank * heads if q_sharded else 0
    need = sorted({(first + j) // G for j in range(heads)})
    per = [sum(1 for j in range(heads) if (first + j) // G == k)
           for k in need]
    if len(set(per)) != 1:
        # Uneven groups on this rank: one kv row per query head.
        need = [(first + j) // G for j in range(heads)]
    return tuple(need)


def tp_layout(cfg: LlamaConfig, mesh: Optional[Mesh]) -> TPLayout:
    """This rank's ``TPLayout`` under ``mesh`` (the whole model without
    one, or at tp = 1). The splits are ``llama_param_specs``'."""
    if not sharded(mesh):
        return TPLayout(cfg, None, False, None)
    tp, r = mesh.tp, mesh.tp_rank
    for name, n in (("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ShardingError(f"{name}={n} does not split over tp={tp}")
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q_sharded = H % tp == 0
    heads = H // tp if q_sharded else H
    held = kv_heads_held(cfg, tp, r)
    select = None if KV % tp == 0 else held
    local = replace(cfg, num_heads=heads, num_kv_heads=len(held),
                    intermediate_size=cfg.intermediate_size // tp,
                    vocab_size=cfg.vocab_size // tp)
    return TPLayout(local, mesh, q_sharded, select)


def embed_tokens(params: Params, tokens: torch.Tensor,
                 tpl: Optional[TPLayout] = None) -> torch.Tensor:
    """Token embedding rows. Under a mesh the table is split over the
    vocab: each rank looks up the ids of its own range (zeros for the
    others) and one all-reduce completes every row."""
    table = params["embed"]
    if tpl is None or tpl.mesh is None:
        return table[tokens.long()]
    Vl = table.shape[0]
    local = tokens.long() - tpl.mesh.tp_rank * Vl
    inside = (local >= 0) & (local < Vl)
    rows = table[local.clamp(0, Vl - 1)]
    return all_reduce_(torch.where(inside[..., None], rows,
                                   torch.zeros_like(rows)), tpl.mesh)


def _dense_mlp(x: torch.Tensor, lp: dict[str, Any],
               cfg: LlamaConfig, mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """The dense MLP. Under a mesh each rank holds F/tp columns of the
    up projections and the matching rows of ``w_down``: its product is a
    partial sum, completed by one all-reduce; the replicated ``b_down``
    is added once, after it."""
    if cfg.mlp == "squared_relu":
        # GPT-Next: relu(x W_up + b_up)^2 W_down + b_down, no gate.
        up = qmm(x, lp["w_up"])
        if "b_up" in lp:
            up = up + lp["b_up"]
        out = all_reduce_(qmm(torch.relu(up).square(), lp["w_down"]), mesh)
        if "b_down" in lp:
            out = out + lp["b_down"]
        return out
    gate = torch.nn.functional.silu(qmm(x, lp["w_gate"]))
    return all_reduce_(qmm(gate * qmm(x, lp["w_up"]), lp["w_down"]), mesh)


def _moe_mlp(x: torch.Tensor, lp: dict[str, Any],
             cfg: LlamaConfig, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mixtral MLP. The default is the sparse top-k capacity-routed path
    (``parallel/moe.py``, O(tokens * k) expert products);
    ``moe_impl="dense"`` is the zero-gated all-experts formulation
    (O(tokens * E), no capacity drops), the parity oracle: router logits
    in the activations' dtype, as the reference's. Under a mesh each rank
    runs its F/tp columns of every expert and one all-reduce completes the
    combined rows."""
    if cfg.moe_impl == "sparse":
        return sparse_moe_ffn(x, lp, cfg, mesh=mesh)
    if cfg.moe_impl != "dense":
        raise ConfigError(f"unknown moe_impl {cfg.moe_impl!r}; expected "
                          f"'sparse' or 'dense'")
    logits = x @ lp["router"].to(x.dtype)                           # (B,S,E)
    weights, idx = topk_lowest_index_first(logits,
                                           cfg.num_experts_per_tok)
    weights = torch.softmax(weights.float(), dim=-1).to(x.dtype)
    gates = torch.zeros_like(logits).scatter(-1, idx, weights)
    gate = torch.nn.functional.silu(
        torch.einsum("bsd,edf->bsef", x, lp["w_gate"]))
    up = torch.einsum("bsd,edf->bsef", x, lp["w_up"])
    down = torch.einsum("bsef,efd->bsed", gate * up, lp["w_down"])
    return all_reduce_(torch.einsum("bsed,bse->bsd", down, gates), mesh)


def block_norm(x: torch.Tensor, lp: dict[str, Any], key: str,
               cfg: LlamaConfig) -> torch.Tensor:
    """The per-block normalization: rmsnorm (llama) or layernorm1p
    (GPT-Next), by config."""
    if cfg.norm == "layernorm1p":
        return layernorm1p(x, lp[key], lp[key + "_b"], cfg.rms_norm_eps)
    return rmsnorm(x, lp[key], cfg.rms_norm_eps)


def decoder_layer(h: torch.Tensor, lp: dict[str, Any],
                  cfg: LlamaConfig, positions: torch.Tensor,
                  inv_freq: torch.Tensor,
                  kv_valid_len: Optional[torch.Tensor],
                  cache_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                  attend=None, tpl: Optional[TPLayout] = None
                  ) -> torch.Tensor:
    """One transformer block, shared by ``apply``, ``apply_decode_paged``
    and ``apply_prefill_paged`` (the last two supply
    ``attend(q, k, v) -> attn``).

    cache_kv: optional (kc, vc) of shape (B, T, KV, hd), updated IN PLACE
    with this chunk's K/V at rows ``positions[b]``, by device-side index
    (no host read, so a CUDA graph can capture it); a position past the
    cache raises.

    ``tpl``: this rank's share under a mesh (``tp_layout``; ``cfg`` is
    then the whole model's). The rank projects its own query and kv heads
    (the heads of ``tpl.kv_select`` out of replicated wk/wv), attends with
    them, and its ``wo`` and down products are partial sums that one
    all-reduce each completes; the replicated ``bo`` and ``b_down`` are
    added once, after it."""
    mesh = None
    if tpl is not None:
        cfg, mesh = tpl.cfg, tpl.mesh
    B, S, _ = h.shape
    x = block_norm(h, lp, "attn_norm", cfg)
    q, k, v = qmm(x, lp["wq"]), qmm(x, lp["wk"]), qmm(x, lp["wv"])
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, -1, cfg.head_dim)
    v = v.reshape(B, S, -1, cfg.head_dim)
    if tpl is not None and tpl.kv_select is not None:
        sel = list(tpl.kv_select)
        k, v = k[:, :, sel], v[:, :, sel]
    q, k = apply_rope(q, k, positions, inv_freq)
    if attend is not None:
        attn = attend(q, k, v)
    elif cache_kv is not None:
        kc, vc = cache_kv
        rows = torch.arange(B, device=h.device)[:, None]
        kc[rows, positions.long()] = k.to(kc.dtype)
        vc[rows, positions.long()] = v.to(vc.dtype)
        attn = gqa_attention(q, kc, vc, positions, kv_valid_len)
    else:
        attn = gqa_attention(q, k, v, positions, kv_valid_len)
    attn_out = qmm(attn.reshape(B, S, cfg.q_dim), lp["wo"])
    if tpl is not None and tpl.q_sharded:
        all_reduce_(attn_out, mesh)
    if "bo" in lp:
        attn_out = attn_out + lp["bo"]
    h = h + attn_out
    x = block_norm(h, lp, "mlp_norm", cfg)
    mlp = (_moe_mlp(x, lp, cfg, mesh) if cfg.num_experts
           else _dense_mlp(x, lp, cfg, mesh))
    return h + mlp


def unembed_norm(params: Params, cfg: LlamaConfig,
                 h: torch.Tensor) -> torch.Tensor:
    """The final-norm half of ``unembed``."""
    if cfg.norm == "layernorm1p":
        return layernorm1p(h, params["final_norm"], params["final_norm_b"],
                           cfg.rms_norm_eps)
    return rmsnorm(h, params["final_norm"], cfg.rms_norm_eps)


def unembed(params: Params, cfg: LlamaConfig, h: torch.Tensor,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Final norm + output projection: (..., D) -> (..., V) float32."""
    return project_logits(params, unembed_norm(params, cfg, h), mesh)


def project_logits(params: Params, hn: torch.Tensor,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Already-normed hidden states -> float32 logits. Under a mesh each
    rank projects onto its vocab shard and the shards are gathered in
    rank order (vocab order): every rank holds the whole (..., V)."""
    head = params.get("lm_head")
    local = qmm_f32(hn, params["embed"].T if head is None else head)
    if not sharded(mesh):
        return local
    g = all_gather(local, mesh)                         # (n, ..., V/n)
    return torch.movedim(g, 0, -2).reshape(*local.shape[:-1], -1)


# A quantized head's leaves that carry the vocab axis last (sliced per
# tile); ``pre_scale`` runs along the reduction axis.
_HEAD_VOCAB_LEAVES = ("q", "q4", "scale", "gscale", "gbias")


def lm_head_input(params: Params, hn: torch.Tensor) -> torch.Tensor:
    """The rows the head's product takes: an AWQ head's activation
    smoothing (``pre_scale``) applied to the normed hidden states, once
    for every vocab tile of a step (``lm_head_tile(..., prescaled=True)``),
    with the arithmetic ``ops/quant.py`` applies per call."""
    head = params.get("lm_head")
    if isinstance(head, dict) and "pre_scale" in head:
        return (hn.float() * head["pre_scale"]).to(hn.dtype)
    return hn


def lm_head_tile(params: Params, cfg: LlamaConfig, hn: torch.Tensor,
                 t0: int, tile: int, *, prescaled: bool = False
                 ) -> torch.Tensor:
    """Project already-normed hidden states onto ONE vocab tile:
    (B, D) x head[:, t0:t0 + tile] -> (B, tile) float32 (the reference's
    ``lm_head_tile``).

    Every head storage the port serves: the tied embedding (a row slice of
    (V, D)), a raw (D, V) head (a column slice), and quantized dicts (int8,
    int4 per channel or grouped, AWQ), whose packing runs along the
    reduction axis, so a vocab slice of each leaf is still a valid leaf.
    Slices are views: cuBLAS and the int4 kernel read them at their row
    stride, so a full pass over the tiles reads each weight byte once.
    ``prescaled``: ``hn`` already went through ``lm_head_input``."""
    head = params.get("lm_head")
    if head is None:
        return qmm_f32(hn, params["embed"][t0:t0 + tile].T)
    if isinstance(head, dict):
        sliced = {k: (v[..., t0:t0 + tile] if k in _HEAD_VOCAB_LEAVES else v)
                  for k, v in head.items()
                  if not (prescaled and k == "pre_scale")}
        return qmm_f32(hn, sliced)
    return qmm_f32(hn, head[:, t0:t0 + tile])


def apply(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
          positions: torch.Tensor, kv_cache: Optional[KVCache] = None,
          kv_valid_len: Optional[torch.Tensor] = None, *,
          return_hidden: bool = False, mesh: Optional[Mesh] = None,
          ) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Forward pass (prefill / full sequence).

    tokens, positions: (B, S) int (positions row-contiguous).
    kv_cache: absolute-position cache; new K/V are written at
        ``positions`` IN PLACE and attention reads the whole cache.
    kv_valid_len: (B,) valid keys per row; defaults to
        ``positions[:, -1] + 1`` with a cache, else causal masking only.
    Returns (logits (B, S, V) float32, or the final-normed hidden states
    under ``return_hidden``; the cache or None).

    ``mesh``: ``params`` are this rank's shard (``parallel/sharding.py``)
    and ``kv_cache`` holds its kv heads (``tp_layout``); every rank runs
    the call with the same inputs and gets the same outputs."""
    tpl = tp_layout(cfg, mesh)
    h = embed_tokens(params, tokens, tpl)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling_factor, device=h.device)
    if kv_cache is not None and kv_valid_len is None:
        kv_valid_len = positions[:, -1] + 1
    for i in range(cfg.num_layers):
        cache_kv = (None if kv_cache is None
                    else (kv_cache["k"][i], kv_cache["v"][i]))
        h = decoder_layer(h, layer_params(params, i), cfg, positions,
                          inv_freq, kv_valid_len, cache_kv, tpl=tpl)
    if return_hidden:
        return unembed_norm(params, cfg, h), kv_cache
    return unembed(params, cfg, h, mesh), kv_cache


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """float32 NLL of ``targets`` (B, n) under ``logits`` (B, n, V)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


@torch.no_grad()
def score(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, *,
          mesh=None, chunk: int = 2048) -> torch.Tensor:
    """Per-token negative log-likelihood of a (long) sequence (the
    reference's ``llama.score``, its single-device path).

    A sequence of at most ``chunk`` tokens takes one ``apply``. A longer
    one streams through ``apply`` in chunks of ``chunk`` tokens against a
    dense cache, so the activations are one chunk's while attention is
    exact over the whole prefix. As in the reference the sequence is
    padded to a chunk multiple (the padded tail is causally invisible and
    its rows are dropped) and the cache length is rounded up to a power of
    two of at least ``chunk`` (the reference bounds its compiled shapes
    so; here it keeps the cache's allocations to a few sizes).

    tokens: (B, S) int on the parameters' device, S >= 2 (position 0 has
    no prediction). Returns (B, S-1) float32: the NLL of token t+1 given
    tokens <= t.

    ``mesh``: as in the reference, a mesh without sequence parallelism
    takes the tensor-parallel forward (``params`` this rank's shard, the
    dense cache its kv heads; every rank of the group calls this with
    the same tokens and gets the whole result). The reference's
    sequence-parallel path (ring attention over sp > 1) is not ported:
    such a mesh raises ``ConfigError``."""
    B, S = tokens.shape
    if S < 2:
        raise ValueError("score needs at least 2 tokens")
    if chunk < 16:
        raise ValueError(f"chunk must be >= 16, got {chunk}")
    if mesh is not None and mesh.shape.get("sp", 1) > 1:
        raise ConfigError("sequence-parallel scoring (ring attention over "
                          "an sp mesh) is not ported yet (ROADMAP.md A12)")
    mesh = mesh if sharded(mesh) else None
    dev = tokens.device
    if S <= chunk:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev).expand(B, S)
        logits, _ = apply(params, cfg, tokens, positions, mesh=mesh)
        return _nll(logits[:, :-1], tokens[:, 1:])
    S_pad = -(-S // chunk) * chunk
    padded = torch.nn.functional.pad(tokens, (0, S_pad - S))
    cache_len = chunk
    while cache_len < S_pad:
        cache_len *= 2
    # final_norm is never quantized: its dtype is the activations'.
    cache = init_kv_cache(tp_layout(cfg, mesh).cfg, B, cache_len,
                          params["final_norm"].dtype, device=dev)
    parts, prev_last = [], None
    for c0 in range(0, S_pad, chunk):
        tok_c = padded[:, c0:c0 + chunk]
        pos_c = torch.arange(c0, c0 + chunk, dtype=torch.int32,
                             device=dev).expand(B, chunk)
        logits, cache = apply(params, cfg, tok_c, pos_c, cache,
                              kv_valid_len=pos_c[:, -1] + 1, mesh=mesh)
        if prev_last is not None:
            # The previous chunk's last position predicts this chunk's
            # first token.
            parts.append(_nll(prev_last, tok_c[:, :1]))
        parts.append(_nll(logits[:, :-1], tok_c[:, 1:]))
        prev_last = logits[:, -1:]
    return torch.cat(parts, dim=1)[:, :S - 1]


def apply_decode_paged(params: Params, cfg: LlamaConfig,
                       tokens: torch.Tensor, positions: torch.Tensor,
                       kv_cache: KVCache, block_table: torch.Tensor,
                       write_page: torch.Tensor, write_offset: torch.Tensor,
                       *, return_hidden: bool = False,
                       mesh: Optional[Mesh] = None,
                       ) -> tuple[torch.Tensor, KVCache]:
    """Single-token decode step over the paged KV pool.

    tokens/positions: (B, 1); ``positions[:, 0]`` is each slot's cached
    length (0 for inactive slots). block_table: (B, W) int32, the slots'
    page windows (a column slice of the engine's table is fine).
    write_page/write_offset: (B,) int32 destination of this step's K/V
    (page 0 = trash for inactive slots).

    Each layer calls ``ops.paged_attention.paged_attention_decode`` once:
    the Hopper kernel on CUDA tensors, the plain gather version (the
    reference's ``_gathered_window`` path) on CPU tensors. Under an int8
    pool (``kv_cache_quantized``) the scale pools go along and the current
    K/V pass in the compute dtype: the kernel quantizes its appended row.
    The pool is updated in place. Returns (logits (B, 1, V) float32, or
    under ``return_hidden`` the hidden states (B, 1, D) before the final
    norm, for the fused tail; kv_cache).

    ``mesh`` (the reference's shard_mapped kernel call): each rank runs
    the kernel on its own query heads and its kv heads' pool shard; the
    table, positions and write targets are the same on every rank."""
    tpl = tp_layout(cfg, mesh)
    h = embed_tokens(params, tokens, tpl)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling_factor, device=h.device)
    lengths = positions[:, 0].to(torch.int32)
    pool_k, pool_v = kv_cache["k"], kv_cache["v"]
    quant = kv_cache_quantized(kv_cache)
    cur_dtype = h.dtype if quant else pool_k.dtype
    scales = ({"pool_ks": kv_cache["ks"], "pool_vs": kv_cache["vs"]}
              if quant else {})
    for i in range(cfg.num_layers):
        def attend(q, k, v, i=i):
            attn = paged_attention_decode(
                q[:, 0].contiguous(), pool_k, pool_v, block_table, lengths,
                k[:, 0].to(cur_dtype).contiguous(),
                v[:, 0].to(cur_dtype).contiguous(), write_page,
                write_offset, i, **scales)
            return attn[:, None]
        h = decoder_layer(h, layer_params(params, i), cfg, positions,
                          inv_freq, None, attend=attend, tpl=tpl)
    if return_hidden:
        return h, kv_cache
    return unembed(params, cfg, h, mesh), kv_cache


def _gathered_window(pool_layer: torch.Tensor,
                     scales_layer: Optional[torch.Tensor],
                     block_table: torch.Tensor, cfg: LlamaConfig,
                     dtype: torch.dtype) -> torch.Tensor:
    """One layer's slot windows gathered from the paged pool (the
    reference's ``_gathered_window``): (N, KV, page, hd) over a (B, P)
    table -> (B, P*page, KV, hd) in ``dtype``, int8 pages dequantized
    through their row scales (``scales_layer`` (N, KV, page), or None)."""
    B, P = block_table.shape
    tbl = block_table.long()
    g = pool_layer[tbl]                              # (B, P, KV, page, hd)
    if scales_layer is not None:
        g = dequantize_rows(g, scales_layer[tbl], dtype)
    page = g.shape[3]
    return g.to(dtype).transpose(2, 3).reshape(
        B, P * page, cfg.num_kv_heads, cfg.head_dim)


def apply_verify_paged(params: Params, cfg: LlamaConfig,
                       tokens: torch.Tensor, positions: torch.Tensor,
                       kv_cache: KVCache, block_table: torch.Tensor,
                       kv_valid_len: torch.Tensor, write_pages: torch.Tensor,
                       write_offsets: torch.Tensor, *,
                       return_hidden: bool = False,
                       mesh: Optional[Mesh] = None,
                       ) -> tuple[torch.Tensor, KVCache]:
    """Multi-token decode step over the paged pool: the speculative
    verify forward (the reference's ``apply_verify_paged``).

    Scores ``S`` consecutive positions per slot in one forward: the last
    accepted token and up to S-1 drafts. tokens/positions: (B, S), each
    row's positions contiguous (``pos .. pos+S-1``). block_table: (B, P)
    window covering every scored position of a live row.
    write_pages/write_offsets: (B, S) destination of each token's K/V
    (page 0 = trash for inactive slots and rows past the slot's drafts).
    kv_valid_len: (B,) = ``pos + S``; with causal masking draft j attends
    the pool prefix plus drafts 0..j-1, as sequential decode would.

    Attention is the reference's gather path on every backend (plain
    PyTorch, no kernel): each layer gathers the slots' windows
    (``_gathered_window``) and the S current rows join them in place at
    their positions. The gather runs ``ceil(S / page)`` trash pages past
    the table, so the rows of a slot near the end of its window (masked
    garbage rows only) land inside it instead of being dropped. The layer
    loop only reads the pool; the new K/V are written after it, int8
    pools through ``quantize_rows``. Rejected drafts need no undo: the
    engine does not advance ``pos`` past the accepted tokens, so their
    rows are overwritten later and never read. The pool is updated in
    place. Returns (logits (B, S, V) float32, or under ``return_hidden``
    the hidden states (B, S, D) before the final norm; kv_cache).
    ``mesh``: as ``apply_decode_paged``'s, each rank on its own heads."""
    B, S = tokens.shape
    page = kv_cache["k"].shape[3]  # (L, N, KV, page, hd)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling_factor, device=tokens.device)
    tpl = tp_layout(cfg, mesh)
    h = embed_tokens(params, tokens, tpl)
    quant = kv_cache_quantized(kv_cache)
    window = torch.nn.functional.pad(block_table, (0, -(-S // page)))
    rows = torch.arange(B, device=tokens.device)[:, None]
    pos = positions.long()
    new_k, new_v = [], []
    for i in range(cfg.num_layers):
        kc, vc = kv_cache["k"][i], kv_cache["v"][i]
        ksc = kv_cache["ks"][i] if quant else None
        vsc = kv_cache["vs"][i] if quant else None

        def attend(q, k, v, kc=kc, vc=vc, ksc=ksc, vsc=vsc):
            kg = _gathered_window(kc, ksc, window, tpl.cfg, h.dtype)
            vg = _gathered_window(vc, vsc, window, tpl.cfg, h.dtype)
            kg[rows, pos] = k.to(kg.dtype)
            vg[rows, pos] = v.to(vg.dtype)
            new_k.append(k)
            new_v.append(v)
            return gqa_attention(q, kg, vg, positions, kv_valid_len)

        h = decoder_layer(h, layer_params(params, i), cfg, positions,
                          inv_freq, kv_valid_len, attend=attend, tpl=tpl)
    wp, off = write_pages.long(), write_offsets.long()
    for name, layers in (("k", new_k), ("v", new_v)):
        pool = kv_cache[name]
        for i, new in enumerate(layers):
            # (B, S, KV, hd) rows into (page, :, offset) of layer i.
            if quant:
                q8, scales = quantize_rows(new)
                pool[i, wp, :, off] = q8
                kv_cache[name + "s"][i, wp, :, off] = scales
            else:
                pool[i, wp, :, off] = new.to(pool.dtype)
    if return_hidden:
        return h, kv_cache
    return unembed(params, cfg, h, mesh), kv_cache


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` on storage-dtype operands with a float32 result
    (the reference's ``preferred_element_type=jnp.float32``). On the card
    a bf16 product goes to the tensor cores with fp32 accumulation and an
    fp32 output; elsewhere both operands are widened first, which gives
    the same exact products, summed in float32."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


# Pages per streamed block of a chunk's prefix (the reference's default).
PREFIX_BLOCK_PAGES = 8


def _paged_prefix_attention(q, k_self, v_self, kc, vc, ksc, vsc,
                            block_table, start, kv_valid_len, page: int,
                            cfg: LlamaConfig,
                            block_pages: int = PREFIX_BLOCK_PAGES):
    """Chunk queries attend [pooled prefix] + [their own chunk], the prefix
    streamed from the pool in ``block_pages``-page blocks under an online
    softmax (the reference's ``_paged_prefix_attention``, same
    arithmetic).

    q:            (1, C, H, hd) post-rope queries (C = chunk length)
    k/v_self:     (1, C, KV, hd) this chunk's post-rope K/V (not yet in
                  the pool: the pool's rows for these positions are stale)
    kc/vc:        (N, KV, page, hd) one layer's pool (int8 when ksc/vsc,
                  its (N, KV, page) scale pools, are given)
    block_table:  (1, P) logical -> physical page window
    start:        () int32 device scalar, the chunk's first absolute
                  position (page-aligned); pool rows at or past it are
                  masked
    kv_valid_len: (1,) int32, start + valid tokens in this chunk
    Returns (1, C, H, hd) in q.dtype.

    q.k and p.v run on storage-dtype operands with float32 results
    (``_dot_f32``); the softmax state is float32 and p is cast to the
    compute dtype before p.v. Masked probabilities are zeroed, and so are
    the masked rows of each V block, so a non-finite stale row cannot
    reach the output. The reference skips blocks wholly past ``start`` at
    run time; a CUDA graph cannot branch on a device value, so here every
    block of the window runs, fully masked where dead (which leaves the
    softmax state exactly as it was)."""
    B, C, H, hd = q.shape
    KV = cfg.num_kv_heads
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    P = block_table.shape[1]
    nb = -(-P // block_pages)
    tbl = torch.nn.functional.pad(block_table[0],
                                  (0, nb * block_pages - P)).long()
    cd = q.dtype
    dev = q.device
    # (C, H, hd) -> (KV, G*C, hd): one batched product per kv head.
    qk = q[0].reshape(C, KV, G, hd).permute(1, 2, 0, 3).reshape(KV, G * C, hd)
    tblk = block_pages * page
    rel = torch.arange(C, dtype=torch.int32, device=dev)
    m = torch.full((KV, G * C), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((KV, G * C), dtype=torch.float32, device=dev)
    acc = torch.zeros((KV, G * C, hd), dtype=torch.float32, device=dev)

    def online(m, l, acc, kb, vb, mask):
        """One online-softmax update over a key block: kb/vb (KV, T, hd),
        mask (C, T) or (T,) of visible keys. The score tile is updated in
        place (the reference's operations, in its order)."""
        T = kb.shape[1]
        dead = ~mask.expand(C, T).repeat(G, 1)[None]         # (1, G*C, T)
        s = _dot_f32(qk, kb.transpose(1, 2)).mul_(scale)     # (KV, G*C, T)
        s.masked_fill_(dead, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = s.sub_(m_new[..., None]).exp_().masked_fill_(dead, 0.0)
        l_new = l * alpha + p.sum(dim=-1)
        vis = mask.reshape(-1, T).any(dim=0)                  # (T,)
        vb = vb.masked_fill(~vis[None, :, None], 0)
        acc_new = acc * alpha[..., None] + _dot_f32(p.to(cd), vb)
        return m_new, l_new, acc_new

    def block_rows(pool, scales, pages):
        g = pool[pages]                                  # (bp, KV, page, hd)
        if scales is not None:
            g = dequantize_rows(g, scales[pages], cd)
        return g.permute(1, 0, 2, 3).reshape(KV, tblk, hd).to(cd)

    for bi in range(nb):
        pages = tbl[bi * block_pages:(bi + 1) * block_pages]
        t = bi * tblk + torch.arange(tblk, dtype=torch.int32, device=dev)
        # Prefix rows only, each visible to every chunk query.
        m, l, acc = online(m, l, acc, block_rows(kc, ksc, pages),
                           block_rows(vc, vsc, pages), t < start)

    # The chunk itself, in key blocks of at most 512.
    sb = min(C, 512)
    while C % sb:
        sb //= 2
    ks = k_self[0].permute(1, 0, 2)                      # (KV, C, hd)
    vs = v_self[0].permute(1, 0, 2)
    for si in range(C // sb):
        tloc = si * sb + torch.arange(sb, dtype=torch.int32, device=dev)
        ok = ((tloc[None, :] <= rel[:, None])
              & ((start + tloc) < kv_valid_len[0])[None, :])
        m, l, acc = online(m, l, acc, ks[:, si * sb:(si + 1) * sb],
                           vs[:, si * sb:(si + 1) * sb], ok)
    # Padded rows past kv_valid_len attend nothing: floor the denominator
    # so they give zeros, not NaN.
    out = acc / torch.clamp(l[..., None], min=1e-30)
    # (KV, G*C, hd) -> (1, C, H, hd)
    return out.reshape(KV, G, C, hd).permute(2, 0, 1, 3).reshape(
        1, C, H, hd).to(q.dtype)


def apply_prefill_paged(params: Params, cfg: LlamaConfig,
                        tokens: torch.Tensor, positions: torch.Tensor,
                        kv_cache: KVCache, block_table: torch.Tensor,
                        kv_valid_len: torch.Tensor,
                        start_page_idx: torch.Tensor, *,
                        prefix_pages: Optional[int] = None,
                        mesh: Optional[Mesh] = None,
                        ) -> tuple[torch.Tensor, KVCache]:
    """One chunk of a prompt's prefill over the paged KV pool (B = 1): the
    chunk attends the prefix already in the slot's pages plus itself, and
    its K/V land in the slot's pages.

    tokens/positions: (1, C), C a page multiple, positions starting at a
    page boundary. block_table: (1, P) logical -> physical window covering
    the chunk's padded span. kv_valid_len: (1,) = chunk start + valid
    tokens in this chunk. start_page_idx: (1,) or () int32, the logical
    page of the chunk's first row; the destination pages are
    ``block_table[0, start_page_idx + i]``. ``prefix_pages`` (static)
    bounds the window the prefix attention streams, the first
    ``prefix_pages`` columns of ``block_table`` (None: all of it; 0: the
    chunk starts at position 0 and has no prefix).

    Positions and the start are device tensors and nothing reads them on
    the host, so a CUDA graph can capture the function. The layer loop
    only reads the pool; each layer's chunk K/V are collected and written
    after it in one scatter (int8 pools through ``quantize_rows``, one
    layer at a time, giving the reference's bytes). The pool is updated
    in place. Returns (hidden states (1, C, D) before the final norm,
    the pool): the caller unembeds only the rows it samples. ``mesh``: as
    ``apply_decode_paged``'s, each rank on its own heads."""
    B, C = tokens.shape
    if B != 1:
        raise ValueError("apply_prefill_paged is single-request (B=1)")
    page = kv_cache["k"].shape[3]  # (L, N, KV, page, hd)
    if C % page:
        raise ValueError(f"chunk {C} not a page ({page}) multiple")
    nb = C // page
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling_factor, device=tokens.device)
    tpl = tp_layout(cfg, mesh)
    h = embed_tokens(params, tokens, tpl)
    start = positions[0, 0]
    quant = kv_cache_quantized(kv_cache)
    window = block_table if prefix_pages is None else \
        block_table[:, :prefix_pages]
    new_k, new_v = [], []
    for i in range(cfg.num_layers):
        kc, vc = kv_cache["k"][i], kv_cache["v"][i]
        ksc = kv_cache["ks"][i] if quant else None
        vsc = kv_cache["vs"][i] if quant else None

        def attend(q, k, v, kc=kc, vc=vc, ksc=ksc, vsc=vsc):
            new_k.append(k[0])
            new_v.append(v[0])
            return _paged_prefix_attention(
                q, k, v, kc, vc, ksc, vsc, window, start, kv_valid_len,
                page, tpl.cfg)

        h = decoder_layer(h, layer_params(params, i), cfg, positions,
                          inv_freq, kv_valid_len, attend=attend, tpl=tpl)
    dest = (start_page_idx.reshape(()).long()
            + torch.arange(nb, device=tokens.device))
    dest = block_table[0].long().index_select(0, dest)
    KV, hd = tpl.cfg.num_kv_heads, cfg.head_dim
    for name, rows in (("k", new_k), ("v", new_v)):
        pool = kv_cache[name]
        for i, r in enumerate(rows):
            # (C, KV, hd) -> (nb, KV, page, hd): the pool's layout.
            blocks = r.reshape(nb, page, KV, hd).transpose(1, 2)
            if quant:
                qrows, scales = quantize_rows(blocks)
                pool[i, dest] = qrows
                kv_cache[name + "s"][i, dest] = scales
            else:
                pool[i, dest] = blocks.to(pool.dtype)
    return h, kv_cache
