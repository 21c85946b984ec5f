"""Llama-family decoder in PyTorch — port of the reference's
``models/llama.py`` for the llama-2 geometry (rmsnorm, swiglu, no biases,
dense MLP).

Parameters are a plain dict of tensors keyed and shaped exactly like the
reference's parameter tree, so weights carry across without transposes
(``models/convert.py``). Every projection is stored input-major and the
forward is ``x @ W``:

  embed:       (V, D)
  layers:
    attn_norm: (L, D)         mlp_norm: (L, D)
    wq: (L, D, H*hd)  wk: (L, D, KV*hd)  wv: (L, D, KV*hd)  wo: (L, H*hd, D)
    w_gate/w_up: (L, D, F)    w_down: (L, F, D)
  final_norm:  (D,)
  lm_head:     (D, V)          (absent when embeddings are tied)

After ``ops.quant.quantize_params`` each projection and ``lm_head`` is a
dict leaf of the same stacked shape (``ops/quant.py``), and every
``x @ W`` goes through ``ops.quant.matmul``.

The reference scans over stacked layers; here a Python loop walks them
(``layer_params``), and KV caches and the paged pool are updated in place
where the reference threaded them through its scan carry.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Union

import torch

from ..ops.attention import gqa_attention
from ..ops.kv_quant import SCALE_DTYPE
from ..ops.paged_attention import paged_attention_decode
from ..ops.quant import matmul as qmm
from ..ops.quant import matmul_f32 as qmm_f32
from ..ops.rmsnorm import rmsnorm
from ..ops.rope import apply_rope, rope_frequencies
from ..utils.errors import ConfigError
from .configs import LlamaConfig

Params = dict[str, Any]
KVCache = dict[str, torch.Tensor]  # {"k", "v"[, "ks", "vs"]}


def check_supported(cfg: LlamaConfig) -> None:
    """This slice serves the llama-2 family only; other architecture
    branches of the reference (MoE, layernorm1p, squared-ReLU, biases)
    wait for later slices."""
    if (cfg.num_experts or cfg.norm != "rmsnorm" or cfg.mlp != "swiglu"
            or cfg.attn_bias or cfg.mlp_bias):
        raise ConfigError(
            "the port serves rmsnorm/swiglu llama geometries without "
            "biases or experts; this config needs a later slice")


def init_params(cfg: LlamaConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: Union[str, torch.device] = "cpu") -> Params:
    """Random-init parameter tree, made on ``device`` from ``seed`` (for
    tests and benchmarks; normal(0, 1/sqrt(fan_in)) like the reference,
    though the two frameworks' random streams differ). Leaves are drawn in
    float32 slabs of at most 64 Mi elements along their leading axis, so
    the float32 transient stays small beside the weights."""
    check_supported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, KV, hd, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size

    def norm(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=device)
        row = out[0].numel()
        step = max(1, (64 << 20) // row)
        for i in range(0, shape[0], step):
            n = min(step, shape[0] - i)
            out[i:i + n] = (torch.randn((n, *shape[1:]), generator=gen,
                                        device=device, dtype=torch.float32)
                            * fan_in ** -0.5)
        return out

    layers = {
        "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
        "mlp_norm": torch.ones((L, D), dtype=dtype, device=device),
        "wq": norm((L, D, H * hd), D),
        "wk": norm((L, D, KV * hd), D),
        "wv": norm((L, D, KV * hd), D),
        "wo": norm((L, H * hd, D), H * hd),
        "w_gate": norm((L, D, F), D),
        "w_up": norm((L, D, F), D),
        "w_down": norm((L, F, D), F),
    }
    params: Params = {
        "embed": norm((V, D), D),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dtype, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = norm((D, V), D)
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


def _dense_mlp(x: torch.Tensor, lp: dict[str, Any]) -> torch.Tensor:
    gate = torch.nn.functional.silu(qmm(x, lp["w_gate"]))
    return qmm(gate * qmm(x, lp["w_up"]), lp["w_down"])


def block_norm(x: torch.Tensor, lp: dict[str, Any], key: str,
               cfg: LlamaConfig) -> torch.Tensor:
    """The per-block normalization (rmsnorm for this family)."""
    return rmsnorm(x, lp[key], cfg.rms_norm_eps)


def decoder_layer(h: torch.Tensor, lp: dict[str, Any],
                  cfg: LlamaConfig, positions: torch.Tensor,
                  inv_freq: torch.Tensor,
                  kv_valid_len: Optional[torch.Tensor],
                  cache_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                  attend=None) -> torch.Tensor:
    """One transformer block, shared by ``apply`` and
    ``apply_decode_paged`` (which supplies ``attend(q, k, v) -> attn``).

    cache_kv: optional (kc, vc) of shape (B, T, KV, hd), updated IN PLACE
    with this chunk's K/V at rows ``positions[b]``, by device-side index
    (no host read, so a CUDA graph can capture it); a position past the
    cache raises."""
    B, S, _ = h.shape
    x = block_norm(h, lp, "attn_norm", cfg)
    q = qmm(x, lp["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = qmm(x, lp["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = qmm(x, lp["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
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
    h = h + qmm(attn.reshape(B, S, cfg.q_dim), lp["wo"])
    x = block_norm(h, lp, "mlp_norm", cfg)
    return h + _dense_mlp(x, lp)


def unembed_norm(params: Params, cfg: LlamaConfig,
                 h: torch.Tensor) -> torch.Tensor:
    """The final-norm half of ``unembed``."""
    return rmsnorm(h, params["final_norm"], cfg.rms_norm_eps)


def unembed(params: Params, cfg: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + output projection: (..., D) -> (..., V) float32."""
    return project_logits(params, unembed_norm(params, cfg, h))


def project_logits(params: Params, hn: torch.Tensor) -> torch.Tensor:
    """Already-normed hidden states -> float32 logits."""
    head = params.get("lm_head")
    if head is None:
        return qmm_f32(hn, params["embed"].T)
    return qmm_f32(hn, head)


def apply(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
          positions: torch.Tensor, kv_cache: Optional[KVCache] = None,
          kv_valid_len: Optional[torch.Tensor] = None, *,
          return_hidden: bool = False,
          ) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Forward pass (prefill / full sequence).

    tokens, positions: (B, S) int (positions row-contiguous).
    kv_cache: absolute-position cache; new K/V are written at
        ``positions`` IN PLACE and attention reads the whole cache.
    kv_valid_len: (B,) valid keys per row; defaults to
        ``positions[:, -1] + 1`` with a cache, else causal masking only.
    Returns (logits (B, S, V) float32, or the final-normed hidden states
    under ``return_hidden``; the cache or None)."""
    h = params["embed"][tokens.long()]
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                cfg.rope_scaling_factor, device=h.device)
    if kv_cache is not None and kv_valid_len is None:
        kv_valid_len = positions[:, -1] + 1
    for i in range(cfg.num_layers):
        cache_kv = (None if kv_cache is None
                    else (kv_cache["k"][i], kv_cache["v"][i]))
        h = decoder_layer(h, layer_params(params, i), cfg, positions,
                          inv_freq, kv_valid_len, cache_kv)
    if return_hidden:
        return unembed_norm(params, cfg, h), kv_cache
    return unembed(params, cfg, h), kv_cache


def apply_decode_paged(params: Params, cfg: LlamaConfig,
                       tokens: torch.Tensor, positions: torch.Tensor,
                       kv_cache: KVCache, block_table: torch.Tensor,
                       write_page: torch.Tensor, write_offset: torch.Tensor,
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
    The pool is updated in place. Returns (logits (B, 1, V) float32,
    kv_cache)."""
    h = params["embed"][tokens.long()]
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
                          inv_freq, None, attend=attend)
    return unembed(params, cfg, h), kv_cache
