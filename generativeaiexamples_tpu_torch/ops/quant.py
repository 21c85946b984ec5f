"""Weight-only quantization: per-channel int8/int4 and group-wise int4 —
port of the reference's ``ops/quant.py``.

A weight is stored input-major, ``(..., K, N)``, so the forward is
``x @ w``. A quantized weight is a dict leaf:

  int8:        ``{"q":  int8[..., K, N],   "scale": f32[..., N]}``
  int4:        ``{"q4": int8[..., K/2, N], "scale": f32[..., N]}``
  group int4:  ``{"q4": int8[..., K/2, N], "gscale": f32[..., G, N]}``
               + optional ``"gbias"`` f32[..., G, N] (asymmetric zeros,
               GPTQ) and ``"pre_scale"`` f32[..., K] (AWQ activation
               smoothing), with G = K / group_size.

int4 packs reduction-axis row pairs ``(2r, 2r+1)`` as the (low, high)
nibbles of one byte. Every int4 product goes through
``ops/int4_matmul.py``: the hand-written Hopper kernel on CUDA tensors,
its plain version on CPU tensors. The int8 product is a plain PyTorch
product with the scale applied after it, as the reference left it to XLA.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch


QTensor = dict[str, torch.Tensor]

# Weights quantized by quantize_params; norms and embeddings stay in
# high precision.
_QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
MODES = ("int8", "int4", "int4_awq")


def quantizable(key: str, shape: tuple) -> bool:
    """Whether quantization replaces the leaf under ``key`` (a layer key,
    or ``lm_head``) of ``shape``: the projections and the head. The MoE
    router and Mixtral's expert stacks (L, E, K, N) keep full precision,
    as in the reference: the experts run as batched library products.
    The one rule of ``quantize_params`` and of ``llama.init_params``'s
    quantized draw."""
    return key == "lm_head" or (key in _QUANT_LAYER_KEYS
                                and len(shape) <= 3)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and (
        ("scale" in w or "gscale" in w) and ("q" in w or "q4" in w))


def is_grouped(w: Any) -> bool:
    return isinstance(w, dict) and "gscale" in w


def weight_mode(w: Any) -> str:
    """The ``quantize_params`` mode that made leaf ``w`` ("" if raw)."""
    if not is_quantized(w):
        return ""
    if "q" in w:
        return "int8"
    return "int4_awq" if is_grouped(w) else "int4"


def _pack4(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int8 in [-8, 7] -> (..., K/2, N) nibble pairs."""
    return (q[..., 0::2, :] & 0x0F) | (q[..., 1::2, :] << 4)


def quantize_tensor(w: torch.Tensor, bits: int = 8,
                    reduce_absmax: Optional[Callable] = None) -> QTensor:
    """Symmetric per-output-channel quantization over the reduction axis:
    w (..., K, N) -> q in [-127, 127] (int8) or [-7, 7] (int4) with
    ``q * scale ~= w``. ``reduce_absmax``: applied in place to the
    (..., N) absmax before the scale is taken (a row-parallel shard's
    MAX all-reduce over the ranks holding the rest of K)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    wf = w.float()
    qmax = 127.0 if bits == 8 else 7.0
    absmax = wf.abs().amax(dim=-2)                          # (..., N)
    if reduce_absmax is not None:
        reduce_absmax(absmax)
    scale = (absmax / qmax).clamp_min(1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -qmax, qmax
                    ).to(torch.int8)
    if bits == 4:
        if q.shape[-2] % 2:
            raise ValueError(f"int4 needs even reduction dim, got "
                             f"{q.shape[-2]}")
        return {"q4": _pack4(q), "scale": scale}
    return {"q": q, "scale": scale}


def _unpack4(q4: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) packed nibbles -> (..., K, N) int8."""
    lo = (q4 << 4) >> 4                       # sign-extend the low nibble
    hi = q4 >> 4                              # arithmetic: the high nibble
    out = torch.stack([lo, hi], dim=-2)       # (..., K/2, 2, N)
    return out.reshape(*q4.shape[:-2], q4.shape[-2] * 2, q4.shape[-1])


def _int_weights(w: QTensor) -> torch.Tensor:
    return _unpack4(w["q4"]) if "q4" in w else w["q"]


def quantize_tensor_grouped(w: torch.Tensor, group_size: int = 128
                            ) -> QTensor:
    """Group-wise symmetric int4 (the AWQ storage format): per-(group,
    out) scales = absmax / 7 over each ``group_size`` slice of the
    reduction axis."""
    K, N = w.shape[-2], w.shape[-1]
    if K % group_size:
        raise ValueError(f"reduction dim {K} not divisible by group "
                         f"{group_size}")
    G = K // group_size
    wf = w.float().reshape(*w.shape[:-2], G, group_size, N)
    absmax = wf.abs().amax(dim=-2)                          # (..., G, N)
    gscale = (absmax / 7.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(wf / gscale[..., None, :]), -7, 7
                    ).to(torch.int8)
    return {"q4": _pack4(q.reshape(*w.shape[:-2], K, N)), "gscale": gscale}


def dequantize(w: QTensor, dtype: torch.dtype = torch.bfloat16
               ) -> torch.Tensor:
    q = _int_weights(w).float()
    if is_grouped(w):
        K, N = q.shape[-2], q.shape[-1]
        G = w["gscale"].shape[-2]
        out = q.reshape(*q.shape[:-2], G, K // G, N) * w["gscale"][..., None, :]
        if "gbias" in w:
            out = out + w["gbias"][..., None, :]
        out = out.reshape(q.shape)
        if "pre_scale" in w:
            # y = (x * s) @ W  ==  x @ (s[:, None] * W)
            out = out * w["pre_scale"][..., :, None]
        return out.to(dtype)
    return (q * w["scale"][..., None, :]).to(dtype)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 x (K, N) bf16 or int8 -> (M, N) float32: one cuBLAS
    bf16 GEMM with f32 accumulation and an f32 output on the card; the
    same arithmetic on widened operands elsewhere."""
    if x.is_cuda:
        return torch.mm(x, w.to(torch.bfloat16), out_dtype=torch.float32)
    return torch.matmul(x.float(), w.float())


class _MatmulF32Fn(torch.autograd.Function):
    """``_mm_f32`` under autograd: PyTorch registers no derivative for
    ``torch.mm(..., out_dtype=)``, so the gradients are written out, in
    float32 and then cast: ``dx = dy @ w^T``, ``dw = x^T @ dy``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (dy.float() @ w.float().T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x.float().T @ dy.float()).to(w.dtype)
        return dx, dw


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with a float32 result, for a raw or int8 ``w``. Compact
    operands stay compact: on the card a bf16 ``x`` and 2-D ``w`` go
    through one cuBLAS bf16 GEMM with f32 accumulation and an f32 output
    (``torch.mm(..., out_dtype=)``, which has no CPU backend), so a bf16
    weight is never copied to f32. An int8 weight is widened to a bf16
    copy on each call (its values are exact in bf16): that copy costs
    more bytes than the bf16 weight itself, until a W8A16 kernel exists.
    Elsewhere the operands are widened, which gives the same arithmetic
    (bf16 and int8 values are exact in f32; float32 matmuls run in full
    precision, TF32 off by default). Under autograd the card's product
    goes through ``_MatmulF32Fn``, which supplies its gradients."""
    if x.is_cuda and w.dim() == 2 and x.dtype == torch.bfloat16 and (
            w.dtype in (torch.bfloat16, torch.int8)):
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            out = _MatmulF32Fn.apply(x2, w)
        else:
            out = _mm_f32(x2, w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def _int4(x: torch.Tensor, w: QTensor,
          out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """An int4 leaf's product through ``ops/int4_matmul.py``. AWQ's
    activation smoothing folds into the inputs; GPTQ's zero-point term
    (``gbias``) goes to the kernel, which adds it per group. On the CPU a
    GPTQ leaf keeps the reference's ``_grouped_matmul`` (its zero-point
    term sums the float32 inputs). When autograd records ``x``'s graph
    (QLoRA) the product goes through ``int4_matmul_grad``, whose backward
    gives the inputs' gradient; the AWQ multiply before it is
    differentiated by autograd. Serving runs under ``no_grad`` and calls
    the kernel directly."""
    from .int4_matmul import int4_matmul, int4_matmul_grad
    if "gbias" in w and not x.is_cuda:
        return _grouped_matmul(x, _unpack4(w["q4"]), w, out_dtype=out_dtype)
    xin = x
    if "pre_scale" in w:
        xin = (x.float() * w["pre_scale"]).to(x.dtype)
    scale = w["gscale"] if is_grouped(w) else w["scale"]
    fn = (int4_matmul_grad if torch.is_grad_enabled() and xin.requires_grad
          else int4_matmul)
    return fn(xin, w["q4"], scale, gbias=w.get("gbias"), out_dtype=out_dtype)


def matmul(x: torch.Tensor, w: Union[torch.Tensor, QTensor]) -> torch.Tensor:
    """``x @ w`` in x's dtype, where w may be raw or quantized."""
    if not is_quantized(w):
        return torch.matmul(x, w)
    if "q4" in w:
        return _int4(x, w, None)
    return (_dot_f32(x, w["q"]) * w["scale"]).to(x.dtype)


def matmul_f32(x: torch.Tensor, w: Union[torch.Tensor, QTensor]
               ) -> torch.Tensor:
    """``x @ w`` with a float32 result — the logits path (never rounded
    through the activation dtype)."""
    if not is_quantized(w):
        return _dot_f32(x, w)
    if "q4" in w:
        return _int4(x, w, torch.float32)
    return _dot_f32(x, w["q"]) * w["scale"]


def _grouped_matmul(x: torch.Tensor, q: torch.Tensor, w: QTensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Group-wise dequant matmul without materializing the dequantized
    weight: per-group partial dots scaled by (G, N) scales, plus a rank-1
    bias term for asymmetric (GPTQ) zeros:
      y[n] = sum_g dot(x_g, q_g)[n] * s[g,n]  +  sum_g (sum x_g) b[g,n]
    ``out_dtype``: result dtype (default: x's)."""
    if q.dim() != 2:
        raise ValueError("grouped quantization supports 2D weights only")
    K, N = q.shape
    G = w["gscale"].shape[-2]
    group = K // G
    lead = x.shape[:-1]
    xf = x.float()
    if "pre_scale" in w:
        xf = xf * w["pre_scale"]
    xg_f = xf.reshape(-1, G, group)
    xg = xg_f.to(x.dtype).float()
    p = torch.einsum("bgk,gkn->bgn", xg, q.reshape(G, group, N).float())
    y = torch.einsum("bgn,gn->bn", p, w["gscale"])
    if "gbias" in w:
        y = y + torch.einsum("bg,gn->bn", xg_f.sum(-1), w["gbias"])
    return y.reshape(*lead, N).to(out_dtype or x.dtype)


def quantize_leaf(w: torch.Tensor, mode: str, group_size: int = 128,
                  reduce_absmax: Optional[Callable] = None) -> QTensor:
    """``w`` (..., K, N) quantized as ``quantize_params`` quantizes a
    projection in ``mode`` (leading axes are independent weights);
    ``reduce_absmax`` as ``quantize_tensor`` takes it (per-channel modes
    only: a group-wise scale never spans a rank's rows)."""
    if mode == "int4_awq":
        return quantize_tensor_grouped(w, group_size)
    return quantize_tensor(w, 8 if mode == "int8" else 4, reduce_absmax)


def quantize_params(params: dict[str, Any], mode: str = "int8",
                    group_size: int = 128, k_split: tuple = (),
                    reduce_absmax: Optional[Callable] = None
                    ) -> dict[str, Any]:
    """Quantize a llama parameter dict's projection weights in place of
    the raw tensors (``wq, wk, wv, wo, w_gate, w_up, w_down`` and
    ``lm_head``). ``mode``: int8 | int4 (per-channel) | int4_awq
    (group-wise). Stacked ``(L, K, N)`` weights are quantized one layer at
    a time on their own device, so the float32 transient is one layer's
    slice, never the stack (7B's stacked ``w_gate`` in float32 would be
    5.8 GB). Leaves of more than three dimensions (MoE expert stacks)
    and the MoE router stay raw.

    ``k_split``: the keys of leaves that are a tensor-parallel shard split
    along K (row-parallel); their per-channel absmax goes through
    ``reduce_absmax`` (a MAX all-reduce over the ranks), so each rank's
    scale is the whole weight's and its block equals the whole tree's
    quantized block bit for bit."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")

    def quant(key, w):
        red = reduce_absmax if key in k_split else None
        if w.dim() == 3:
            parts = [quantize_leaf(w[i], mode, group_size, red)
                     for i in range(w.shape[0])]
            return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
        return quantize_leaf(w, mode, group_size, red)

    out = dict(params)
    layers = dict(params["layers"])
    for key in _QUANT_LAYER_KEYS:
        if (key in layers and not is_quantized(layers[key])
                and quantizable(key, tuple(layers[key].shape))):
            layers[key] = quant(key, layers[key])
    out["layers"] = layers
    if "lm_head" in out and not is_quantized(out["lm_head"]):
        out["lm_head"] = quant("lm_head", out["lm_head"])
    return out
