"""Projections over raw weights — the raw-weight half of the reference's
``ops/quant.py`` (``matmul`` / ``matmul_f32``). The int8 and int4 weight
branches wait for a later slice; a weight here is always a tensor stored
input-major, ``(..., K, N)``, so the forward is ``x @ w``."""

from __future__ import annotations

import torch


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the operands' dtype."""
    return torch.matmul(x, w)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with a float32 result — the logits path. Like the
    reference, compact operands stay compact: on the card a bf16 ``x`` and
    2-D ``w`` go through one cuBLAS bf16 GEMM with f32 accumulation and an
    f32 output (``torch.mm(..., out_dtype=)``, which has no CPU backend),
    so the lm_head is never copied to f32. Elsewhere the operands are
    widened, which gives the same arithmetic (bf16 values are exact in
    f32; float32 matmuls run in full precision, TF32 off by default)."""
    if (x.is_cuda and w.dim() == 2 and x.dtype == torch.bfloat16
            and w.dtype == torch.bfloat16):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())
