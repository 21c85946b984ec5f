"""RMSNorm and NeMo's layernorm1p (port of the reference's
``ops/rmsnorm.py``; XLA fused both on the TPU, so they are plain PyTorch
here too)."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * weight: variance in float32, scale applied in the
    input dtype (HF LlamaRMSNorm semantics)."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.to(dtype) * weight.to(dtype)


def layernorm1p(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """NeMo's zero-centred LayerNorm (the GPT-Next/Nemotron blocks):
    ``y = (1 + w) * (x - mean) / sqrt(var + eps) + b``, statistics and
    the affine step in float32, the result in the input dtype (the
    reference's ``layernorm1p``)."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * (1.0 + weight.float()) + bias.float()
    return y.to(dtype)
