"""RMSNorm (port of the reference's ``ops/rmsnorm.py``; XLA fused it on
the TPU, so it is plain PyTorch here too)."""

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
