"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

from .errors import ConfigError


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises instead of falling back when CUDA is asked for and
    absent, so a run never reports CPU numbers as device numbers."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ConfigError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
