"""Peak device-memory bandwidth of the card the engine runs on: the
denominator of the round recorder's ``bw_util`` (obs/rounds.py).

Public spec numbers by card name, as ``torch.cuda.get_device_name``
reports it. Unknown cards and the CPU have no peak (0.0), and
``bw_util`` then stays 0."""

from __future__ import annotations

import torch

# (substrings all in the card's name, bytes/s), first match wins.
PEAK_HBM_BW: tuple[tuple[tuple[str, ...], float], ...] = (
    (("H100", "PCIE"), 2.0e12),     # H100 PCIe, HBM2e
    (("H100", "SXM"), 3.35e12),     # H100 SXM5, HBM3
    (("H100", "HBM3"), 3.35e12),    # "NVIDIA H100 80GB HBM3" is the SXM5
)


def peak_bw(device) -> float:
    """Peak device-memory bytes/s of ``device`` (a ``torch.device`` or a
    name), 0.0 on the CPU or a card the table does not know."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(dev).upper()
    for keys, bw in PEAK_HBM_BW:
        if all(k in name for k in keys):
            return bw
    return 0.0
