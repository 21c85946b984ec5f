"""A reader and a writer of the safetensors format, on numpy and torch only.

The reference reads checkpoints through the ``safetensors`` wheel; the
port keeps its own copy of the format so that it needs no package beyond
torch and numpy. A file is an 8-byte little-endian header length, a JSON
header mapping each tensor name to ``{"dtype", "shape", "data_offsets"}``
(offsets relative to the end of the header) plus an optional
``"__metadata__"`` of strings, then the raw little-endian bytes.

``iter_file`` memory-maps the file copy-on-write and hands out tensors
that view the mapping: nothing is read until a tensor's bytes are used,
so a 7B checkpoint is never read whole into host memory. A tensor whose
byte offset is not a multiple of its element size is copied into an
aligned buffer first (the format does not promise alignment).

``save_file`` writes one file; ``save_sharded`` splits a state dict over
several files beside a ``model.safetensors.index.json``, as HF releases
ship large checkpoints.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator, Mapping, Optional

import numpy as np
import torch

from ..utils.errors import ModelLoadError

_DTYPES: dict[str, torch.dtype] = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "I32": torch.int32, "I64": torch.int64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}

INDEX_NAME = "model.safetensors.index.json"


def read_header(path: str) -> tuple[dict, int]:
    """(the JSON header without ``__metadata__``, the byte offset where
    the tensor data starts)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ModelLoadError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        if n > os.path.getsize(path) - 8:
            raise ModelLoadError(f"{path}: header length {n} runs past the "
                                 f"end of the file")
        try:
            header = json.loads(f.read(n))
        except ValueError as exc:
            raise ModelLoadError(f"{path}: unreadable header: {exc}") from exc
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_file(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` for every tensor of one file, in the
    order of their bytes. Each tensor views the file's memory map (a
    copy when its offset is misaligned); F32, F16, BF16, I8, I32 and I64
    are read."""
    header, base = read_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode="c") \
        if os.path.getsize(path) > base else np.zeros((0,), np.uint8)
    for name, info in sorted(header.items(),
                             key=lambda kv: kv[1]["data_offsets"][0]):
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ModelLoadError(f"{path}: tensor {name!r} has dtype "
                                 f"{info['dtype']}, which is not read")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        size = dtype.itemsize
        if end - start != size * int(np.prod(shape, dtype=np.int64)):
            raise ModelLoadError(f"{path}: tensor {name!r} has "
                                 f"{end - start} bytes for shape {shape}")
        raw = mm[base + start:base + end]
        if (base + start) % size:
            raw = np.array(raw)        # a fresh, aligned buffer
        yield name, torch.from_numpy(raw).view(dtype).reshape(shape)


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one file, as ``iter_file`` gives them."""
    return dict(iter_file(path))


def _write(path: str, tensors: Mapping[str, torch.Tensor],
           metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write one file; tensors may live on any device and are copied to
    the host one at a time. Returns the bytes of tensor data written."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    at = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not "
                             f"written")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + n]}
        at += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)     # keep the data 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            host = t.detach().to("cpu").contiguous().reshape(-1)
            f.write(host.view(torch.uint8).numpy().tobytes())
    return at


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` to one safetensors file."""
    _write(path, tensors, metadata)


def save_sharded(tensors: Mapping[str, torch.Tensor], directory: str,
                 shards: int = 2, prefix: str = "model") -> list[str]:
    """Write ``tensors`` over ``shards`` files
    ``{prefix}-0000i-of-0000n.safetensors`` in ``directory``, in order,
    each taking about an equal share of the bytes, plus the
    ``model.safetensors.index.json`` that maps each name to its file.
    Returns the file names."""
    os.makedirs(directory, exist_ok=True)
    items = list(tensors.items())
    total = sum(t.numel() * t.element_size() for _, t in items)
    groups: list[list[tuple[str, torch.Tensor]]] = [[] for _ in range(shards)]
    at = 0
    for name, t in items:
        groups[min(shards - 1, at * shards // max(total, 1))].append((name, t))
        at += t.numel() * t.element_size()
    names, weight_map = [], {}
    for i, group in enumerate(groups):
        fname = f"{prefix}-{i + 1:05d}-of-{shards:05d}.safetensors"
        _write(os.path.join(directory, fname), dict(group),
               {"format": "pt"})
        names.append(fname)
        weight_map.update({name: fname for name, _ in group})
    with open(os.path.join(directory, INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return names


def tensor_names(path: str) -> list[str]:
    """The tensor names of one file, from its header alone."""
    return list(read_header(path)[0])
