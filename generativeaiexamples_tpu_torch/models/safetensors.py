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

``iter_stored`` hands out ``StoredTensor``s instead: a block
(``t[a:b, c:d]``) is read with ``os.preadv`` into a tensor of its own,
one read per contiguous run, and no page of the file joins the process.
A tensor-parallel rank reads its blocks this way. Through a memory map
each row's span of a row-parallel weight would fault in the pages
around it (the kernel maps a 64 KiB window around a fault), so the
whole weight's pages would count as the rank's memory.

``save_file`` writes one file; ``save_sharded`` splits a state dict over
several files beside a ``model.safetensors.index.json``, as HF releases
ship large checkpoints.
"""

from __future__ import annotations

import itertools
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


def _entries(path: str) -> Iterator[tuple[str, torch.dtype, tuple, int]]:
    """``(name, dtype, shape, absolute byte offset)`` of every tensor of
    one file, in the order of their bytes, each checked against the
    header's byte count."""
    header, base = read_header(path)
    for name, info in sorted(header.items(),
                             key=lambda kv: kv[1]["data_offsets"][0]):
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ModelLoadError(f"{path}: tensor {name!r} has dtype "
                                 f"{info['dtype']}, which is not read")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end - start != dtype.itemsize * int(np.prod(shape,
                                                       dtype=np.int64)):
            raise ModelLoadError(f"{path}: tensor {name!r} has "
                                 f"{end - start} bytes for shape {shape}")
        if base + end > os.path.getsize(path):
            raise ModelLoadError(f"{path}: tensor {name!r} runs past the "
                                 f"end of the file")
        yield name, dtype, shape, base + start


def iter_file(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` for every tensor of one file, in the
    order of their bytes. Each tensor views the file's memory map (a
    copy when its offset is misaligned); F32, F16, BF16, I8, I32 and I64
    are read."""
    mm = None
    for name, dtype, shape, at in _entries(path):
        if mm is None:
            mm = np.memmap(path, dtype=np.uint8, mode="c")
        raw = mm[at:at + dtype.itemsize * int(np.prod(shape,
                                                      dtype=np.int64))]
        if at % dtype.itemsize:
            raw = np.array(raw)        # a fresh, aligned buffer
        yield name, torch.from_numpy(raw).view(dtype).reshape(shape)


class StoredTensor:
    """One tensor of a safetensors file, read when it is indexed: ``t[idx]``
    (slices of step 1, one per leading axis) reads that block into a new
    contiguous host tensor; ``read()`` the whole tensor."""

    def __init__(self, path: str, offset: int, shape: tuple,
                 dtype: torch.dtype):
        self.path, self.offset, self.dtype = path, offset, dtype
        self.shape = torch.Size(shape)

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def read(self) -> torch.Tensor:
        return self[()]

    def __getitem__(self, idx) -> torch.Tensor:
        idx = idx if isinstance(idx, tuple) else (idx,)
        if len(idx) > self.dim():
            raise IndexError(f"{len(idx)} indices for a {self.dim()}-d "
                             f"tensor")
        ranges = []
        for s, n in zip(idx + (slice(None),) * (self.dim() - len(idx)),
                        self.shape):
            if not isinstance(s, slice):
                raise TypeError(f"a stored tensor is indexed by slices, "
                                f"not {s!r}")
            a, b, step = s.indices(n)
            if step != 1:
                raise ValueError("a stored tensor's slices have step 1")
            ranges.append((a, max(a, b)))
        out = torch.empty([b - a for a, b in ranges], dtype=self.dtype)
        if out.numel() == 0:
            return out
        # Axes past ``j`` are whole, so each index of the axes before it
        # names one contiguous run of the file.
        j = self.dim() - 1
        while j > 0 and ranges[j] == (0, self.shape[j]):
            j -= 1
        size = self.dtype.itemsize
        strides = [int(np.prod(self.shape[i + 1:], dtype=np.int64))
                   for i in range(self.dim())]
        run = ((ranges[j][1] - ranges[j][0]) * strides[j] * size
               if self.dim() else size)
        buf = memoryview(out.reshape(-1).view(torch.uint8).numpy())
        at = 0
        with open(self.path, "rb", buffering=0) as f:
            for outer in itertools.product(*(range(a, b)
                                             for a, b in ranges[:j])):
                elem = sum(i * st for i, st in zip(outer, strides))
                if self.dim():
                    elem += ranges[j][0] * strides[j]
                _read_at(f.fileno(), buf[at:at + run],
                         self.offset + elem * size, self.path)
                at += run
        return out


def _read_at(fd: int, dst: memoryview, offset: int, path: str) -> None:
    """Fill ``dst`` from the file's bytes at ``offset``."""
    done = 0
    while done < len(dst):
        n = os.preadv(fd, [dst[done:]], offset + done)
        if n <= 0:
            raise ModelLoadError(f"{path}: short read at byte "
                                 f"{offset + done}")
        done += n


def iter_stored(path: str) -> Iterator[tuple[str, StoredTensor]]:
    """``iter_file``'s tensors as ``StoredTensor``s: nothing is read, or
    mapped, until a block is asked for."""
    for name, dtype, shape, at in _entries(path):
        yield name, StoredTensor(path, at, shape, dtype)


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
