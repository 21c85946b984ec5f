"""Tiered KV store, the single-replica half: a host-RAM page tier under
the prefix cache (the local part of the reference package's
``engine/kv_tier.py``; the cross-replica transfer waits for the fleet's
slice).

- **Offload instead of drop.** Under pool pressure the engine evicts
  refcount-0 prefix pages as before, but first gathers their KV out of
  the pool and copies it to pinned host memory off the scheduling path,
  and parks it here (``KV_HOST_POOL_TOKENS``), keyed by the chained block
  hash the prefix cache uses.
- **Priced restore.** At admission a hash chain that misses the pool but
  hits this store is copied back ahead of the prompt's chunks, when the
  step-cost model prices the restore below recomputing those tokens.
- **Suspend/resume.** The same per-block records serialize an idle
  conversation's prefix chain into a blob (``Engine.suspend_session``)
  that ``Engine.resume_session`` seeds back into the host tier.

Records hold CPU tensors in the pool's layout, one page each: ``(L, KV,
page, hd)`` for ``k``/``v`` and ``(L, KV, page)`` for the int8 pool's
``ks``/``vs`` scales. The blob format is the reference's, byte for byte:
a JSON header (hashes, per-array dtype name, shape, CRC32) then the raw
little-endian bytes. bfloat16 sections are written and read as raw 2-byte
words, so a blob moves between the two implementations in both
directions.
"""

from __future__ import annotations

import json
import sys
import threading
import zlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

#: Blob magic and version. v1 carries no checksums; v2 adds a CRC32 per
#: array section. The writer emits v2; the reader accepts both.
BLOB_MAGIC_V1 = b"GAIEKV1\n"
BLOB_MAGIC = b"GAIEKV2\n"

# The array dtypes a pool can hold, by the names numpy (and ml_dtypes'
# bfloat16) give them in a blob header.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _raw(t: torch.Tensor) -> bytes:
    """A CPU tensor's bytes in little-endian order."""
    if sys.byteorder != "little" and t.element_size() > 1:
        raise ValueError("KV-tier blobs are little-endian; this host is not")
    return t.contiguous().view(torch.uint8).numpy().tobytes()


@dataclass
class BlockRecord:
    """One cached block's KV: per pool leaf (``k``/``v``, plus
    ``ks``/``vs`` under int8 KV) the page's slice with the page axis
    removed. ``hash`` is the chained block hash
    (``prefix_cache.hash_blocks``), the content address in every tier."""

    hash: bytes
    parent: Optional[bytes]
    arrays: dict = field(default_factory=dict)   # name -> CPU tensor

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(a) for a in self.arrays.values())


class HostPageStore:
    """Bounded LRU host-RAM store of :class:`BlockRecord`, keyed by the
    chained block hash. The capacity is in bytes, so an imported blob
    with inflated shapes cannot exceed the budget. Thread-safe: the
    harvest thread writes offloads, callers' threads write resumes, the
    serve thread reads at admission."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = max(0, int(capacity_bytes))
        self._lock = threading.Lock()
        self._blocks: dict[bytes, BlockRecord] = {}   # insertion = LRU
        self._bytes = 0
        self.offload_evictions = 0   # records dropped to stay under cap

    @property
    def pages(self) -> int:
        with self._lock:
            return len(self._blocks)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def has(self, h: bytes) -> bool:
        with self._lock:
            return h in self._blocks

    def put(self, rec: BlockRecord) -> bool:
        """Insert (or refresh) one block, evicting LRU records past the
        capacity. False when the record cannot fit at all (a disabled
        store, or one record over the whole budget)."""
        size = rec.nbytes
        if self.capacity_bytes <= 0 or size > self.capacity_bytes:
            return False
        with self._lock:
            old = self._blocks.pop(rec.hash, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._blocks[rec.hash] = rec
            self._bytes += size
            while self._bytes > self.capacity_bytes:
                victim = self._blocks.pop(next(iter(self._blocks)))
                self._bytes -= victim.nbytes
                self.offload_evictions += 1
        return True

    def get(self, h: bytes) -> Optional[BlockRecord]:
        """One block, its LRU recency refreshed."""
        with self._lock:
            rec = self._blocks.pop(h, None)
            if rec is not None:
                self._blocks[h] = rec
            return rec

    def peek(self, h: bytes) -> Optional[BlockRecord]:
        """One block, recency untouched (export and suspend walks)."""
        with self._lock:
            return self._blocks.get(h)

    def pop(self, h: bytes) -> Optional[BlockRecord]:
        with self._lock:
            rec = self._blocks.pop(h, None)
            if rec is not None:
                self._bytes -= rec.nbytes
            return rec

    def match_chain(self, hashes: Sequence[bytes]) -> int:
        """Longest run of ``hashes`` from index 0 that is present: a gap
        ends every longer chain, as in the prefix cache."""
        n = 0
        with self._lock:
            for h in hashes:
                if h not in self._blocks:
                    break
                n += 1
        return n


# ---------------------------------------------------------------- wire format

def to_blob(records: Sequence[BlockRecord], meta: dict) -> bytes:
    """Serialize blocks and the geometry ``meta`` into one blob: a JSON
    header (hashes; per array its dtype name, shape and CRC32) followed by
    the arrays' raw little-endian bytes in header order."""
    header = {"meta": dict(meta), "blocks": []}
    payload = bytearray()
    for rec in records:
        arrays = {}
        for name in sorted(rec.arrays):
            arr = rec.arrays[name]
            raw = _raw(arr)
            arrays[name] = {"dtype": _NAMES[arr.dtype],
                            "shape": list(arr.shape),
                            "crc32": zlib.crc32(raw) & 0xFFFFFFFF}
            payload += raw
        header["blocks"].append({
            "hash": rec.hash.hex(),
            "parent": rec.parent.hex() if rec.parent else None,
            "arrays": arrays,
        })
    head = json.dumps(header).encode("utf-8")
    return BLOB_MAGIC + len(head).to_bytes(8, "little") + head \
        + bytes(payload)


def from_blob(blob: bytes) -> tuple[dict, list[BlockRecord]]:
    """Parse :func:`to_blob` output (v1 or v2). Raises ValueError on
    anything else: a bad magic, a truncated section, a CRC mismatch or an
    unknown dtype, so a damaged blob never reaches the pool."""
    if not (blob.startswith(BLOB_MAGIC)
            or blob.startswith(BLOB_MAGIC_V1)):
        raise ValueError("not a KV-tier blob (bad magic)")
    off = len(BLOB_MAGIC)
    head_len = int.from_bytes(blob[off:off + 8], "little")
    off += 8
    header = json.loads(blob[off:off + head_len].decode("utf-8"))
    off += head_len
    records: list[BlockRecord] = []
    for b in header["blocks"]:
        arrays: dict[str, torch.Tensor] = {}
        for name, spec in b["arrays"].items():
            dtype = _DTYPES.get(spec["dtype"])
            if dtype is None:
                raise ValueError(f"unknown KV-tier dtype {spec['dtype']!r}")
            shape = tuple(int(s) for s in spec["shape"])
            count = 1
            for s in shape:
                count *= s
            n = count * torch.empty((), dtype=dtype).element_size()
            if off + n > len(blob):
                raise ValueError("truncated KV-tier blob")
            section = blob[off:off + n]
            want = spec.get("crc32")
            if want is not None \
                    and (zlib.crc32(section) & 0xFFFFFFFF) != int(want):
                raise ValueError(
                    f"KV-tier blob CRC mismatch in block {b['hash'][:12]} "
                    f"array {name!r}: corrupt in transit or at rest")
            arrays[name] = torch.frombuffer(
                bytearray(section), dtype=dtype).reshape(shape)
            off += n
        records.append(BlockRecord(
            hash=bytes.fromhex(b["hash"]),
            parent=(bytes.fromhex(b["parent"]) if b["parent"] else None),
            arrays=arrays))
    return header["meta"], records


# ------------------------------------------------------------------- the tier

class KVTier:
    """The engine's handle: the host store, the geometry a blob must
    match to be loadable, and the stack/split helpers the device gather
    and scatter pair with."""

    def __init__(self, *, page_size: int, host_pool_tokens: int,
                 bytes_per_token: int, meta: dict,
                 transfer_max_pages: int = 32):
        self.page_size = int(page_size)
        self.host_pool_tokens = int(host_pool_tokens)
        self.meta = dict(meta)
        self.meta["page_size"] = self.page_size
        # Blocks per suspend slice (one control op each).
        self.transfer_max_pages = int(transfer_max_pages)
        # The token budget in bytes: the pool's bytes per token (int8
        # pools included).
        self.store = HostPageStore(self.host_pool_tokens
                                   * max(1, int(bytes_per_token)))

    def compatible(self, meta: dict) -> bool:
        """Whether a blob's geometry matches this engine's pools: the keys
        that decide the byte layout."""
        return all(meta.get(k) == self.meta.get(k)
                   for k in ("page_size", "kv_quant", "num_layers",
                             "num_kv_heads", "head_dim", "dtype"))

    @staticmethod
    def stack_blocks(records: Sequence[BlockRecord]) -> dict:
        """Per-block arrays back into the scatter's layout: name ->
        (L, n_blocks, ...), the page axis restored at 1."""
        names = sorted(records[0].arrays)
        return {name: torch.stack([r.arrays[name] for r in records], dim=1)
                for name in names}

    @staticmethod
    def split_pages(arrays: dict, metas: Sequence[tuple]) -> list:
        """Inverse of :meth:`stack_blocks`: a gathered (L, n, ...) result
        into per-block records. Each slice is copied, so a retained block
        never holds the whole (pinned) gather buffer."""
        return [BlockRecord(hash=h, parent=parent,
                            arrays={name: a[:, i].clone()
                                    for name, a in arrays.items()})
                for i, (h, parent) in enumerate(metas)]
