"""Self-contained SentencePiece ``tokenizer.model`` loader and BPE encoder
(a copy of the reference package's ``models/sentencepiece.py``; the port
imports nothing from it, and needs no ``sentencepiece`` wheel).

Real Llama-2 checkpoints ship their vocabulary as a serialized
``sentencepiece.ModelProto`` (``tokenizer.model``). Both halves are
implemented here:

- a minimal protobuf wire-format reader for the fields the tokenizer
  needs: ``ModelProto.pieces`` (field 1: piece/score/type) and the
  special-token ids from ``TrainerSpec`` (field 2: unk/bos/eos/pad ids,
  fields 40-43);
- the SentencePiece BPE encoding algorithm: normalize spaces to the
  U+2581 metaspace (with the dummy-prefix rule), seed with per-character
  symbols, then repeatedly merge the adjacent pair whose concatenation is
  the highest-scoring vocab piece (scores encode merge rank in BPE
  models), with UTF-8 byte-fallback pieces (``<0xNN>``) for anything
  outside the vocab.

Decoding handles the metaspace and reassembles byte-fallback runs.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional, Sequence

_METASPACE = "▁"

# ModelProto.SentencePiece.type values (sentencepiece_model.proto)
_TYPE_NORMAL = 1
_TYPE_UNKNOWN = 2
_TYPE_CONTROL = 3
_TYPE_USER_DEFINED = 4
_TYPE_BYTE = 6


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:        # varint
            value, i = _varint(buf, i)
        elif wire == 1:      # fixed64
            value = buf[i:i + 8]
            i += 8
        elif wire == 2:      # length-delimited
            ln, i = _varint(buf, i)
            value = buf[i:i + ln]
            i += ln
        elif wire == 5:      # fixed32
            value = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _parse_piece(buf: bytes) -> tuple[str, float, int]:
    piece, score, ptype = "", 0.0, _TYPE_NORMAL
    for field, wire, value in _fields(buf):
        if field == 1 and wire == 2:
            piece = value.decode("utf-8")
        elif field == 2 and wire == 5:
            score = struct.unpack("<f", value)[0]
        elif field == 3 and wire == 0:
            ptype = int(value)
    return piece, score, ptype


def _parse_trainer_ids(buf: bytes) -> dict[str, int]:
    # TrainerSpec: unk_id=40, bos_id=41, eos_id=42, pad_id=43
    names = {40: "unk", 41: "bos", 42: "eos", 43: "pad"}
    out: dict[str, int] = {}
    for field, wire, value in _fields(buf):
        if field in names and wire == 0:
            # ids are int32, but protobuf serializes negatives (pad_id=-1)
            # as 64-bit varints: mask to 32 bits before sign-adjusting
            v = int(value) & 0xFFFFFFFF
            if v >= 1 << 31:
                v -= 1 << 32
            out[names[field]] = v
    return out


class SentencePieceTokenizer:
    """Llama-family ``tokenizer.model`` (BPE + byte fallback)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.model")
        with open(path, "rb") as f:
            blob = f.read()
        self.pieces: list[tuple[str, float, int]] = []
        ids = {"unk": 0, "bos": 1, "eos": 2, "pad": -1}
        for field, wire, value in _fields(blob):
            if field == 1 and wire == 2:
                self.pieces.append(_parse_piece(value))
            elif field == 2 and wire == 2:
                ids.update(_parse_trainer_ids(value))
        if not self.pieces:
            raise ValueError(f"{path}: no sentencepiece vocabulary found")
        self._vocab: dict[str, int] = {}
        self._bytes: dict[int, int] = {}    # byte value -> piece id
        for idx, (piece, _, ptype) in enumerate(self.pieces):
            if ptype == _TYPE_BYTE:
                self._bytes[int(piece[1:-1], 16)] = idx   # "<0xNN>"
            if piece not in self._vocab:
                self._vocab[piece] = idx
        self.unk_id = ids["unk"]
        self.bos_id = ids["bos"]
        self.eos_id = ids["eos"]
        self.pad_id = ids["pad"] if ids["pad"] >= 0 else ids["eos"]

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx][0]

    def piece_id(self, piece: str) -> Optional[int]:
        return self._vocab.get(piece)

    # ------------------------------------------------------------- encode

    def _byte_fallback(self, text: str) -> list[int]:
        out = []
        for b in text.encode("utf-8"):
            out.append(self._bytes.get(b, self.unk_id))
        return out if self._bytes else [self.unk_id]

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        import heapq

        norm = _METASPACE + text.replace(" ", _METASPACE)  # dummy prefix
        # Seed with one symbol per character, then best-score-first merges
        # (the BPE half of sentencepiece: scores are -merge_rank, so max
        # score == earliest learned merge). Heap + doubly-linked symbol
        # list keeps long prompts O(n log n) — a rescan-all loop would put
        # seconds of Python on the TTFT-critical prefill path.
        n = len(norm)
        sym: list[Optional[str]] = list(norm)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(n - 1))
        heap: list[tuple[float, int, int, str]] = []
        tie = 0

        def push(i: int) -> None:
            nonlocal tie
            if i < 0:
                return
            j = nxt[i]
            if j < 0 or sym[i] is None or sym[j] is None:
                return
            merged = sym[i] + sym[j]           # type: ignore[operator]
            idx = self._vocab.get(merged)
            if idx is not None:
                tie += 1
                heapq.heappush(heap,
                               (-self.pieces[idx][1], i, tie, merged))

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, _, merged = heapq.heappop(heap)
            j = nxt[i]
            if (sym[i] is None or j < 0 or sym[j] is None
                    or sym[i] + sym[j] != merged):
                continue                        # stale entry
            sym[i] = merged
            sym[j] = None
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            push(prv[i])
            push(i)

        out: list[int] = [self.bos_id] if add_bos else []
        i = 0
        while i >= 0:
            s = sym[i]
            if s is not None:
                idx = self._vocab.get(s)
                if idx is not None and self.pieces[idx][2] != _TYPE_UNKNOWN:
                    out.append(idx)
                else:
                    out.extend(self._byte_fallback(s))
            i = nxt[i]
        return out

    # ------------------------------------------------------------- decode

    def decode(self, ids: Sequence[int]) -> str:
        parts: list[str] = []
        byte_run: list[int] = []

        def flush_bytes() -> None:
            if byte_run:
                parts.append(bytes(byte_run).decode("utf-8",
                                                    errors="replace"))
                byte_run.clear()

        for idx in ids:
            if idx < 0 or idx >= len(self.pieces):
                continue
            piece, _, ptype = self.pieces[idx]
            if ptype == _TYPE_BYTE:
                byte_run.append(int(piece[1:-1], 16))
                continue
            flush_bytes()
            if ptype in (_TYPE_CONTROL, _TYPE_UNKNOWN):
                continue
            parts.append(piece.replace(_METASPACE, " "))
        flush_bytes()
        text = "".join(parts)
        return text[1:] if text.startswith(" ") else text
