"""Tokenizers for the port: the self-contained byte tokenizer.

A copy of ``ByteTokenizer`` from the reference package's
``models/tokenizer.py`` — no vocab files, so the port serves hermetically
with random weights. Checkpoint tokenizers (sentencepiece, HF
``tokenizer.json``) wait until real weights are served.
"""

from __future__ import annotations

from typing import Protocol, Sequence


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    pad_id: int

    @property
    def vocab_size(self) -> int: ...
    def encode(self, text: str, *, add_bos: bool = True) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def piece_id(self, piece: str) -> "int | None": ...


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..2 = pad/bos/eos, 3..258 = bytes.

    Id conventions follow the Llama sentencepiece family (pad=0, bos=1,
    eos=2)."""

    pad_id, bos_id, eos_id = 0, 1, 2
    _OFFSET = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self._OFFSET

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        ids = [b + self._OFFSET for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - self._OFFSET for i in ids
                     if i >= self._OFFSET and i < self._OFFSET + 256)
        return data.decode("utf-8", errors="replace")

    def piece_id(self, piece: str) -> "int | None":
        data = piece.encode("utf-8")
        return data[0] + self._OFFSET if len(data) == 1 else None


def get_tokenizer(spec: str = "byte") -> Tokenizer:
    """Factory: only ``"byte"`` in this slice."""
    if spec == "byte":
        return ByteTokenizer()
    raise ValueError(
        f"tokenizer {spec!r} is not available in the port yet; use 'byte'")
