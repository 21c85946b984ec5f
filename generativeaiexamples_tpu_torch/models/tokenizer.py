"""Tokenizers for the port (copied from the reference package's
``models/tokenizer.py``).

``ByteTokenizer`` needs no vocab files, so the port serves hermetically
with random weights. A checkpoint directory brings its own vocabulary:
``tokenizer.model`` is read by the self-contained sentencepiece reader
(``models/sentencepiece.py``), ``tokenizer.json`` by ``HFTokenizer``,
which imports the ``tokenizers`` package only when it is asked for one.
"""

from __future__ import annotations

import os
from typing import Protocol, Sequence

from ..utils.errors import ModelLoadError


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


class HFTokenizer:
    """Wraps a ``tokenizers.Tokenizer`` loaded from tokenizer.json. The
    ``tokenizers`` package is imported here, not with the module, and
    its absence raises ``ModelLoadError``."""

    def __init__(self, path: str):
        try:
            from tokenizers import Tokenizer as _Tok
        except ImportError as exc:
            raise ModelLoadError(
                f"{path}: a tokenizer.json needs the 'tokenizers' package, "
                f"which is not installed (a tokenizer.model beside it is "
                f"read without it)") from exc
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        self._tok = _Tok.from_file(path)
        self.pad_id = self._special_id(("<pad>", "[PAD]", "<unk>"), 0)
        self.bos_id = self._special_id(("<s>", "[CLS]", "<|begin_of_text|>"), 1)
        self.eos_id = self._special_id(("</s>", "[SEP]", "<|end_of_text|>"), 2)

    def _special_id(self, candidates: tuple[str, ...], default: int) -> int:
        for tok in candidates:
            tid = self._tok.token_to_id(tok)
            if tid is not None:
                return tid
        return default

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str, *, add_bos: bool = True) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def piece_id(self, piece: str) -> "int | None":
        return self._tok.token_to_id(piece)


def get_tokenizer(spec: str = "byte") -> Tokenizer:
    """Factory: ``"byte"``, or a checkpoint directory or tokenizer file.

    A directory resolves in the order Llama-2 releases ship them:
    ``tokenizer.model`` (sentencepiece), then ``tokenizer.json``."""
    if spec == "byte":
        return ByteTokenizer()
    from .sentencepiece import SentencePieceTokenizer
    if os.path.isdir(spec):
        sp = os.path.join(spec, "tokenizer.model")
        if os.path.isfile(sp):
            return SentencePieceTokenizer(sp)
        if not os.path.isfile(os.path.join(spec, "tokenizer.json")):
            raise ModelLoadError(f"{spec} holds neither tokenizer.model nor "
                                 f"tokenizer.json")
        return HFTokenizer(spec)
    if spec.endswith(".model"):
        return SentencePieceTokenizer(spec)
    if not os.path.isfile(spec):
        raise ModelLoadError(f"tokenizer {spec!r}: no such file or "
                             f"directory (or use 'byte')")
    return HFTokenizer(spec)
