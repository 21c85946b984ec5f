"""The port's tokenizers (``models/sentencepiece.py``,
``models/tokenizer.py``) against the JAX package's, on the CPU.

The golden checkpoint's real 32k Llama ``tokenizer.model`` must give the
reference reader's ids and text (exactly) on every line of the repo's
docs and on unicode, emoji (byte fallback) and whitespace cases; the
reference's hand-built-vocabulary cases (``tests/test_sentencepiece.py``)
are mirrored against the port.
"""

import glob
import os
import struct
import sys

import pytest

from generativeaiexamples_tpu_torch.models.sentencepiece import \
    SentencePieceTokenizer
from generativeaiexamples_tpu_torch.models.tokenizer import (
    ByteTokenizer, HFTokenizer, get_tokenizer)
from generativeaiexamples_tpu_torch.utils.errors import ModelLoadError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_tiny")
DOCS = sorted(glob.glob(os.path.join(ROOT, "docs", "*.md")))

EDGE_CASES = [
    "", " ", "  ", "\n", "\t\tindented", "trailing   ", "  leading",
    "line one\nline two\n\n", "héllo wörld", "naïve café",
    "日本語のテキスト", "Ελληνικά", "emoji 😀🚀 and 👩‍👩‍👧", "🦙",
    "mixed\u00a0nbsp", "zero\u200bwidth", "math ∑ x² ≤ ∞",
    "<s> </s> <unk> literal", "▁metaspace▁char", "a" * 300,
]


@pytest.fixture(scope="module")
def toks():
    from generativeaiexamples_tpu.models.tokenizer import \
        get_tokenizer as jget
    return get_tokenizer(GOLDEN), jget(GOLDEN)


def _same(ours, theirs, text):
    ids = ours.encode(text)
    assert ids == theirs.encode(text), text
    assert ours.encode(text, add_bos=False) == theirs.encode(
        text, add_bos=False), text
    assert ours.decode(ids) == theirs.decode(ids), text
    return ids


def test_golden_vocab_and_special_ids(toks):
    ours, theirs = toks
    assert isinstance(ours, SentencePieceTokenizer)
    assert ours.vocab_size == theirs.vocab_size == 32000
    assert (ours.bos_id, ours.eos_id, ours.pad_id, ours.unk_id) == (
        theirs.bos_id, theirs.eos_id, theirs.pad_id, theirs.unk_id)
    assert ours.pieces == theirs.pieces


@pytest.mark.parametrize("doc", DOCS, ids=[os.path.basename(d)
                                           for d in DOCS])
def test_golden_tokenizer_matches_reference_on_docs(toks, doc):
    """Every line of one docs file: the same ids, the same decoded text,
    and the text round-trips where no character fell to <unk>."""
    ours, theirs = toks
    with open(doc, encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert lines
    for line in lines:
        ids = _same(ours, theirs, line)
        if ours.unk_id not in ids:
            assert ours.decode(ids) == line


@pytest.mark.parametrize("text", EDGE_CASES, ids=range(len(EDGE_CASES)))
def test_golden_tokenizer_matches_reference_on_edge_cases(toks, text):
    ours, theirs = toks
    _same(ours, theirs, text)
    for piece in ("▁the", "<0x0A>", "nope-not-a-piece"):
        assert ours.piece_id(piece) == theirs.piece_id(piece)


def test_byte_fallback_decodes_incrementally_like_the_reference(toks):
    """An emoji is four byte pieces: decoding any prefix of them gives
    the reference's text (replacement chars until the run completes)."""
    ours, theirs = toks
    ids = ours.encode("go 🦙 go", add_bos=False)
    assert sum(1 for i in ids if ours.pieces[i][2] == 6) == 4
    for n in range(len(ids) + 1):
        assert ours.decode(ids[:n]) == theirs.decode(ids[:n])


# ---------------------------- the reference's hand-built vocabulary cases

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _f32(field: int, value: float) -> bytes:
    return _varint(field << 3 | 5) + struct.pack("<f", value)


def _vint(field: int, value: int) -> bytes:
    return _varint(field << 3 | 0) + _varint(value)


def _piece(text: str, score: float, ptype: int = 1) -> bytes:
    body = _ld(1, text.encode()) + _f32(2, score)
    if ptype != 1:
        body += _vint(3, ptype)
    return _ld(1, body)


# Merge order (scores = -rank): hello <- hell+o <- he+ll; world likewise.
_VOCAB = [
    ("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
    ("<0xC2>", 0.0, 6), ("<0xBF>", 0.0, 6), ("<0x21>", 0.0, 6),
    ("▁", -10.0, 1),
    ("h", -20.0, 1), ("e", -20.0, 1), ("l", -20.0, 1), ("o", -20.0, 1),
    ("w", -20.0, 1), ("r", -20.0, 1), ("d", -20.0, 1),
    ("ll", -1.0, 1), ("he", -2.0, 1), ("hell", -3.0, 1),
    ("hello", -4.0, 1), ("▁hello", -5.0, 1),
    ("ld", -6.0, 1), ("rld", -7.0, 1), ("orld", -8.0, 1),
    ("world", -9.0, 1), ("▁world", -9.5, 1),
]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    blob = b"".join(_piece(t, s, p) for t, s, p in _VOCAB)
    # unk/bos/eos, and pad = -1 (a 10-byte negative varint)
    trainer = (_vint(40, 0) + _vint(41, 1) + _vint(42, 2)
               + _vint(43, (1 << 64) - 1))
    blob += _ld(2, trainer)
    path = os.path.join(tmp_path_factory.mktemp("spm"), "tokenizer.model")
    with open(path, "wb") as f:
        f.write(blob)
    return path


def _pid(text: str) -> int:
    return next(i for i, (t, _, _) in enumerate(_VOCAB) if t == text)


def test_loads_vocab_and_special_ids(model_path):
    tok = SentencePieceTokenizer(model_path)
    assert tok.vocab_size == len(_VOCAB)
    assert (tok.unk_id, tok.bos_id, tok.eos_id) == (0, 1, 2)
    assert tok.pad_id == tok.eos_id       # pad_id -1 falls back to eos


def test_bpe_merges_follow_scores(model_path):
    tok = SentencePieceTokenizer(model_path)
    assert tok.encode("hello world", add_bos=False) == [
        _pid("▁hello"), _pid("▁world")]
    assert tok.encode("hello", add_bos=True)[0] == tok.bos_id


def test_byte_fallback_and_roundtrip(model_path):
    tok = SentencePieceTokenizer(model_path)
    ids = tok.encode("¿", add_bos=False)   # U+00BF = 0xC2 0xBF
    assert ids == [_pid("▁"), _pid("<0xC2>"), _pid("<0xBF>")]
    assert tok.decode(ids) == "¿"


def test_decode_metaspace_and_controls(model_path):
    tok = SentencePieceTokenizer(model_path)
    assert tok.decode(tok.encode("hello world")) == "hello world"
    assert tok.decode([tok.eos_id]) == ""


def test_unknown_piece_falls_back_per_byte(model_path):
    tok = SentencePieceTokenizer(model_path)
    ids = tok.encode("!", add_bos=False)
    assert _pid("<0x21>") in ids
    assert tok.decode(ids) == "!"
    # A character with no byte piece: <unk>, which decodes to nothing.
    assert tok.encode("z", add_bos=False)[-1] == tok.unk_id


def test_get_tokenizer_resolves_model_file(model_path):
    tok = get_tokenizer(model_path)
    assert isinstance(tok, SentencePieceTokenizer)
    tok2 = get_tokenizer(os.path.dirname(model_path))
    assert isinstance(tok2, SentencePieceTokenizer)
    assert tok2.encode("hello", add_bos=False) == tok.encode(
        "hello", add_bos=False)
    assert isinstance(get_tokenizer("byte"), ByteTokenizer)


def test_synthetic_vocab_matches_reference(model_path):
    from generativeaiexamples_tpu.models.sentencepiece import \
        SentencePieceTokenizer as JSP
    ours, theirs = SentencePieceTokenizer(model_path), JSP(model_path)
    for text in ("hello world", "¿hello!", "world hello world", "", " "):
        assert ours.encode(text) == theirs.encode(text)
        assert ours.decode(ours.encode(text)) == theirs.decode(
            theirs.encode(text))
    assert ours.pad_id == theirs.pad_id


# ------------------------------------------------------- tokenizer.json

@pytest.fixture(scope="module")
def json_dir(tmp_path_factory):
    tokenizers = pytest.importorskip("tokenizers")
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, "hello": 3, "world": 4,
             "!": 5}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        vocab, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.decoder = tokenizers.decoders.WordPiece(prefix="##")
    d = tmp_path_factory.mktemp("hf_tok")
    tok.save(str(d / "tokenizer.json"))
    return str(d)


def test_tokenizer_json_matches_reference(json_dir):
    from generativeaiexamples_tpu.models.tokenizer import \
        get_tokenizer as jget
    ours, theirs = get_tokenizer(json_dir), jget(json_dir)
    assert isinstance(ours, HFTokenizer)
    assert (ours.bos_id, ours.eos_id, ours.pad_id, ours.vocab_size) == (
        theirs.bos_id, theirs.eos_id, theirs.pad_id, theirs.vocab_size)
    for text in ("hello world !", "world unknownword hello"):
        assert ours.encode(text) == theirs.encode(text)
        assert ours.decode(ours.encode(text)) == theirs.decode(
            theirs.encode(text))
    assert ours.piece_id("world") == 4 and ours.piece_id("zzz") is None
    # A tokenizer.model beside it wins, as Llama-2 releases ship both.
    assert isinstance(get_tokenizer(GOLDEN), SentencePieceTokenizer)


def test_tokenizer_json_without_the_package_raises(json_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ModelLoadError, match="'tokenizers' package"):
        get_tokenizer(json_dir)


def test_missing_vocabulary_raises(tmp_path):
    with pytest.raises(ModelLoadError, match="neither"):
        get_tokenizer(str(tmp_path))
    with pytest.raises(ModelLoadError, match="no such file"):
        get_tokenizer(str(tmp_path / "tokenizer.json"))
