"""Document readers: file → plain text (a copy of the reference package's
``chains/readers.py``; the pptx/docx parsers are not ported yet).

The reference leans on LlamaIndex's PDFReader/UnstructuredReader
(reference: examples/developer_rag/chains.py:58-66). First-party readers
here: text/markdown/HTML natively, PDF via a minimal built-in extractor
(gated on pypdf if present, else a best-effort stream scanner), with a
registry keyed by extension so examples stay format-agnostic.
"""

from __future__ import annotations

import os
import re
import zlib

from ..utils.errors import ChainError


def read_text(path: str) -> str:
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


def read_html(path: str) -> str:
    from bs4 import BeautifulSoup
    with open(path, encoding="utf-8", errors="replace") as f:
        soup = BeautifulSoup(f.read(), "html.parser")
    for tag in soup(["script", "style"]):
        tag.decompose()
    return re.sub(r"\n{3,}", "\n\n", soup.get_text("\n")).strip()


_PDF_TEXT_RE = re.compile(rb"\(((?:[^()\\]|\\.)*)\)\s*Tj")
_PDF_TJ_ARRAY_RE = re.compile(rb"\[((?:[^\]\\]|\\.)*)\]\s*TJ")


def _pdf_unescape(raw: bytes) -> str:
    out = raw.replace(rb"\(", b"(").replace(rb"\)", b")")
    out = out.replace(rb"\n", b"\n").replace(rb"\r", b"").replace(rb"\\", b"\\")
    return out.decode("latin-1", errors="replace")


def read_pdf(path: str) -> str:
    """PDF text extraction. Prefers pypdf when installed; otherwise a
    self-contained extractor: inflate FlateDecode streams and pull text
    from Tj/TJ show-text operators (covers the common unencrypted,
    simple-encoding case — the reference's eval corpus included)."""
    try:
        from pypdf import PdfReader  # optional
        return "\n".join(page.extract_text() or ""
                         for page in PdfReader(path).pages)
    except ImportError:
        pass
    with open(path, "rb") as f:
        data = f.read()
    pieces: list[str] = []
    for m in re.finditer(rb"stream\r?\n(.*?)endstream", data, re.DOTALL):
        blob = m.group(1)
        try:
            blob = zlib.decompress(blob)
        except zlib.error:
            pass
        for tm in _PDF_TEXT_RE.finditer(blob):
            pieces.append(_pdf_unescape(tm.group(1)))
        for am in _PDF_TJ_ARRAY_RE.finditer(blob):
            strs = re.findall(rb"\(((?:[^()\\]|\\.)*)\)", am.group(1))
            pieces.append("".join(_pdf_unescape(s) for s in strs))
    text = " ".join(p for p in pieces if p.strip())
    return re.sub(r"\s+", " ", text).strip()


def _read_pptx(path: str) -> str:
    raise ChainError("pptx documents need the assistant parsers, which "
                     "this package does not port yet (ROADMAP A17)")


def _read_docx(path: str) -> str:
    raise ChainError("docx documents need the assistant parsers, which "
                     "this package does not port yet (ROADMAP A17)")


_READERS = {
    ".txt": read_text, ".md": read_text, ".rst": read_text, ".py": read_text,
    ".json": read_text, ".csv": read_text, ".yaml": read_text, ".yml": read_text,
    ".html": read_html, ".htm": read_html,
    ".pdf": read_pdf,
    ".pptx": _read_pptx, ".docx": _read_docx,
}


def read_document(path: str) -> str:
    """Dispatch by extension; raises ChainError for unsupported types."""
    ext = os.path.splitext(path)[1].lower()
    reader = _READERS.get(ext)
    if reader is None:
        raise ChainError(
            f"unsupported document type {ext!r} "
            f"(supported: {sorted(_READERS)})")
    return reader(path)
