"""Office-document parsers: PPTX and DOCX, self-contained (a copy of
the reference package's ``assistant/parsers.py``).

The reference parses decks with python-pptx and PDFs with pdfplumber
(reference: experimental/multimodal_assistant/vectorstore/
custom_powerpoint_parser.py, custom_pdf_parser.py — per-slide text +
notes + image captions). Those wheels aren't assumed here: both formats
are zip archives of simple XML, so the stdlib covers extraction. Slide
images are inventoried (name + size) so a multimodal LLM endpoint can be
pointed at them; the caption itself stays an external-model boundary like
the reference's cloud NeVA calls.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
import zipfile
from dataclasses import dataclass, field

_A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"
_W = ("{http://schemas.openxmlformats.org/wordprocessingml/2006/main}")


@dataclass
class Slide:
    index: int
    text: str
    notes: str = ""
    images: list[str] = field(default_factory=list)   # archive names


def _slide_no(name: str) -> int:
    m = re.search(r"(\d+)\.xml$", name)
    return int(m.group(1)) if m else 0


def parse_pptx(path: str) -> list[Slide]:
    """Per-slide text, speaker notes, and image inventory.

    Notes and images resolve through each slide's relationship file —
    notesSlideN numbering follows notes-creation order, NOT slide order,
    so pairing by filename number attaches notes to the wrong slides."""
    slides: dict[int, Slide] = {}
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        for name in sorted(names):
            if not re.match(r"ppt/slides/slide\d+\.xml$", name):
                continue
            idx = _slide_no(name)
            root = ET.fromstring(z.read(name))
            texts = [t.text for t in root.iter(f"{_A}t") if t.text]
            slide = Slide(index=idx, text="\n".join(texts))
            slides[idx] = slide
            rel = f"ppt/slides/_rels/slide{idx}.xml.rels"
            if rel not in names:
                continue
            for node in ET.fromstring(z.read(rel)).iter():
                target = node.get("Target", "")
                rtype = node.get("Type", "")
                if rtype.endswith("/image") and "media/" in target:
                    slide.images.append(os.path.basename(target))
                elif rtype.endswith("/notesSlide"):
                    notes_name = "ppt/notesSlides/" + os.path.basename(
                        target)
                    if notes_name in names:
                        nroot = ET.fromstring(z.read(notes_name))
                        slide.notes = "\n".join(
                            t.text for t in nroot.iter(f"{_A}t")
                            if t.text and not t.text.isdigit())
    return [slides[i] for i in sorted(slides)]


def read_pptx(path: str) -> str:
    """Flatten a deck to text: slide body + speaker notes per slide (the
    shape the reference's process_ppt_file produces for chunking)."""
    parts = []
    for slide in parse_pptx(path):
        block = f"[slide {slide.index}]\n{slide.text}"
        if slide.notes:
            block += f"\n(notes: {slide.notes})"
        if slide.images:
            block += f"\n(images: {', '.join(slide.images)})"
        parts.append(block)
    return "\n\n".join(parts)


def read_docx(path: str) -> str:
    """Paragraph text from a .docx (w:p/w:t), tables included."""
    with zipfile.ZipFile(path) as z:
        root = ET.fromstring(z.read("word/document.xml"))
    paras = []
    for p in root.iter(f"{_W}p"):
        runs = [t.text for t in p.iter(f"{_W}t") if t.text]
        if runs:
            paras.append("".join(runs))
    return "\n".join(paras)


def extract_images(path: str, out_dir: str) -> list[str]:
    """Dump a deck's media files for a multimodal endpoint to consume."""
    written = []
    os.makedirs(out_dir, exist_ok=True)
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if re.match(r"ppt/media/[^/]+$", name):
                dest = os.path.join(out_dir, os.path.basename(name))
                with open(dest, "wb") as f:
                    f.write(z.read(name))
                written.append(dest)
    return written
