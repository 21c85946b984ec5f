"""Multimodal assistant: office-document RAG with memory and guardrails
(a port of the reference package's ``assistant`` package). It is a
``BaseExample``: the chain server and web frontend serve it
(``--example generativeaiexamples_tpu_torch.assistant.assistant``), and
its pieces are importable:

  parsers.py     self-contained PPTX/DOCX extraction (zip + XML, no
                 python-pptx/docx wheels needed) incl. slide notes and
                 an image inventory per slide
  memory.py      bounded conversation memory folded into the prompt
  guardrails.py  LLM fact-check of answers against retrieved evidence
  feedback.py    JSONL feedback capture
  assistant.py   the MultimodalAssistant example class
"""

from .assistant import MultimodalAssistant
from .feedback import FeedbackStore
from .guardrails import fact_check
from .memory import ConversationMemory
from .parsers import read_docx, read_pptx

__all__ = ["MultimodalAssistant", "ConversationMemory", "fact_check",
           "FeedbackStore", "read_pptx", "read_docx"]
