"""LLM fact-check guardrail (a copy of the reference package's
``assistant/guardrails.py``).

Parity with the reference's assistant guardrail (reference:
experimental/multimodal_assistant/guardrails/fact_check.py:23-33 — an LLM
verifies the response against the retrieved context only, prefixing the
verdict TRUE/FALSE). Same contract, parseable result."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

FACT_CHECK_PROMPT = (
    "Your task is to fact-check a response from a language model. You are "
    "given context documents as [[CONTEXT]], the user's question as "
    "[[QUESTION]], and the model's response as [[RESPONSE]]. Verify each "
    "claim of the response strictly against the context — use no outside "
    "knowledge. Begin your reply with VERDICT: TRUE if the response is "
    "fully supported by the context, or VERDICT: FALSE otherwise, then "
    "one sentence of justification.\n\n"
    "[[CONTEXT]]\n{evidence}\n\n"
    "[[QUESTION]]\n{query}\n\n"
    "[[RESPONSE]]\n{response}\n"
)

_VERDICT = re.compile(r"VERDICT:\s*(TRUE|FALSE)", re.IGNORECASE)


@dataclass
class FactCheck:
    supported: Optional[bool]       # None = verdict unparseable
    explanation: str


def fact_check(llm, evidence: str, query: str, response: str) -> FactCheck:
    text = llm.complete(
        FACT_CHECK_PROMPT.format(evidence=evidence, query=query,
                                 response=response),
        max_tokens=150, temperature=0.2, top_k=4)
    m = _VERDICT.search(text)
    supported = None if m is None else m.group(1).upper() == "TRUE"
    explanation = _VERDICT.sub("", text, count=1).strip()
    return FactCheck(supported=supported, explanation=explanation)
