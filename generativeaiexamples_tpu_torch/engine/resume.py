"""Resume continuation context (a copy of the reference package's
``engine/resume.py``): how a mid-stream resume reaches ``Engine.submit``
without a parameter through every chain.

On a mid-stream replica loss a router re-submits the request to a
sibling with the generated-so-far text attached. The chain server
tokenizes that text and binds the ids here; the bound block rides the
request's copied context into ``Engine.submit``, which admits the request
as ``prompt + replayed ids``: the replayed ids are prompt from then on
(the prefix cache and the host KV tier make them cheap, the repetition
penalty's seen mask covers them), and the stream carries only new text.
"""

from __future__ import annotations

import contextvars
from typing import Optional

#: ``{"ids": [int, ...], "attempt": int}``: the replayed generated-so-far
#: token ids (no BOS; they follow the prompt) and the resume attempt's
#: ordinal (observability only).
_RESUME: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "engine_resume_block", default=None)


def bind_resume(block: dict) -> contextvars.Token:
    """Bind a resume block for the current context; returns the token
    for ``unbind_resume``."""
    return _RESUME.set(dict(block))


def unbind_resume(token: contextvars.Token) -> None:
    _RESUME.reset(token)


def current_resume() -> Optional[dict]:
    """The bound resume block, or None for an ordinary request."""
    return _RESUME.get()
