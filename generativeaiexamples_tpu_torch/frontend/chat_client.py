"""HTTP client for the chain server, over ``urllib.request`` (a port of the
reference package's ``frontend/chat_client.py``, which uses ``requests``).

``search`` (``/documentSearch``), streaming ``predict`` (``/generate``:
16-byte reads, then a ``None`` sentinel) and ``upload_documents``
(``/uploadDocument``, a multipart body built here). Outgoing requests
carry W3C trace context plus an ``X-Request-ID`` minted per call (or
supplied by the caller): the server adopts it as the request's
flight-recorder identity, so a slow answer can be looked up in the chain
server's ``/debug/requests`` by the ID this client holds in
``last_request_id``.
"""

from __future__ import annotations

import codecs
import json
import os
import urllib.error
import urllib.request
import uuid
from typing import Generator, Optional

from ..obs.flight import mint_request_id
from ..obs.tracing import inject_context
from ..serving.client import post_with_retry
from ..utils import faults
from ..utils.logging import get_logger

logger = get_logger(__name__)


class ChainServerError(urllib.error.HTTPError):
    """A structured error body from the chain server's robustness layer
    (``{"error": {"type", "message"}, "request_id"}`` + ``Retry-After``)
    surfaced as typed fields instead of a bare status line, so callers
    can honor the retry hint and tell ``queue_full`` from
    ``deadline_unmeetable``. Subclasses ``urllib.error.HTTPError``, so
    ``except HTTPError`` handlers keep working; ``response`` is the
    original error (its ``code`` and ``headers``)."""

    def __init__(self, message: str, *, response, err_type: str = "",
                 request_id: str = "",
                 retry_after_s: Optional[float] = None):
        super().__init__(response.url, response.code, message,
                         response.headers, None)
        self.message = message
        self.response = response
        self.err_type = err_type
        self.request_id = request_id
        self.retry_after_s = retry_after_s

    def __str__(self) -> str:
        return self.message


def raise_for_chain_status(resp) -> None:
    """``raise_for_status`` over urllib: ``resp`` is what ``urlopen``
    returned (below status 400: nothing to raise) or the ``HTTPError`` it
    raised, re-raised as a ``ChainServerError`` when its body holds the
    server's JSON error contract, else as it is."""
    if not isinstance(resp, urllib.error.HTTPError):
        return
    err_type = msg = rid = ""
    try:
        body = json.loads(resp.read())
        err = body.get("error") or {}
        err_type = str(err.get("type", ""))
        msg = str(err.get("message", ""))
        rid = str(body.get("request_id", ""))
    except Exception:  # noqa: BLE001 — not a JSON error body
        pass
    retry_after: Optional[float] = None
    ra = resp.headers.get("Retry-After", "")
    try:
        retry_after = float(ra) if ra else None
    except ValueError:
        pass
    if msg:
        raise ChainServerError(
            f"HTTP {resp.code} {err_type or 'error'}: {msg}"
            + (f" (request {rid})" if rid else ""),
            response=resp, err_type=err_type, request_id=rid,
            retry_after_s=retry_after)
    raise resp


# Mid-stream failure markers the chain server emits after a partial
# answer: human-readable text, then a machine-readable event frame.
ERROR_MARK = "\n[error]"
ERROR_EVENT_MARK = "event: error\ndata:"


def multipart_body(path: str, field: str = "file") -> tuple[bytes, str]:
    """(body, content type) of a ``multipart/form-data`` upload of the
    file at ``path`` under ``field``, named by its basename."""
    boundary = uuid.uuid4().hex
    name = os.path.basename(path).replace('"', "%22")
    with open(path, "rb") as f:
        payload = f.read()
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f"name=\"{field}\"; filename=\"{name}\"\r\n"
            f"Content-Type: application/octet-stream\r\n\r\n").encode() \
        + payload + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


class ChatClient:
    def __init__(self, server_url: str, model_name: str = "",
                 timeout: float = 120.0):
        self.server_url = server_url.rstrip("/")
        self.model_name = model_name
        self.timeout = timeout
        # Request ID of the most recent call — what to quote when asking
        # the chain server's /debug/requests why it was slow.
        self.last_request_id: Optional[str] = None
        # Mid-stream failure of the most recent predict() call:
        # {"message": ..., "error": ..., "request_id": ...} or None.
        # The answer chunks predict() yielded remain valid partial
        # output; this field says why they stopped.
        self.last_error: Optional[dict] = None

    def _headers(self, request_id: Optional[str] = None) -> dict:
        rid = request_id or mint_request_id()
        self.last_request_id = rid
        return inject_context({"X-Request-ID": rid})

    def _post(self, path: str, body: dict, headers: dict):
        """The open response of a JSON ``POST`` (one retry policy for
        every call: ``post_with_retry``, connect-phase failures only);
        ``ChainServerError`` for a structured error body."""
        try:
            return post_with_retry(f"{self.server_url}{path}", body,
                                   headers=headers, timeout=self.timeout)
        except urllib.error.HTTPError as exc:
            raise_for_chain_status(exc)

    def search(self, prompt: str, num_docs: int = 4,
               request_id: Optional[str] = None) -> list[dict]:
        """Document retrieval (``/documentSearch``)."""
        with self._post("/documentSearch",
                        {"content": prompt, "num_docs": num_docs},
                        self._headers(request_id)) as resp:
            return json.loads(resp.read())

    def predict(self, query: str, use_knowledge_base: bool = True,
                num_tokens: int = 256, context: str = "",
                request_id: Optional[str] = None,
                on_error=None,
                ) -> Generator[Optional[str], None, None]:
        """Stream ANSWER chunks; yields ``None`` when the stream ends. The
        body is read in blocks of at most 16 bytes, each delivered as soon
        as it arrives (``read1``: one read, no wait to fill the block).

        Mid-stream failure frames (``\\n[error] ...`` and the trailing
        ``event: error`` JSON event) are NOT yielded as answer text: the
        error is parsed into ``self.last_error`` — and passed to the
        ``on_error`` callback, which concurrent callers sharing one
        client MUST use, since ``last_error`` is instance state another
        in-flight predict() can overwrite — so the UI can show the
        partial answer plus an explicit failure notice instead of
        rendering the error as the model's words. Because the marker can
        straddle a block boundary, a marker-length tail is held back
        until the next block disambiguates it."""
        decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")
        self.last_error = None
        pending = ""       # undelivered text (holds back a marker-size tail)
        error_tail = ""    # text after the error marker (never yielded)
        in_error = False

        def scan(flush: bool):
            nonlocal pending, error_tail, in_error
            if in_error:
                return
            idx = pending.find(ERROR_MARK)
            if idx >= 0:
                out, error_tail = pending[:idx], pending[idx:]
                pending = ""
                in_error = True
                if out:
                    yield out
            elif flush:
                out, pending = pending, ""
                if out:
                    yield out
            else:
                keep = len(ERROR_MARK) - 1
                if len(pending) > keep:
                    out, pending = pending[:-keep], pending[-keep:]
                    if out:
                        yield out

        with self._post("/generate",
                        {"question": query, "context": context,
                         "use_knowledge_base": use_knowledge_base,
                         "num_tokens": num_tokens},
                        self._headers(request_id)) as resp:
            while True:
                chunk = resp.read1(16)
                if not chunk:
                    break
                # Incremental decode: a multi-byte UTF-8 sequence may
                # straddle a block boundary.
                text = decoder.decode(chunk)
                if not text:
                    continue
                if in_error:
                    error_tail += text
                else:
                    pending += text
                    yield from scan(flush=False)
        tail = decoder.decode(b"", final=True)
        if in_error:
            error_tail += tail
        else:
            pending += tail
        yield from scan(flush=True)
        if in_error:
            err = self._parse_error(error_tail)
            self.last_error = err
            if on_error is not None:
                on_error(err)
            logger.warning("generation failed mid-stream (request %s): %s",
                           self.last_request_id, err)
        yield None

    def _parse_error(self, tail: str) -> dict:
        """Structured error from the stream's error frames: the JSON
        ``event: error`` payload when present, else the ``[error]``
        text."""
        idx = tail.find(ERROR_EVENT_MARK)
        if idx >= 0:
            payload = tail[idx + len(ERROR_EVENT_MARK):].strip()
            try:
                out = json.loads(payload.split("\n", 1)[0])
                out.setdefault("request_id", self.last_request_id)
                return out
            except (json.JSONDecodeError, AttributeError):
                pass
        msg = tail[len(ERROR_MARK):].split("\n\nevent:")[0].strip()
        return {"message": msg or "generation failed",
                "request_id": self.last_request_id}

    def upload_documents(self, file_paths: list[str]) -> None:
        """Upload files into the knowledge base (``/uploadDocument``);
        ``HTTPError`` on a status of 400 or more."""
        for path in file_paths:
            body, ctype = multipart_body(path)
            headers = self._headers()
            headers["Content-Type"] = ctype
            # No connect-retry here: replaying an upload is not
            # idempotent the way /generate connects are.
            faults.inject("http.connect")
            req = urllib.request.Request(
                f"{self.server_url}/uploadDocument", data=body,
                headers=headers, method="POST")
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                resp.read()
            logger.info("uploaded %s (request %s)", path,
                        self.last_request_id)
