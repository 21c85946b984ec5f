"""Client helpers for the serving replicas, over ``urllib.request``: the
connect-failure test that decides whether a call may be replayed, and the
drain protocol's two calls (``POST /control/drain`` / ``/control/undrain``
on a chain-server replica, docs/router.md).
"""

from __future__ import annotations

import json
import socket
import urllib.error
import urllib.request


def is_connect_failure(exc: BaseException) -> bool:
    """True only when the failure happened ESTABLISHING the connection:
    the request cannot have run on the server, so a replay cannot run a
    generation twice. ``urlopen`` wraps what fails while connecting or
    sending in ``URLError`` (an ``HTTPError`` is an answer, not a
    failure); a reset or a timeout while reading the answer comes out
    raw, and the server may have done the work, so it is not replayed."""
    if isinstance(exc, urllib.error.HTTPError):
        return False
    if isinstance(exc, urllib.error.URLError):
        reason = exc.reason
        if isinstance(reason, BaseException):
            return is_connect_failure(reason) or isinstance(
                reason, (socket.gaierror, TimeoutError))
        return "refused" in str(reason).lower()
    if isinstance(exc, ConnectionRefusedError):
        return True
    # Builtin ConnectionError (injected faults too); its subclasses
    # Reset/Aborted/BrokenPipe mean bytes were already in flight.
    return type(exc) is ConnectionError


def _post_json(url: str, timeout: float) -> dict:
    req = urllib.request.Request(url, data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def get_json(url: str, timeout: float = 10.0) -> dict:
    """``GET`` a JSON body; an HTTP error status still yields its body
    (a drained replica's ``/health`` answers 503 with the count the
    drain poll reads)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as exc:
        return json.loads(exc.read() or b"{}")


def drain_replica(url: str, timeout: float = 10.0) -> dict:
    """Flip a chain-server replica to reject-new admission
    (``POST /control/drain``). Returns the server's ``{"status":
    "draining", "in_flight": N}``, so rollout tooling can poll
    ``/health`` until the in-flight count reaches 0 before it stops the
    process (``python -m generativeaiexamples_tpu_torch.router drain``).
    Raises ``urllib.error.URLError`` (``HTTPError`` on a non-2xx)."""
    return _post_json(f"{url.rstrip('/')}/control/drain", timeout)


def undrain_replica(url: str, timeout: float = 10.0) -> dict:
    """Re-open admission on a drained replica (rollback)."""
    return _post_json(f"{url.rstrip('/')}/control/undrain", timeout)
