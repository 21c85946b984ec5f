"""Logging bootstrap and the structured one-line event log (a copy of the
reference package's ``utils/logging.py``, cut to what the port uses)."""

from __future__ import annotations

import logging
import os
import sys
import tempfile

LOG_FORMAT = "%(levelname)s %(asctime)s %(process)d %(name)s: %(message)s"


def bootstrap_logging(verbosity: int = 0) -> None:
    """Configure root logging. verbosity: -1 quiet, 0 info, >=1 debug."""
    level = logging.DEBUG if verbosity >= 1 else (
        logging.WARNING if verbosity < 0 else logging.INFO)
    logging.basicConfig(stream=sys.stderr, format=LOG_FORMAT, level=level,
                        force=True)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def log_event(logger: logging.Logger, event: str, *,
              level: int = logging.WARNING, **fields) -> None:
    """One-line structured log record: ``<event> {json fields}``.

    The machine-greppable side channel the flight recorder's slow-request
    dump uses (obs/flight.py): one line per event, the payload a single
    JSON object, so ``grep slow_request | jq`` reconstructs the whole
    timeline. Values that don't serialize degrade to ``str()`` rather
    than raising: a log line must never take down the serving path."""
    import json
    try:
        payload = json.dumps(fields, default=str, sort_keys=True)
    except (TypeError, ValueError):
        payload = str(fields)
    logger.log(level, "%s %s", event, payload)


def run_dir() -> str:
    """The run directory for pid files and incident bundles:
    ``GAIE_RUN_DIR``, else ``generativeaiexamples_tpu_torch/run`` under
    the temporary directory (``TMPDIR``)."""
    return os.environ.get("GAIE_RUN_DIR") or os.path.join(
        tempfile.gettempdir(), "generativeaiexamples_tpu_torch", "run")


def write_pid_file(name: str) -> str | None:
    """Record this process's pid under the run directory (``run_dir``) as
    ``<name>.pid``, removed at clean exit. Returns the path, or None on
    failure (a pid file is a convenience, never a boot blocker)."""
    path = os.path.join(run_dir(), f"{name}.pid")
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(str(os.getpid()))
    except OSError:
        logging.getLogger(__name__).debug("cannot write pid file %s", path)
        return None
    import atexit
    pid = os.getpid()

    def _cleanup() -> None:
        # Remove only this process's pid file: during a restart overlap
        # the new process has already overwritten it.
        try:
            with open(path, encoding="utf-8") as fh:
                if fh.read().strip() != str(pid):
                    return
            os.remove(path)
        except OSError:
            pass
    atexit.register(_cleanup)
    return path
