"""Typed exceptions the port raises (copied from the reference package's
``utils/errors.py``; the port imports nothing from it)."""

from __future__ import annotations


class FrameworkError(Exception):
    """Base class for all first-party errors."""


class ConfigError(FrameworkError):
    """Invalid or missing configuration."""


class ModelLoadError(FrameworkError):
    """A checkpoint could not be found, sniffed, or imported."""


class UnsupportedFormatError(ModelLoadError):
    """Checkpoint format not recognized, or not served by the port."""


class EngineError(FrameworkError):
    """Inference-engine runtime failure."""


class SchedulerFullError(EngineError):
    """No queue capacity for a new request."""
