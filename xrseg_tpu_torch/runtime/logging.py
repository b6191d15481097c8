"""Leveled debug logging (the PassthroughCameraDebugger equivalent,
Assets/Scripts/PassthroughCamera/PassthroughCameraDebugger.cs:11-50).

Same level semantics as the reference (ALL / NONE / ONLY_ERROR / ONLY_LOG /
ONLY_WARNING) on top of stdlib logging, so framework modules share one
switchable channel.
"""
from __future__ import annotations

import enum
import logging
import sys


class DebugLevel(enum.Enum):
    ALL = "all"
    NONE = "none"
    ONLY_ERROR = "error"
    ONLY_LOG = "log"
    ONLY_WARNING = "warning"


_logger = logging.getLogger("xrseg_tpu_torch")
_level = DebugLevel.ALL


def configure(level: DebugLevel = DebugLevel.ALL, stream=None) -> None:
    global _level
    _level = level
    if not _logger.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter("[xrseg] %(levelname)s %(message)s"))
        _logger.addHandler(h)
    _logger.setLevel(logging.DEBUG)


def debug_message(kind: str, message: str) -> None:
    """DebugMessage(level, msg) equivalent: kind in {log, warning, error}."""
    if _level == DebugLevel.NONE:
        return
    if kind == "error" and _level in (DebugLevel.ALL, DebugLevel.ONLY_ERROR):
        _logger.error(message)
    elif kind == "warning" and _level in (DebugLevel.ALL,
                                          DebugLevel.ONLY_WARNING):
        _logger.warning(message)
    elif kind == "log" and _level in (DebugLevel.ALL, DebugLevel.ONLY_LOG):
        _logger.info(message)


def log(msg: str) -> None:
    debug_message("log", msg)


def warning(msg: str) -> None:
    debug_message("warning", msg)


def error(msg: str) -> None:
    debug_message("error", msg)
