"""Leveled logging with once-per-condition dedup.

Counterpart of ``gsplat_tpu.utils.logging``: a once-per-key suppressor that
logs a condition the first time only and can be *reset* so the message fires
again when the condition recurs after clearing.  Built on the stdlib
``logging`` module so host applications can route and filter as usual.
"""

from __future__ import annotations

import logging
import sys
from typing import Set

_ROOT_NAME = "gsplat_tpu_torch"
_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger(_ROOT_NAME)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(levelname)s] %(name)s: %(message)s")
        )
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    _configured = True


def format_count(n: int) -> str:
    """Thousands-separated integer."""
    return f"{int(n):,}"


class OnceLogger:
    """Logger with per-key one-time suppression: the ``*_once`` methods log a
    message only the first time (keyed by level and message, or by an
    explicit ``key``); ``reset_once`` re-arms a key."""

    def __init__(self, name: str):
        _configure_root()
        self._log = logging.getLogger(f"{_ROOT_NAME}.{name}")
        self._seen: Set[str] = set()

    def info(self, msg: str, *args) -> None:
        self._log.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self._log.warning(msg, *args)

    def error(self, msg: str, *args) -> None:
        self._log.error(msg, *args)

    def _once(self, level: int, msg: str, key: str | None) -> None:
        k = key if key is not None else f"{level}:{msg}"
        if k in self._seen:
            return
        self._seen.add(k)
        self._log.log(level, msg)

    def info_once(self, msg: str, key: str | None = None) -> None:
        self._once(logging.INFO, msg, key)

    def warning_once(self, msg: str, key: str | None = None) -> None:
        self._once(logging.WARNING, msg, key)

    def error_once(self, msg: str, key: str | None = None) -> None:
        self._once(logging.ERROR, msg, key)

    def reset_once(self, key: str) -> None:
        """Re-arm a suppressed key (fire again when the condition recurs)."""
        self._seen.discard(key)


_loggers: dict = {}


def get_logger(name: str) -> OnceLogger:
    if name not in _loggers:
        _loggers[name] = OnceLogger(name)
    return _loggers[name]
