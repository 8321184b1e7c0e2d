"""Leveled logging + throttled progress reporting.

Counterpart of the reference's two-sided spdlog/python logging bridge
(``buffalo/misc/log.py``, ``lib/misc/log.cc``).  Here there is a single
Python logging domain — the PyTorch compute core logs through the same
loggers — so the cross-language level-sync machinery disappears; we keep
the public surface: ``get_logger``, ``set_log_level``/``get_log_level``
(numeric levels 0-5 as in the reference) and a tty-free throttled
``ProgressBar`` usable inside training loops.
"""
from __future__ import annotations

import logging
import sys
import time

NOTSET = 0
WARN = 1
INFO = 2
DEBUG = 3
TRACE = 4

_LEVEL_TO_PY = {
    0: logging.WARNING,
    1: logging.WARNING,
    2: logging.INFO,
    3: logging.DEBUG,
    4: logging.DEBUG - 5,
    5: logging.DEBUG - 5,
}

_ROOT = "buffalo_tpu_torch"
_current_level = INFO
_configured = False


def _ensure_configured() -> None:
    global _configured
    if _configured:
        return
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "[%(levelname)-5s] %(asctime)s [%(name)s] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        root.addHandler(handler)
    root.setLevel(_LEVEL_TO_PY.get(_current_level,
                                   logging.INFO))
    root.propagate = False
    _configured = True


def get_logger(name: str = _ROOT) -> logging.Logger:
    _ensure_configured()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def set_log_level(level: int) -> None:
    """Set the global log level (0=off-ish, 1=warn, 2=info, 3=debug, 4/5=trace)."""
    global _current_level
    _current_level = int(level)
    _ensure_configured()
    logging.getLogger(_ROOT).setLevel(
        _LEVEL_TO_PY.get(_current_level, logging.INFO)
    )


def get_log_level() -> int:
    return _current_level


class supress_log_level:
    """Context manager that temporarily changes the log level."""

    def __init__(self, level: int):
        self.desired = level
        self.saved = get_log_level()

    def __enter__(self):
        self.saved = get_log_level()
        set_log_level(self.desired)
        return self

    def __exit__(self, *exc):
        set_log_level(self.saved)
        return False


class ProgressBar:
    """Throttled, log-based progress reporter (no tty control codes).

    Same contract as the reference's ``log.ProgressBar``
    (``misc/log.py:69-167``): updates are rate-limited by ``mininterval``
    seconds, report percent progress plus rate, and always emit a final
    line at close.  Usable as a context manager or iterator wrapper.
    """

    def __init__(self, level: int = INFO, iterable=None, total=None,
                 mininterval: float = 2.5):
        self.logger = get_logger("progress")
        self.level = _LEVEL_TO_PY.get(level, logging.INFO)
        self.iterable = iterable
        self.total = total if total is not None else (
            len(iterable) if iterable is not None and hasattr(iterable, "__len__") else None
        )
        self.mininterval = mininterval
        self.n = 0
        self._start = time.time()
        self._last_emit = 0.0

    def __iter__(self):
        for obj in self.iterable:
            yield obj
            self.update(1)
        self.close()

    def __enter__(self):
        self._start = time.time()
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def update(self, n: int = 1) -> None:
        self.n += n
        now = time.time()
        if now - self._last_emit >= self.mininterval:
            self._emit(now)
            self._last_emit = now

    def _emit(self, now: float) -> None:
        elapsed = max(now - self._start, 1e-9)
        rate = self.n / elapsed
        if self.total:
            pct = 100.0 * self.n / self.total
            self.logger.log(self.level,
                            "progress %6.2f%% (%d/%d) %.1f it/s elapsed %.1fs",
                            pct, self.n, self.total, rate, elapsed)
        else:
            self.logger.log(self.level, "progress %d %.1f it/s elapsed %.1fs",
                            self.n, rate, elapsed)

    def close(self) -> None:
        self._emit(time.time())
