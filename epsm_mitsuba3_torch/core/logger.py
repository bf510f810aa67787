"""Levelled logging and progress reporting (counterpart of
``core/logger.py``, the reference's src/core/{logger,progress}.cpp).

A thin layer over Python's ``logging`` (the logger ``epsm_mitsuba3_torch``)
with the reference's ``Log`` level API, and a ``ProgressReporter`` for
long renders and optimisations."""
from __future__ import annotations

import logging
import sys
import time


class LogLevel:
    Trace = 5
    Debug = logging.DEBUG
    Info = logging.INFO
    Warn = logging.WARNING
    Error = logging.ERROR


_logger = logging.getLogger("epsm_mitsuba3_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).4s [%(name)s] %(message)s", "%H:%M:%S"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)


def Log(level: int, msg: str, *args):
    """mi.Log."""
    _logger.log(level, msg, *args)


def set_log_level(level: int):
    _logger.setLevel(level)


class ProgressReporter:
    """ProgressReporter (src/core/progress.cpp): a text bar with the
    elapsed time and an estimate of the rest, written at most every
    ``min_interval`` seconds (and always at the end)."""

    def __init__(self, label: str, total: int, min_interval: float = 0.5,
                 stream=None):
        self.label = label
        self.total = max(total, 1)
        self.t0 = time.time()
        self.last = 0.0
        self.min_interval = min_interval
        self.stream = stream or sys.stderr

    def update(self, done: int, extra: str = ""):
        now = time.time()
        if now - self.last < self.min_interval and done < self.total:
            return
        self.last = now
        frac = done / self.total
        elapsed = now - self.t0
        eta = elapsed / max(frac, 1e-6) - elapsed
        bar = "=" * int(frac * 30)
        self.stream.write(
            f"\r{self.label} [{bar:<30}] {100 * frac:5.1f}% "
            f"(elapsed {elapsed:5.1f}s, eta {eta:5.1f}s) {extra}")
        if done >= self.total:
            self.stream.write("\n")
        self.stream.flush()
