"""Logging with simulated-or-wall-clock timestamps
(capability of reference: scheduler/custom_logging.py:5-12)."""

from __future__ import annotations

import logging


class TimestampAdapter(logging.LoggerAdapter):
    """Prefixes records with the scheduler's current (possibly simulated)
    timestamp, fetched lazily from a callable."""

    def __init__(self, logger, clock):
        super().__init__(logger, {})
        self._clock = clock

    def process(self, msg, kwargs):
        return "[%.2f] %s" % (self._clock(), msg), kwargs


def make_logger(name: str, clock, level=None) -> TimestampAdapter:
    """Named logger wrapped in a :class:`TimestampAdapter`.

    The handler is added once per name; the level is only touched when
    the caller asks: ``level=None`` (the default) preserves whatever
    level the logger already carries — a second ``make_logger`` call
    (another Scheduler in the same process, a test that tuned verbosity)
    must not silently reset it — and sets WARNING only on a logger that
    was never configured (level NOTSET).
    """
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(name)s:%(levelname)s %(message)s"))
        logger.addHandler(handler)
    if level is not None:
        logger.setLevel(level)
    elif logger.level == logging.NOTSET:
        logger.setLevel(logging.WARNING)
    return TimestampAdapter(logger, clock)
