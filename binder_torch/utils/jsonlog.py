"""Structured JSON logging (bunyan-equivalent).

The reference logs bunyan JSON lines to stdout with numeric levels
(``main.js:40-47``); operators filter with the ``bunyan`` CLI.  This module
emits the same shape — one JSON object per line with ``name``, ``hostname``,
``pid``, ``level`` (bunyan numeric scale), ``msg``, ``time``, plus any
structured fields — so existing log tooling keeps working.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import socket
import sys
from typing import IO, Optional

# bunyan numeric levels
BUNYAN_LEVELS = {
    logging.DEBUG - 5: 10,   # trace
    logging.DEBUG: 20,
    logging.INFO: 30,
    logging.WARNING: 40,
    logging.ERROR: 50,
    logging.CRITICAL: 60,
}

TRACE = logging.DEBUG - 5
logging.addLevelName(TRACE, "TRACE")


class JsonFormatter(logging.Formatter):
    def __init__(self, name: str) -> None:
        super().__init__()
        self.name = name
        self.hostname = socket.gethostname()

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "name": self.name,
            "hostname": self.hostname,
            "pid": os.getpid(),
            "level": BUNYAN_LEVELS.get(record.levelno,
                                       record.levelno),
            "component": record.name,
            "msg": record.getMessage(),
            "time": datetime.datetime.now(datetime.timezone.utc)
                    .isoformat().replace("+00:00", "Z"),
            "v": 0,
        }
        extra = getattr(record, "binder", None)
        if isinstance(extra, dict):
            entry.update(extra)
        if record.exc_info and record.exc_info[0] is not None:
            entry["err"] = {
                "name": record.exc_info[0].__name__,
                "message": str(record.exc_info[1]),
            }
        return json.dumps(entry, default=str)


def make_logger(name: str = "binder", level: str = "info",
                stream: Optional[IO] = None) -> logging.Logger:
    """Create the root service logger with bunyan-style JSON output."""
    logger = logging.getLogger(name)
    logger.setLevel(_parse_level(level))
    logger.propagate = False
    handler = logging.StreamHandler(stream or sys.stdout)
    handler.setFormatter(JsonFormatter(name))
    logger.handlers = [handler]
    return logger


def _parse_level(level: str) -> int:
    return {
        "trace": TRACE,
        "debug": logging.DEBUG,
        "info": logging.INFO,
        "warn": logging.WARNING,
        "warning": logging.WARNING,
        "error": logging.ERROR,
        "fatal": logging.CRITICAL,
    }.get(str(level).lower(), logging.INFO)


def log_event(logger: logging.Logger, level: int, msg: str,
              **fields) -> None:
    """Log *msg* with structured *fields* merged into the JSON line."""
    logger.log(level, msg, extra={"binder": fields})
