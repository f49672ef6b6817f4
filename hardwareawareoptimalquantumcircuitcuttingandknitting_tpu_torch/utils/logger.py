"""Singleton logging configuration.

Mirrors the reference Logger (src/HwAwareCutter/Logger.py:7-59): console
handler at INFO, midnight-rotating file handler at DEBUG with 30 backups,
format ``time | module [thread] | level: message``.
"""
from __future__ import annotations

import logging
import logging.handlers
import pathlib
import threading

_APP_NAME = "HwAwareCutterTPU"
_FORMAT = "%(asctime)s | %(name)s [%(threadName)s] | %(levelname)s: %(message)s"
_lock = threading.Lock()
_configured = False


def configure_loggers(log_file: str | pathlib.Path | None = None) -> None:
    """Configure the app logger once per process (Logger.py:52-59)."""
    global _configured
    with _lock:
        root = logging.getLogger(_APP_NAME)
        root.setLevel(logging.DEBUG)
        for h in root.handlers:  # close before dropping: a replaced file
            h.close()            # handler would otherwise leak its fd
        root.handlers.clear()
        console = logging.StreamHandler()
        console.setLevel(logging.INFO)
        console.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(console)
        if log_file is not None:
            pathlib.Path(log_file).parent.mkdir(parents=True, exist_ok=True)
            fileh = logging.handlers.TimedRotatingFileHandler(
                log_file, when="midnight", backupCount=30
            )
            fileh.setLevel(logging.DEBUG)
            fileh.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(fileh)
        root.propagate = False
        _configured = True


def get_logger(module: str = "") -> logging.Logger:
    global _configured
    if not _configured:
        configure_loggers(None)
    name = f"{_APP_NAME}.{module}" if module else _APP_NAME
    return logging.getLogger(name)
