# coding: utf-8
"""
Logging (counterpart of joeys2t_tpu/utils/logging.py ``get_logger`` :32 and
``add_file_handler`` :46).

The port runs as one process, so there is no rank gate. Every module logger
lives under the package logger ``joeys2t_torch``, which alone holds the
stream handler; a file handler added to it receives every module's records.
"""
import logging
from pathlib import Path

_FORMAT = "%(asctime)s - %(levelname)s - %(message)s"
ROOT = "joeys2t_torch"


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger ``name``; the package logger gets its stream handler on
    first use."""
    root = logging.getLogger(ROOT)
    if not root.handlers:
        root.setLevel(logging.DEBUG)
        handler = logging.StreamHandler()
        handler.setLevel(logging.INFO)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.propagate = False
    return logging.getLogger(name)


def add_file_handler(logger: logging.Logger, log_file: Path,
                     level: int = logging.DEBUG) -> logging.Handler:
    """Attach a file handler to ``logger`` (per-mode log files of the
    reference); the caller removes and closes it when the mode ends."""
    log_file = Path(log_file)
    log_file.parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(log_file.as_posix(), encoding="utf-8")
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    return handler
