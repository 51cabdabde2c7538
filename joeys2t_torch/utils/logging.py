# coding: utf-8
"""
Logging (counterpart of joeys2t_tpu/utils/logging.py ``get_logger`` :32 and
``add_file_handler`` :46).

Every module logger lives under the package logger ``joeys2t_torch``, which
alone holds the stream handler; a file handler added to it receives every
module's records. In a data-parallel run only rank 0 emits records (the JAX
package's ``MainProcessFilter`` :23): the stream handler lets the other
ranks' records through only at warning level and above, tagged with the
rank, and the other ranks get no file handler.
"""
import logging
from pathlib import Path
from typing import Optional

from joeys2t_torch.parallel import distributed

_FORMAT = "%(asctime)s - %(levelname)s - %(message)s"
ROOT = "joeys2t_torch"


class MainProcessFilter(logging.Filter):
    """Rank 0's records; the other ranks' warnings and errors, tagged."""

    def filter(self, record: logging.LogRecord) -> bool:  # noqa: A003
        r = distributed.rank()
        if r == 0:
            return True
        if record.levelno < logging.WARNING:
            return False
        record.msg = f"[rank {r}] {record.msg}"
        return True


def get_logger(name: str = ROOT) -> logging.Logger:
    """The logger ``name``; the package logger gets its stream handler on
    first use."""
    root = logging.getLogger(ROOT)
    if not root.handlers:
        root.setLevel(logging.DEBUG)
        handler = logging.StreamHandler()
        handler.setLevel(logging.INFO)
        handler.setFormatter(logging.Formatter(_FORMAT))
        handler.addFilter(MainProcessFilter())
        root.addHandler(handler)
        root.propagate = False
    return logging.getLogger(name)


def add_file_handler(logger: logging.Logger, log_file: Path,
                     level: int = logging.DEBUG) -> Optional[logging.Handler]:
    """Attach a file handler to ``logger`` (per-mode log files of the
    reference) on rank 0; None on the other ranks. The caller removes and
    closes it when the mode ends."""
    if not distributed.is_main():
        return None
    log_file = Path(log_file)
    log_file.parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(log_file.as_posix(), encoding="utf-8")
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    return handler
