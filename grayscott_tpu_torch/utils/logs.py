"""Logging for the port's programs: the port's copy of
``grayscott_tpu/utils/logs.py``.

Since stderr carries the progress bar, logs go to syslog where there is
one, else to stderr. ``GRAYSCOTT_LOG`` sets the level (default INFO).
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys


def init_logging(prefer_syslog: bool = True) -> logging.Logger:
    logger = logging.getLogger("grayscott_tpu_torch")
    if logger.handlers:
        return logger
    logger.setLevel(os.environ.get("GRAYSCOTT_LOG", "INFO").upper())
    handler: logging.Handler
    if prefer_syslog and os.path.exists("/dev/log"):
        try:
            handler = logging.handlers.SysLogHandler(address="/dev/log")
            print("Since stderr is not usable inside of a TUI, logs will be "
                  "emitted on syslog...", file=sys.stderr)
        except OSError:
            handler = logging.StreamHandler(sys.stderr)
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    return logger
