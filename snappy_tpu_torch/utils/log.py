"""Logging for snappy_tpu_torch, a copy of ``snappy_tpu/utils/log.py``
(the reference's logger capability, logger/logger.go:58-109: level-mapped records, stack traces at >=ERROR,
a LogError wrap-and-return idiom at command boundaries).

SNAPPY_TPU_DEBUG=1 enables debug records (the reference's SNAPPY_DEBUG).
Handlers default to stderr; syslog is attached when available, mirroring
the reference's loggo->syslog bridge.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys

_LOGGER_NAME = "snappy_tpu_torch"
_configured = False


def get_logger() -> logging.Logger:
    global _configured
    log = logging.getLogger(_LOGGER_NAME)
    if not _configured:
        _configured = True
        level = logging.DEBUG if os.environ.get("SNAPPY_TPU_DEBUG") else logging.INFO
        log.setLevel(level)
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        log.addHandler(h)
        try:  # syslog bridge, best effort (reference parity)
            if os.path.exists("/dev/log"):
                sh = logging.handlers.SysLogHandler(address="/dev/log")
                sh.setLevel(logging.WARNING)
                # a dead syslog socket must never spew "--- Logging
                # error ---" tracebacks over the CLI's own error report
                sh.handleError = lambda record: None
                log.addHandler(sh)
        except OSError:
            pass
    return log


def log_error(err: BaseException, context: str = "") -> BaseException:
    """Log-and-return idiom: every command boundary logs the root cause
    once (with traceback at ERROR, as the reference does) and re-raises
    or returns the same error."""
    log = get_logger()
    log.error("%s%s", f"{context}: " if context else "", err, exc_info=err)
    return err
