"""Leveled logger with a global verbosity gate, counterpart of
``mpx/utils/logging.py``.

Five levels (Info/Verbose/Warning/Error/Debug), a global ``Verbose`` flag
set by the CLI's ``--verbose``, and Debug output shown only when the
``MPX_DEBUG`` environment variable is ``1`` (as in mpx).
"""

from __future__ import annotations

import enum
import os
import sys


class LogLevel(enum.Enum):
    INFO = "INFO"
    VERBOSE = "INFO/V"
    WARNING = "WARN"
    ERROR = "ERROR"
    DEBUG = "DEBUG"


class Logger:
    verbose: bool = False

    @classmethod
    def log(cls, level: LogLevel, *args):
        if level is LogLevel.VERBOSE and not cls.verbose:
            return
        if level is LogLevel.DEBUG and os.environ.get("MPX_DEBUG") != "1":
            return
        stream = sys.stderr if level is LogLevel.ERROR else sys.stdout
        print(f"[{level.value}]", *args, file=stream)

    @classmethod
    def info(cls, *args):
        cls.log(LogLevel.INFO, *args)

    @classmethod
    def verbose_log(cls, *args):
        cls.log(LogLevel.VERBOSE, *args)

    @classmethod
    def warning(cls, *args):
        cls.log(LogLevel.WARNING, *args)

    @classmethod
    def error(cls, *args):
        cls.log(LogLevel.ERROR, *args)

    @classmethod
    def debug(cls, *args):
        cls.log(LogLevel.DEBUG, *args)
