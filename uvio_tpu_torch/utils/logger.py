"""Leveled logger (a copy of `uvio_tpu/utils/logger.py`): the reference's `Printer` (`ov_core/src/utils/
print.h:54-99`) re-done as a tiny module-global.

Levels (same order/semantics as the reference): ALL < DEBUG < INFO <
WARNING < ERROR < SILENT. The global level gates emission; DEBUG and
below prepend a `file:line` prefix like the reference. WARNING/ERROR
are colorized (reference `colors.h`) when the stream is a tty.
"""

from __future__ import annotations

import inspect
import os
import sys

ALL, DEBUG, INFO, WARNING, ERROR, SILENT = range(6)
_NAMES = {"ALL": ALL, "DEBUG": DEBUG, "INFO": INFO, "WARNING": WARNING,
          "ERROR": ERROR, "SILENT": SILENT}

_level = INFO

_YELLOW, _RED, _RESET = "\033[33m", "\033[31m", "\033[0m"


def set_verbosity(level) -> None:
    """Set the global print level by enum value or name (the reference
    accepts both, `Printer::setPrintLevel`)."""
    global _level
    if isinstance(level, str):
        name = level.upper()
        if name not in _NAMES:
            raise ValueError(f"unknown verbosity {level!r}; one of {list(_NAMES)}")
        _level = _NAMES[name]
    else:
        if not ALL <= int(level) <= SILENT:
            raise ValueError(f"verbosity out of range: {level}")
        _level = int(level)


def get_verbosity() -> int:
    return _level


def _emit(level: int, msg: str, args, color: str = "") -> None:
    if level < _level:
        return
    text = (msg % args) if args else msg
    if level <= DEBUG:
        fr = inspect.stack()[2]
        text = f"{os.path.basename(fr.filename)}:{fr.lineno} {text}"
    stream = sys.stderr if level >= WARNING else sys.stdout
    if color and stream.isatty():
        text = f"{color}{text}{_RESET}"
    print(text, file=stream)


def print_all(msg, *args):
    _emit(ALL, msg, args)


def print_debug(msg, *args):
    _emit(DEBUG, msg, args)


def print_info(msg, *args):
    _emit(INFO, msg, args)


def print_warning(msg, *args):
    _emit(WARNING, msg, args, _YELLOW)


def print_error(msg, *args):
    _emit(ERROR, msg, args, _RED)
