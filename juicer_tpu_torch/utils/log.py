"""Static log facility and environment-based runtime configuration, a
copy of `juicer_tpu/utils/log.py`.

Rebuild of the reference's two config/observability mechanisms:
  - `LogFile` (`LogFile.h:22-39`): printf-style static
    logger to file/stdout/stderr, opened once by the CLI, stamped with
    date and hostname (`juicer.cpp:486-489`);
  - Tracter `GetEnv` object-scoped runtime tunables
    (`WFSTDecoderLite.cpp:68-74`, `FrontEnd.h:72`): here plain environment
    variables with the `JTPU_` prefix (e.g. JTPU_MAX_INSTS is the
    MaxAllocModels analogue).
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
from typing import Optional, TextIO


class LogFile:
    _fd: Optional[TextIO] = None
    _owned = False

    @classmethod
    def open(cls, fname: Optional[str]) -> None:
        cls.close()
        if fname in (None, "", "stdout"):
            cls._fd = sys.stdout
        elif fname == "stderr":
            cls._fd = sys.stderr
        else:
            cls._fd = open(fname, "w")
            cls._owned = True
        cls.date("started")
        cls.hostname()

    @classmethod
    def close(cls) -> None:
        if cls._fd is not None and cls._owned:
            cls._fd.close()
        cls._fd = None
        cls._owned = False

    @classmethod
    def printf(cls, fmt: str, *args) -> None:
        if cls._fd is None:
            return
        cls._fd.write((fmt % args) if args else fmt)
        cls._fd.flush()

    @classmethod
    def puts(cls, s: str) -> None:
        cls.printf(s)

    @classmethod
    def date(cls, tag: str = "") -> None:
        cls.printf("%s %s\n", tag, datetime.datetime.now().isoformat())

    @classmethod
    def hostname(cls) -> None:
        cls.printf("host %s\n", socket.gethostname())


def get_env(name: str, default):
    """Runtime tunable lookup: the JTPU_<NAME> environment variable, read
    as the type of `default`, which it falls back to."""
    v = os.environ.get(f"JTPU_{name.upper()}")
    if v is None:
        return default
    try:
        return type(default)(v)
    except ValueError:
        return default
