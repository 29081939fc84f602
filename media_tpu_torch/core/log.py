"""Leveled logging with a pluggable sink callback.

Mirrors the reference's MediaLog subsystem (common/log/MediaLog.{h,cpp},
MediaLogManager.{h,cpp}): printf-style leveled macros feeding a singleton
manager with a pluggable callback; installing a callback drops the level to
DEBUG (MediaLogManager.cpp:78-82); the default sink prints timestamp+pid+tid
(MediaLogManager.cpp:44-68); default level INFO (MediaLogManager.h:54).
"""

from __future__ import annotations

import os
import sys
import threading
import time

LOG_DEBUG = 0
LOG_INFO = 1
LOG_WARN = 2
LOG_ERROR = 3
LOG_FATAL = 4

_LEVEL_NAMES = {0: "D", 1: "I", 2: "W", 3: "E", 4: "F"}


class _LogManager:
    def __init__(self):
        self._callback = None
        self._level = LOG_INFO
        self._lock = threading.Lock()

    def set_callback(self, cb) -> None:
        """Install a log sink callback(level, tag, message). Installing a
        callback lowers the threshold to DEBUG, like the reference."""
        with self._lock:
            self._callback = cb
            if cb is not None:
                self._level = LOG_DEBUG

    def set_level(self, level: int) -> None:
        with self._lock:
            self._level = level

    def log(self, level: int, tag: str, msg: str) -> None:
        if level < self._level:
            return
        cb = self._callback
        if cb is not None:
            cb(level, tag, msg)
            return
        ts = time.strftime("%m-%d %H:%M:%S", time.localtime())
        ms = int((time.time() % 1) * 1000)
        sys.stderr.write(
            f"{ts}.{ms:03d} {os.getpid()} {threading.get_native_id()} "
            f"{_LEVEL_NAMES.get(level, '?')} Media_{tag}: {msg}\n"
        )


_manager = _LogManager()


def set_media_log_callback(cb) -> None:
    _manager.set_callback(cb)


def set_log_level(level: int) -> None:
    _manager.set_level(level)


class Logger:
    """Per-module tagged logger (the LOG_TAG analog)."""

    __slots__ = ("tag",)

    def __init__(self, tag: str):
        self.tag = tag

    def dbg(self, msg: str, *args) -> None:
        _manager.log(LOG_DEBUG, self.tag, msg % args if args else msg)

    def info(self, msg: str, *args) -> None:
        _manager.log(LOG_INFO, self.tag, msg % args if args else msg)

    def warn(self, msg: str, *args) -> None:
        _manager.log(LOG_WARN, self.tag, msg % args if args else msg)

    def err(self, msg: str, *args) -> None:
        _manager.log(LOG_ERROR, self.tag, msg % args if args else msg)

    def fatal(self, msg: str, *args) -> None:
        _manager.log(LOG_FATAL, self.tag, msg % args if args else msg)
