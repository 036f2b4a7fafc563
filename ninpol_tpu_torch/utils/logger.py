"""Phase logging + JSON metric dumps, built on stdlib ``logging``.

Provides the capability surface of the reference's Logger
(ninpol/_interpolator/logger.pyx: leveled timestamped phase messages to
terminal or per-run files under ``.ninpollog/``, plus JSON metric dumps
with numpy conversion) as a thin facade over ``logging.Logger`` —
handlers/formatters do the work, and unique per-run file allocation uses
atomic ``O_EXCL`` creation instead of existence polling.

Log line format (consumed by the test harness and kept stable):
``[LEVEL] (HH:MM:SS) message``.
"""
from __future__ import annotations

import itertools
import json
import logging as _logging
import os
import time

import numpy as np

_LEVELS = {
    "DEBUG": _logging.DEBUG,
    "INFO": _logging.INFO,
    "WARN": _logging.WARNING,
    "WARNING": _logging.WARNING,
    "ERROR": _logging.ERROR,
    "CRITICAL": _logging.CRITICAL,
}

_instance_ids = itertools.count()


def arr_to_dict(arr):
    """numpy array -> {index: value} dict (reference: utils/common.py:3-8)."""
    return {i: (v.tolist() if isinstance(v, np.ndarray) else v)
            for i, v in enumerate(arr)}


def _jsonable(obj):
    if isinstance(obj, np.ndarray):
        return arr_to_dict(obj)
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class _PhaseFormatter(_logging.Formatter):
    def format(self, record):
        stamp = time.strftime("%H:%M:%S", self.converter(record.created))
        level = {"WARNING": "WARN"}.get(record.levelname, record.levelname)
        return f"[{level:<5}] ({stamp:<8}) {record.getMessage()}"


def _open_unique(directory, base, day):
    """Atomically allocate a fresh ``<base>-<day>_<i>.log`` path (O_EXCL
    creation — no races, no existence polling)."""
    for i in itertools.count():
        path = os.path.join(directory, f"{base}-{day}_{i}.log")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        os.close(fd)
        return path, i


class Logger:
    """Facade over ``logging``: terminal or per-run file sink + JSON
    metric accumulation.  ``logging=False`` makes every call a no-op."""

    def __init__(self, log_name, terminal=True, directory="", logging=False):
        self.logging = logging
        self.terminal = terminal
        self.data = {}
        self.json_filename = None

        self._log = None
        if not self.logging:
            return

        name = f"ninpol_tpu_torch.{log_name}.{next(_instance_ids)}"
        lg = _logging.getLogger(name)
        lg.setLevel(_LEVELS["DEBUG"])
        lg.propagate = False
        if terminal:
            handler = _logging.StreamHandler()
        else:
            directory = directory or os.path.join(os.getcwd(), ".ninpollog")
            os.makedirs(directory, exist_ok=True)
            day = time.strftime("%y%m%d")
            path, idx = _open_unique(directory, log_name, day)
            self.json_filename = path[:-4] + ".json"
            handler = _logging.FileHandler(path)
            self.filename = path
        handler.setFormatter(_PhaseFormatter())
        lg.handlers = [handler]
        self._log = lg

    def log(self, message, level="INFO"):
        if self._log is not None:
            self._log.log(_LEVELS.get(level, _LEVELS["INFO"]), message)

    def np_to_list(self, data):
        return _jsonable(data)

    def json(self, member_name, data):
        if not self.logging:
            return
        if self.terminal:
            self.log("JSON metric dumps need a file-mode Logger "
                     "(terminal=False); skipping write", "WARN")
        self.data[member_name] = {
            "timestamp": time.strftime("%H:%M:%S"),
            "data": _jsonable(data),
        }
        if self.json_filename and not self.terminal:
            with open(self.json_filename, "w") as f:
                json.dump(self.data, f, indent=2, default=str)
