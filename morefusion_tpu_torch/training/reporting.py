"""Experiment logging & provenance: log.json / args.json.

Port of ``morefusion_tpu/training/reporting.py``: ``LogReport`` appends
observation rows to ``log.json``; ``write_args`` stamps ``args.json`` with the git hash, the host name and
the time. ``githash`` is an own copy of ``morefusion_tpu/utils/
provenance.py::githash``.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import tempfile
from typing import Dict, Optional


def githash(cwd: str = None) -> str:
    """Current git commit hash (empty string outside a repo)."""
    if cwd is None:
        cwd = os.path.dirname(os.path.abspath(__file__))
    try:
        return (
            subprocess.check_output(
                ["git", "rev-parse", "HEAD"], cwd=cwd,
                stderr=subprocess.DEVNULL,
            )
            .decode()
            .strip()
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        return ""


def write_args(out_dir: str, args: Dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    payload = dict(args)
    payload.setdefault("githash", githash())
    payload.setdefault("hostname", socket.gethostname())
    payload.setdefault(
        "timestamp", datetime.datetime.now().isoformat()
    )
    with open(os.path.join(out_dir, "args.json"), "w") as f:
        json.dump(payload, f, indent=2, default=str)


def load_args(out_dir: str) -> Dict:
    """Read ``args.json`` back (to rebuild a model for evaluation)."""
    with open(os.path.join(out_dir, "args.json")) as f:
        return json.load(f)


class LogReport:
    """Append observation rows; write log.json atomically. The rows of
    an existing ``log.json`` are kept, so a resumed run extends them."""

    def __init__(self, out_dir: str):
        self._out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._log = []
        log_path = os.path.join(out_dir, "log.json")
        if os.path.exists(log_path):
            try:
                with open(log_path) as f:
                    self._log = json.load(f)
            except (json.JSONDecodeError, OSError):
                pass

    @property
    def log(self):
        return list(self._log)

    def report(
        self, observation: Dict[str, float], step: int,
        epoch: Optional[float] = None
    ) -> None:
        row = {k: float(v) for k, v in observation.items()}
        row["iteration"] = int(step)
        if epoch is not None:
            row["epoch"] = float(epoch)
        row["elapsed_time"] = datetime.datetime.now().timestamp()
        self._log.append(row)

        fd, tmp = tempfile.mkstemp(dir=self._out_dir, suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(self._log, f, indent=1)
        os.replace(tmp, os.path.join(self._out_dir, "log.json"))
