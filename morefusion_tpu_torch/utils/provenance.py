"""Experiment provenance: the git hash and the data root.

Own copy of ``morefusion_tpu/utils/provenance.py``.
"""

from __future__ import annotations

import os
import subprocess


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


def get_data_path(*parts: str) -> str:
    """A path under the data root: ``$MOREFUSION_TPU_DATA``, else
    ``~/data``."""
    root = os.environ.get("MOREFUSION_TPU_DATA",
                          os.path.expanduser("~/data"))
    return os.path.join(root, *parts)
