"""The arguments every check takes."""

from __future__ import annotations

import argparse
import os

#: apart from the JAX scripts' /tmp/mftpu_checks, which a port run never
#: overwrites
OUT_DIR = "/tmp/mftpu_torch_checks"


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of the check's tensor work "
                        "(default cuda; cpu only when asked)")
    p.add_argument("--out-dir", default=OUT_DIR,
                   help="where the PNG / OBJ artifacts go")
    return p


def out_path(args, name: str) -> str:
    os.makedirs(args.out_dir, exist_ok=True)
    return os.path.join(args.out_dir, name)
