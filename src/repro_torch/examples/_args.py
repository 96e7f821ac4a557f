"""The examples' shared ``--device`` flag."""

from __future__ import annotations

import argparse


def parse_device(argv, doc: str) -> str:
    ap = argparse.ArgumentParser(description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return ap.parse_args(argv).device
