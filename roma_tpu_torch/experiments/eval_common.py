"""What the evaluation entry points share: the flags of the weights, the
device and the output file, and the write of the results as JSON."""
from __future__ import annotations

import argparse
import json
import os


def add_eval_flags(p: argparse.ArgumentParser, out: str):
    """``--device`` (the card unless asked) and ``--out``, the JSON file of
    the results (``out`` by default)."""
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out", default=out, help="where the results are written as JSON")


def write_results(results: dict, path: str) -> dict:
    """Write ``results`` to ``path`` as JSON (its directory made), print
    them, and return them."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    text = json.dumps(results, indent=2, default=float)
    with open(path, "w") as f:
        f.write(text)
    print(text)
    return results
