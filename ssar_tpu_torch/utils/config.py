"""JSON config files for the entry points' argparse flags.

The port's copy of ``apply_config_file`` from ``ssar_tpu/utils/config.py``
(plain Python, kept here so that the port imports nothing of the JAX package).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def _flatten(d: dict) -> dict:
    """Sectioned config dicts {"train": {"lr": ...}} flatten to {dest: value};
    flat dicts pass through."""
    out: dict = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(v)
        else:
            out[k] = v
    return out


def apply_config_file(parser, args, path: str, argv=None):
    """Overlay a JSON config file onto parsed argparse args.

    Precedence: explicit CLI flag > config file > argparse default.  Accepts a
    flat {dest: value} dict or the sectioned format; unknown keys are
    reported, not fatal.
    """
    data = _flatten(json.loads(Path(path).read_text()))
    tokens = list(argv if argv is not None else sys.argv[1:])
    given = {t[2:].split("=")[0].replace("-", "_") for t in tokens if t.startswith("--")}
    for k, v in data.items():
        if k == "config":
            continue
        if not hasattr(args, k):
            print(f"config: ignoring unknown key {k!r}")
            continue
        if k in given:
            continue
        setattr(args, k, v)
    return args
