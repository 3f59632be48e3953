"""Where the benchmark finds what a cell names: ``BENCHMARK.json`` at the
root of the checkout, and under ``portbench/`` one file per configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), request
loop (``loops/<name>.py``), metric reader (``metrics/<name>.py``) and
plain reference (``reference/<name>.py``).  A later cell, mix or metric is
a new file and a new entry; no file here needs an edit."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def path(root: str, kind: str, name: str, ext: str) -> str:
    return os.path.join(root, "portbench", kind, f"{name}{ext}")


def load_json(p: str) -> dict:
    with open(p) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def module(root: str, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` under ``root``, loaded by its path
    (a metric's name may hold dots), once per process."""
    p = path(root, kind, name, ".py")
    key = f"portbench._{kind}.{abs(hash(p)):x}.{name.replace('.', '_').replace('-', '_')}"
    mod = sys.modules.get(key)
    if mod is None:
        if not os.path.isfile(p):
            raise FileNotFoundError(f"no {kind} named {name!r}: {p}")
        spec = importlib.util.spec_from_file_location(key, p)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod
