"""Dataset registry over the repository's ``data/`` tree, counterpart of
``mpx/io/datasets.py``.

Categories benchmark/ (random walks), binary/ (.tsb), real/, synthetic/
and test/, catalogued in ``data/listings.json``.  Large random walks that
are not checked in are regenerated with :func:`generate_random_walk`.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from mpx_torch.io.tsb import read_series

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA_ROOT = os.path.join(_REPO_ROOT, "data")

CATEGORIES = ("benchmark", "binary", "real", "synthetic", "test")


def list_datasets(category: Optional[str] = None, data_root: Optional[str] = None):
    """Return {category: [file names]} of the available datasets."""
    root = data_root or DATA_ROOT
    out = {}
    for cat in (category,) if category else CATEGORIES:
        d = os.path.join(root, cat)
        if os.path.isdir(d):
            out[cat] = sorted(os.listdir(d))
    return out


def listings(data_root: Optional[str] = None):
    with open(os.path.join(data_root or DATA_ROOT, "listings.json")) as f:
        return json.load(f)


def dataset_path(name: str, category: Optional[str] = None,
                 data_root: Optional[str] = None) -> str:
    """Resolve a dataset name (optionally category-qualified, like
    'test/1024.txt') to a path."""
    root = data_root or DATA_ROOT
    if os.path.sep in name and os.path.exists(os.path.join(root, name)):
        return os.path.join(root, name)
    for cat in (category,) if category else CATEGORIES:
        p = os.path.join(root, cat, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"dataset {name!r} not found under {root}")


def load_dataset(name: str, category: Optional[str] = None,
                 data_root: Optional[str] = None) -> np.ndarray:
    return read_series(dataset_path(name, category, data_root))


def generate_random_walk(n: int, seed: int = 0) -> np.ndarray:
    """A benchmark-style random walk: the cumulative sum of ``n`` standard
    normal steps from ``seed``."""
    return np.cumsum(np.random.default_rng(seed).standard_normal(n))
