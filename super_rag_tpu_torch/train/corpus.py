"""Offline training corpus: docstrings harvested from installed packages
(port of the JAX package's train/corpus.py).

A machine with no network egress and no text datasets still holds
English text: its installed packages' docstrings.  They are the
encoder's self-supervised training corpus (ICT pairs, ``train/pairs.py``).
Files are parsed with ``ast``, never imported, so the harvest is fast and
side-effect free, and names of packages (``DEFAULT_PACKAGES``) are only
directories to read.
"""

from __future__ import annotations

import ast
import hashlib
import os
import sysconfig
from typing import Iterator

DEFAULT_PACKAGES = (
    "numpy", "jax", "flax", "optax", "pandas", "torch", "transformers",
    "scipy", "sklearn", "PIL", "matplotlib", "sympy", "networkx", "nltk",
    "IPython", "tensorflow", "keras", "mpmath", "hypothesis", "seaborn",
    "sentence_transformers", "h5py", "pytest", "dateutil", "rich",
    # a wider harvest (a 27k-doc corpus overfits by 10k steps: final
    # in-batch accuracy 1.0); the next-largest packages commonly installed
    "google", "OpenGL", "tf_keras", "dm_control", "libcst", "orbax",
    "tensorboard", "peft", "datasets", "huggingface_hub", "pygments",
    "fontTools", "fiddle", "haiku", "pygame", "pettingzoo", "debugpy",
    "aqt", "statsmodels", "prompt_toolkit", "tokamax", "vertexai",
)


def _py_files(root: str, limit: int) -> Iterator[str]:
    count = 0
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
                count += 1
                if count >= limit:
                    return


def _docstrings(path: str, min_chars: int) -> Iterator[str]:
    try:
        with open(path, "r", encoding="utf-8", errors="ignore") as fh:
            tree = ast.parse(fh.read())
    except (SyntaxError, ValueError, OSError):
        return
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node)
            if doc and len(doc) >= min_chars:
                yield doc


def all_site_packages() -> tuple[str, ...]:
    """Every importable package directory under purelib: the widest
    harvest a machine supports (the curated list tops out near 42k docs,
    where the encoder's recall is still data-bound)."""
    site = sysconfig.get_paths()["purelib"]
    names = []
    for d in sorted(os.listdir(site)):
        if d.endswith((".dist-info", ".egg-info", ".pth", ".py", ".so")):
            continue
        if d.startswith("_") or d == "__pycache__":
            continue
        if os.path.isdir(os.path.join(site, d)):
            names.append(d)
    return tuple(names)


def harvest_docstrings(
    packages: tuple[str, ...] | None = DEFAULT_PACKAGES,
    min_chars: int = 240,
    max_files_per_pkg: int = 1_200,
    max_docs: int = 100_000,
) -> list[str]:
    """Deduped docstring paragraphs from installed packages.

    ``packages=None`` harvests every package in site-packages
    (:func:`all_site_packages`)."""
    if packages is None:
        packages = all_site_packages()
    site = sysconfig.get_paths()["purelib"]
    seen: set[str] = set()
    out: list[str] = []
    for pkg in packages:
        root = os.path.join(site, pkg)
        if not os.path.isdir(root):
            continue
        for path in _py_files(root, max_files_per_pkg):
            for doc in _docstrings(path, min_chars):
                text = " ".join(doc.split())
                # near-duplicate key, not exact: docstring boilerplate
                # ("Parameters ---------- ...") repeats across packages
                # with tiny edits; duplicates poison ICT eval distractors
                # and make mined "hard negatives" actually-positive
                norm = "".join(c for c in text.lower() if c.isalnum())
                h = hashlib.sha1(norm[:220].encode()).hexdigest()
                if h in seen:
                    continue
                seen.add(h)
                out.append(text)
                if len(out) >= max_docs:
                    return out
    return out
