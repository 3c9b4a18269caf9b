"""External node packs + node-type metadata (port of the JAX package's
nodeflow/registry.py).

Counterpart of the reference's nodeflow/registry.py (entry-point group
loading :19-60, node-type metadata API :63-83, installable-pack index
:86-105).  A pack is any module exposing ``register()`` (or registering
runners at import time) published under the entry-point group
``super_rag_tpu_torch.nodeflow.packs``.
"""

from __future__ import annotations

import importlib
import importlib.metadata
import json
import logging
import os
from typing import Optional

from super_rag_tpu_torch.nodeflow.models import NODE_RUNNER_REGISTRY, node_type_catalog

logger = logging.getLogger(__name__)

ENTRY_POINT_GROUP = "super_rag_tpu_torch.nodeflow.packs"
_loaded_packs: list[str] = []


def load_packs() -> list[str]:
    """Import all registered node packs; returns the pack names loaded."""
    global _loaded_packs
    loaded = []
    try:
        eps = importlib.metadata.entry_points(group=ENTRY_POINT_GROUP)
    except TypeError:  # older importlib.metadata API
        eps = importlib.metadata.entry_points().get(ENTRY_POINT_GROUP, [])
    for ep in eps:
        try:
            mod = ep.load()
            if hasattr(mod, "register"):
                mod.register()
            loaded.append(ep.name)
        except Exception:  # noqa: BLE001 — a broken pack must not kill boot
            logger.exception("failed to load node pack %s", ep.name)
    _loaded_packs = loaded
    return loaded


def load_pack_module(module_path: str) -> bool:
    """Directly import a pack module by dotted path (config-driven)."""
    try:
        mod = importlib.import_module(module_path)
        if hasattr(mod, "register"):
            mod.register()
        _loaded_packs.append(module_path)
        return True
    except Exception:  # noqa: BLE001
        logger.exception("failed to load node pack %s", module_path)
        return False


def registry_index(index_path: Optional[str] = None) -> list[dict]:
    """Installable-pack index (reference nodeflow_registry/index.json)."""
    if index_path and os.path.exists(index_path):
        with open(index_path) as f:
            return json.load(f)
    return []


def registry_summary() -> dict:
    return {
        "node_types": node_type_catalog(),
        "loaded_packs": list(_loaded_packs),
        "registered_types": sorted(NODE_RUNNER_REGISTRY),
    }
