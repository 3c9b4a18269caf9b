"""Importing this package registers the ported node runners: the four the
built-in search flow uses (the others wait with the workflow routes,
ROADMAP A6)."""

from super_rag_tpu_torch.nodeflow.runners import (  # noqa: F401
    start,
    vector_search,
    hybrid_search,
    rerank,
)
