"""Importing this package registers every built-in node runner (port of
the JAX package's runners)."""

from super_rag_tpu_torch.nodeflow.runners import (  # noqa: F401
    start,
    vector_search,
    fulltext_search,
    hybrid_search,
    graph_search,
    merge,
    rerank,
    llm,
)
