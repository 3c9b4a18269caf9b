"""Importing this package registers the ported node runners: those of the
built-in search flow, with its graph branch, and the llm answer node (the
fulltext_search runner waits with the workflow routes, ROADMAP A6f)."""

from super_rag_tpu_torch.nodeflow.runners import (  # noqa: F401
    start,
    vector_search,
    hybrid_search,
    graph_search,
    merge,
    rerank,
    llm,
)
