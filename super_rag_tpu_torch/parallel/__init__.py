"""Meshes over torch.distributed process groups and sharded search with
an all_gather top-k merge (port of the JAX package's parallel/)."""

from super_rag_tpu_torch.parallel.mesh import corpus_mesh, shard_corpus
from super_rag_tpu_torch.parallel.sharded import sharded_dense_search

__all__ = ["corpus_mesh", "shard_corpus", "sharded_dense_search"]
