"""The knowledge graph (port of the JAX package's kg/)."""
from super_rag_tpu_torch.kg.service import KnowledgeGraphService

__all__ = ["KnowledgeGraphService"]
