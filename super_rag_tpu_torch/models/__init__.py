from super_rag_tpu_torch.models.hash_embedder import HashEmbedder

__all__ = ["HashEmbedder"]
